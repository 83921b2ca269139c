"""Gloo worlds on the CPU for the port's mesh tests: ``run_world`` starts
``n`` processes, each joins a gloo group (a ``file://`` rendezvous in a
fresh directory, no port to collide, a 60 s timeout so that a hang fails
the test) and runs one of the module's workers; what rank 0 returns comes
back to the caller.  Imports torch and the port only (the children start
without JAX)."""

import datetime
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_world(n, fn, *args, root=None):
    """``fn(*args)`` on every rank of a gloo world of ``n``; rank 0's
    result."""
    d = tempfile.mkdtemp(dir=root)
    try:
        mp.start_processes(_entry, args=(n, fn, d, args), nprocs=n,
                           start_method="spawn", join=True)
        return torch.load(os.path.join(d, "out_0.pt"), weights_only=False)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _entry(rank, n, fn, d, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(d, 'pg')}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=60))
    try:
        out = fn(*args)
        if rank == 0:
            torch.save(out, os.path.join(d, "out_0.pt"))
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh_for
    return make_mesh_for(shape[0] * shape[1], shape[1], "cpu")


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# Training on a mesh.
# ---------------------------------------------------------------------------

def train_jobs(jobs, seq, batch):
    """Each job (arch, mesh shape, checkpoint dir holding the step-0 state,
    TrainConfig options): 3 Trainer steps on that mesh from the checkpoint,
    in a copy of the dir.  Returns {(arch, shape, options): {"loss",
    "grad_norm", "aux"}}, and under
    "remesh" / "restore" the checks of the first job: remesh to (4, 1)
    and to None keeps every leaf; its final checkpoint restores on (4, 1)
    bit-equal (the dir under "ckpt")."""
    out = {}
    first = None
    for arch, shape, src, kw in jobs:
        tr, d = _trainer(arch, shape, src, seq, batch, 3, **kw)
        tr.run()
        out[(arch, shape, tuple(sorted(kw.items())))] = {
            k: [m[k] for m in tr.metrics_log]
            for k in ("loss", "grad_norm", "aux")}
        if first is None:
            first = (tr, d, arch)
    tr, d, arch = first
    out["regathered"] = tr.ctx.state["regathered"]
    before = [t.detach().clone() for t in tr.state_leaves()]
    same = []
    for mesh in (_mesh((4, 1)), None):
        tr.remesh(mesh)
        same.append(all(torch.equal(a, b)
                        for a, b in zip(before, tr.state_leaves())))
    out["remesh"] = same
    other, _ = _trainer(arch, (4, 1), d, seq, batch, 3, copy=False)
    other.restore()
    out["restore"] = all(torch.equal(a, b)
                         for a, b in zip(before, other.state_leaves()))
    out["ckpt"] = d
    out["leaves"] = [t.detach().numpy() for t in before]
    return out


def _trainer(arch, shape, src, seq, batch, steps, copy=True, **kw):
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.synthetic import for_model
    from repro_torch.train import TrainConfig, Trainer
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    d = src
    if copy:
        d = f"{src}_{shape[0]}x{shape[1]}" + "".join(
            f"_{k}{v}" for k, v in sorted(kw.items()))
        if dist.get_rank() == 0:
            shutil.copytree(src, d)
        dist.barrier()
    tr = Trainer(cfg, ShapeSpec("mesh", seq, batch, "train"),
                 for_model(cfg, seq, batch),
                 TrainConfig(total_steps=steps, ckpt_dir=d, lr=1e-3, **kw),
                 mesh=_mesh(shape), device="cpu")
    return tr, d


def many(jobs):
    """Several workers in one world: [(worker name, args)] -> results."""
    return [globals()[name](*args) for name, args in jobs]


# ---------------------------------------------------------------------------
# Collectives, the quantized all-reduce and the MoE placements.
# ---------------------------------------------------------------------------

def compress_job(grads_by_rank, rounds):
    """``quantized_allreduce`` over (4, 1)'s data axis of each rank's own
    gradients, and ``rounds`` rounds of ``ErrorFeedback``."""
    from repro_torch.parallel.compress import (ErrorFeedback,
                                               quantized_allreduce)
    r = dist.get_rank()
    mesh = _mesh((4, 1))
    grads = {k: torch.from_numpy(v) for k, v in grads_by_rank[r].items()}
    summed = quantized_allreduce(grads, mesh, "data")
    ef, fed = ErrorFeedback(), []
    for i in range(rounds):
        fed.append({k: _np(v) for k, v in ef.apply(
            {k: g * (i + 1) for k, g in grads.items()}).items()})
    return {"summed": {k: _np(v) for k, v in summed.items()}, "fed": fed}


def moe_job(params, x, r, shape, impl, coef):
    """``moe_ffn`` of the phi3.5-moe smoke layer on a mesh: y, aux and the
    gradients of ``sum(y * r) + coef * aux`` (the parameters' whole
    gradients, the batch's)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoE, moe_ffn
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as rules
    from repro_torch.parallel.mesh_ctx import make_ctx
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b", smoke=True),
                              dtype="float32")
    mesh = _mesh(shape)
    ctx = make_ctx(mesh)
    if impl == "global":
        ctx = dataclasses.replace(ctx, use_shard_map_moe=False)
    else:
        ctx = dataclasses.replace(ctx, moe_impl=impl)
    gen = torch.Generator().manual_seed(0)
    p = MoE(cfg, gen, device="cpu")
    pcfg = rules.make_parallel_cfg(mesh)
    specs = {}
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(params[name]))
            specs[name] = rules._rule(name, (cfg.n_layers,) + tuple(t.shape),
                                      pcfg)[1:]
            t.data = coll.local_slice(t.data, specs[name], ctx).clone()
            t._spec = specs[name]
    n, i = ctx.dp_size, coll.group_rank(ctx.group(ctx.dp))
    rows = x.shape[0] // n
    xl = torch.from_numpy(x[i * rows:(i + 1) * rows]).requires_grad_()
    rl = torch.from_numpy(r[i * rows:(i + 1) * rows])
    y, aux = moe_ffn(p, xl, cfg, ctx)
    ((y * rl).sum() + coef * aux).backward()
    grads = {name: t.grad for name, t in p.named_parameters()}
    coll.reduce_replicated_grads(ctx, grads, specs)
    gx = [torch.empty_like(xl.grad) for _ in range(n)]
    ys = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(gx, xl.grad.contiguous(), group=ctx.group(ctx.dp))
    dist.all_gather(ys, y.detach().contiguous(), group=ctx.group(ctx.dp))
    return {"y": _np(torch.cat(ys)), "aux": float(aux),
            "grads": {k: _np(coll.gather_whole(g, specs[k], ctx))
                      for k, g in grads.items()},
            "x": _np(torch.cat(gx))}


def pairs_job(seed):
    """Each collective pair inside a small computation on (2, 2), against
    autograd of the same computation on the whole tensors: {pair: the
    largest distance of a gradient over every rank}."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.mesh_ctx import make_ctx
    ctx = make_ctx(_mesh((2, 2)))
    dg, tg = ctx.group("data"), ctx.group("model")
    d, m = ctx.coord("data"), ctx.coord("model")
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    out = {}

    def whole_grad(f, *ts):
        ts = [t.clone().requires_grad_() for t in ts]
        f(*ts).sum().backward()
        return [_np(t.grad) for t in ts]

    def share(t, group):
        xs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(xs, t.contiguous(), group=group)
        return torch.stack(xs)

    # FSDP: w's rows split over data, gathered; each data rank's loss is
    # its rows of a; the whole gradient is the sum over data ranks
    wl = w[d * 3:(d + 1) * 3].clone().requires_grad_()
    al = a[d * 2:(d + 1) * 2]
    (al @ coll.gather(wl, 0, dg, "sum")).square().sum().backward()
    got = share(wl.grad, dg).reshape(6, 8)
    out["gather_sum"] = (_np(got), whole_grad(
        lambda w_: (a @ w_).square(), w)[0])
    # TP: column-parallel w (columns split over model) behind copy_to,
    # the partial outputs of a row-parallel product summed by reduce_from
    v = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    al = a.clone().requires_grad_()
    wc = w[:, m * 4:(m + 1) * 4].clone().requires_grad_()
    vr = v[m * 4:(m + 1) * 4].clone().requires_grad_()
    y = coll.reduce_from(torch.tanh(coll.copy_to(al, tg) @ wc) @ vr, tg)
    y.square().sum().backward()
    want = whole_grad(lambda a_, w_, v_: (torch.tanh(a_ @ w_) @ v_).square(),
                      a, w, v)
    out["copy_reduce"] = (
        [_np(al.grad), _np(torch.cat(list(share(wc.grad, tg)), dim=1)),
         _np(torch.cat(list(share(vr.grad, tg)), dim=0))], want)
    # a replicated tensor split for a slice-parallel product, the norm of
    # the split dim summed over model, the result gathered (slice grad)
    al = a.clone().requires_grad_()
    s = coll.split(al, 1, tg)
    norm = coll.reduce_shared(s.square().sum(-1, keepdim=True), tg)
    yl = s / torch.sqrt(norm)
    y = coll.gather(yl, 1, tg, "slice")
    (y.square() * torch.arange(6.0)).sum().backward()
    out["split_shared"] = (_np(al.grad), whole_grad(
        lambda a_: (a_ / a_.square().sum(-1, keepdim=True).sqrt()).square()
        * torch.arange(6.0), a)[0])
    # all-to-all both ways: rank j's chunk i to rank i, and back
    n = dist.get_world_size()
    al = a.repeat(n, 1)[:, :4].clone().requires_grad_()
    r = dist.get_rank()
    y = coll.all_to_all(coll.all_to_all(al * (r + 1), dist.group.WORLD)
                        * 2.0, dist.group.WORLD)
    y.sum().backward()
    out["all_to_all"] = (_np(al.grad), [np.full(al.shape, 2.0 * (r + 1),
                                                np.float32)])
    # each pair's largest distance from the whole computation, over ranks
    names = sorted(out)
    errs = torch.tensor([max(float(np.abs(g - w).max()) for g, w in zip(
        *(x if isinstance(x, list) else [x] for x in out[k])))
        for k in names], dtype=torch.float64)
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    return dict(zip(names, errs.tolist()))


# ---------------------------------------------------------------------------
# Serving on a mesh.
# ---------------------------------------------------------------------------

def serve_jobs(jobs, params_by_arch, tokens, max_len, steps, frames):
    """Each job (arch, mesh shape, kv_mode[, "sp" or "sp_prenorm": the
    context's sequence parallelism]): the float32 smoke model with
    the JAX parameters ``params_by_arch[arch]``, placed on the mesh
    (``place_model``); ``make_prefill_step`` on this rank's rows of
    ``tokens`` (B, S) (and, for the encoder-decoder, of the audio
    ``frames`` (B, enc_seq, frontend dim)), then ``steps``
    ``make_serve_step``s fed their own tokens, with ``prefill`` /
    ``decode_step`` beside each for the logits; then ``Engine(ctx=...)``
    on the same prompts, where the engine reads what the steps read (its
    audio frontend is a stub of zero frames, so not for the
    encoder-decoder).  Returns {job: {"logits": [(B, vocab) a step, every
    row], "tokens": [(B, 1) a step], "caches": [(each rank's mesh
    coordinates, its cache as numpy) in rank order], "engine": {rid:
    tokens} or None}}."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_jax
    from repro_torch.launch import steps as S
    from repro_torch.models import Transformer, decode_step, prefill
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.mesh_ctx import make_ctx
    from repro_torch.parallel.sharding import map_leaves
    from repro_torch.serving import Engine, Request, ServeConfig
    out = {}
    for job in jobs:
        arch, shape, kv_mode = job[:3]
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        sp = job[3] if len(job) > 3 else None
        ctx = make_ctx(_mesh(shape), kv_mode=kv_mode,
                       sequence_parallel=sp is not None,
                       sp_prenorm=sp == "sp_prenorm")
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(model_params_from_jax(params_by_arch[arch],
                                                    cfg))
        coll.place_model(model, cfg, ctx)
        dg = ctx.group(ctx.dp)
        whole = {"tokens": torch.from_numpy(tokens)}
        if cfg.family == "encdec":
            whole["enc_frames"] = torch.from_numpy(frames)
        batch = S.local_batch(whole, ctx)
        logits, cache = prefill(model, batch, cfg, max_len=max_len, ctx=ctx)
        tok, cache2 = S.make_prefill_step(cfg, ctx, max_len)(model, batch)
        same = all(torch.equal(a, b) for a, b in zip(
            _leaves(cache), _leaves(cache2)))
        lg, tk = [logits], [tok]
        pos = tokens.shape[1]
        serve = S.make_serve_step(cfg, ctx)
        for i in range(steps):
            lgi, _ = decode_step(model, tok, map_leaves(torch.clone, cache),
                                 pos + i, cfg, ctx=ctx)
            tok, cache = serve(model, tok, cache, pos + i)
            lg.append(lgi)
            tk.append(tok)
        coords = {a: ctx.coord(a) for a in ctx.mesh.mesh_dim_names}
        shards = [None] * dist.get_world_size()
        dist.all_gather_object(shards, (coords, map_leaves(_np, cache)))
        engine = None
        if cfg.family != "encdec":
            eng = Engine(cfg, model, ServeConfig(max_batch=tokens.shape[0],
                                                 max_len=max_len),
                         device="cpu", ctx=ctx)
            for rid, row in enumerate(tokens):
                eng.submit(Request(rid, row, max_new=steps + 1))
            engine = {k: v.tolist() for k, v in eng.run().items()}
        out[tuple(job)] = {
            "logits": [_np(coll.gathered(t, 0, dg)) for t in lg],
            "tokens": [_np(coll.gathered(t, 0, dg)) for t in tk],
            "step_cache_equal": same, "caches": shards, "engine": engine}
    return out


def _leaves(tree):
    from repro_torch.parallel.sharding import map_leaves
    out = []
    map_leaves(out.append, tree)
    return out
