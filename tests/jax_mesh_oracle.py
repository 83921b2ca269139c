"""The JAX package on 4 forced host devices: the oracle of the port's mesh
tests, run in a subprocess (the test process has started JAX with one
device).  ``python tests/jax_mesh_oracle.py <request.pkl> <answer.pkl>``:
the request is a dict of jobs, the answer a dict of numpy results.

Jobs:
  * ``train``: [(arch, (dp, tp), step-0 checkpoint dir, TrainConfig
    options)], seq, batch, lr: the reference ``Trainer`` on that mesh, 3
    steps from a copy of the checkpoint (float32 smoke configs): losses,
    grad norms, aux; the options ``sequence_parallel`` and ``sp_prenorm``
    (the port's, which the reference's ``TrainConfig`` lacks) go to the
    ``MeshCtx`` the Trainer builds;
  * ``moe``: the phi3.5-moe smoke layer's params, x, r, coef and
    [(dp, tp), impl]: ``moe_ffn`` on the mesh, y, aux and the gradients of
    ``sum(y * r) + coef * aux``;
  * ``compress``: per-rank gradients: ``_ar_body`` with each device on its
    own gradient (the public ``quantized_allreduce`` replicates its
    input), the public call on rank 0's gradients, and ``ErrorFeedback``;
  * ``serve``: [(arch, (dp, tp), kv_mode)], the parameters by arch (numpy
    trees), the prompt tokens (B, S), max_len, the decode steps and the
    encoder-decoder's audio frames (B, enc_seq, frontend dim): the
    reference's ``make_prefill_step`` and ``make_serve_step`` on that
    mesh, jitted with ``shardings_for``'s shardings (the cache's by
    ``kv_mode``), each beside ``prefill`` / ``decode_step`` for the
    logits: every step's logits and tokens, and the final cache (whole);
    a job's optional fourth entry "sp" or "sp_prenorm" sets
    ``sequence_parallel`` (and ``sp_prenorm``) on the ``MeshCtx``.
"""

import os
import sys

# one thread a device: the suite runs this beside other test workers
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import pickle  # noqa: E402
import shutil  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _cfg(arch):
    from repro.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


_SP_KEYS = ("sequence_parallel", "sp_prenorm")


def _sp_fields(flag):
    """The MeshCtx fields of a serve job's fourth entry."""
    return {"sp": {"sequence_parallel": True},
            "sp_prenorm": {"sequence_parallel": True,
                           "sp_prenorm": True}}.get(flag, {})


def train(jobs, seq, batch, lr):
    from repro.configs import ShapeSpec
    from repro.data.synthetic import for_model
    from repro.launch.mesh import make_mesh_for
    from repro.train import TrainConfig, Trainer
    from repro.train import loop
    make_ctx = loop.make_ctx
    out = {}
    for arch, shape, src, kw in jobs:
        cfg = _cfg(arch)
        d = f"{src}_jax_{shape[0]}x{shape[1]}" + "".join(
            f"_{k}{v}" for k, v in sorted(kw.items()))
        shutil.copytree(src, d)
        sp = {k: v for k, v in kw.items() if k in _SP_KEYS}
        opts = {k: v for k, v in kw.items() if k not in _SP_KEYS}
        loop.make_ctx = lambda mesh: dataclasses.replace(make_ctx(mesh),
                                                         **sp)
        try:
            tr = Trainer(cfg, ShapeSpec("mesh", seq, batch, "train"),
                         for_model(cfg, seq, batch),
                         TrainConfig(total_steps=3, ckpt_dir=d, lr=lr,
                                     **opts),
                         mesh=make_mesh_for(4, shape[1]))
            tr.run()
        finally:
            loop.make_ctx = make_ctx
        out[(arch, tuple(shape), tuple(sorted(kw.items())))] = {
            k: [m[k] for m in tr.metrics_log]
            for k in ("loss", "grad_norm", "aux")}
    return out


def moe(params, x, r, coef, runs):
    from repro.launch.mesh import make_mesh_for
    from repro.models import moe as M
    from repro.parallel.mesh_ctx import make_ctx
    cfg = _cfg("phi3.5-moe-42b")
    p = {k: jnp.asarray(v) for k, v in params.items()}
    x, r = jnp.asarray(x), jnp.asarray(r)
    out = {}
    for shape, impl in runs:
        ctx = make_ctx(make_mesh_for(4, shape[1]))
        ctx = dataclasses.replace(ctx, use_shard_map_moe=False) \
            if impl == "global" else dataclasses.replace(ctx, moe_impl=impl)

        def f(p, x):
            y, aux = M.moe_ffn(p, x, cfg, ctx)
            return jnp.sum(y * r) + coef * aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, x)
        out[(tuple(shape), impl)] = {
            "y": np.asarray(y), "aux": float(aux), "x": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()}}
    return out


def compress(grads_by_rank, rounds):
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_mesh_for
    from repro.parallel import compress as Q
    mesh = make_mesh_for(4, 1)
    names = list(grads_by_rank[0])
    flats = [np.concatenate([g[k].reshape(-1) for k in names])
             for g in grads_by_rank]
    size = flats[0].shape[0]
    pad = (-size) % 4
    stacked = np.concatenate([np.pad(f, (0, pad)) for f in flats])
    each = jax.shard_map(partial(Q._ar_body, axis_name="data", n=4),
                         mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                         check_vma=False)(jnp.asarray(stacked))
    each = np.asarray(each).reshape(4, -1)[:, :size]
    summed, off = {}, 0
    for k in names:
        n = grads_by_rank[0][k].size
        summed[k] = each[0, off:off + n].reshape(grads_by_rank[0][k].shape)
        off += n
    g0 = {k: jnp.asarray(v) for k, v in grads_by_rank[0].items()}
    public = Q.quantized_allreduce(g0, mesh, "data")
    ef, fed = Q.ErrorFeedback(), []
    for i in range(rounds):
        fed.append({k: np.asarray(v) for k, v in ef.apply(
            {k: g * (i + 1) for k, g in g0.items()}).items()})
    return {"summed": summed, "ranks_agree": bool(
        all(np.array_equal(each[0], e) for e in each)),
        "public": {k: np.asarray(v) for k, v in public.items()},
        "fed": fed}


def serve(jobs, params_by_arch, tokens, max_len, steps, frames):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import ShapeSpec
    from repro.launch import steps as S
    from repro.launch.mesh import make_mesh_for
    from repro.models import decode_step, prefill
    from repro.parallel import sharding as rules
    from repro.parallel.mesh_ctx import make_ctx
    B, L = tokens.shape
    out = {}
    for job in jobs:
        arch, shape, kv_mode = job[:3]
        cfg = _cfg(arch)
        mesh = make_mesh_for(4, shape[1])
        ctx = dataclasses.replace(make_ctx(mesh), **_sp_fields(
            job[3] if len(job) > 3 else None))
        pcfg = rules.make_parallel_cfg(mesh, kv_mode=kv_mode)
        (p_sh, b_sh), (tok_sh, kv_sh) = S.shardings_for(
            cfg, ShapeSpec("serve", max_len, B, "prefill"), mesh, pcfg)
        (_, _, c_sh, pos_sh), _ = S.shardings_for(
            cfg, ShapeSpec("serve", max_len, B, "decode"), mesh, pcfg)
        lg_sh = NamedSharding(mesh, P(tok_sh.spec[0], None))
        pre_step = S.make_prefill_step(cfg, ctx, max_len)
        dec_step = S.make_serve_step(cfg, ctx)
        pre = jax.jit(lambda p, b: (pre_step(p, b), prefill(
            p, b, cfg, ctx, max_len=max_len)[0]), in_shardings=(p_sh, b_sh),
            out_shardings=((tok_sh, kv_sh), lg_sh))
        dec = jax.jit(lambda p, t, c, pos: (dec_step(p, t, c, pos),
                                            decode_step(p, t, c, pos, cfg,
                                                        ctx)[0]),
                      in_shardings=(p_sh, tok_sh, c_sh, pos_sh),
                      out_shardings=((tok_sh, c_sh), lg_sh))
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                              params_by_arch[arch])
        batch = {"tokens": jnp.asarray(tokens)}
        if cfg.family == "encdec":
            batch["enc_frames"] = jnp.asarray(frames)
        (tok, cache), lg = pre(params, batch)
        lgs, toks = [np.asarray(lg)], [np.asarray(tok)]
        for i in range(steps):
            (tok, cache), lg = dec(params, tok, cache, jnp.int32(L + i))
            lgs.append(np.asarray(lg))
            toks.append(np.asarray(tok))
        out[(arch, tuple(shape)) + tuple(job[2:])] = {
            "logits": lgs, "tokens": toks,
            "cache": jax.tree.map(np.asarray, cache)}
    return out


def main(req_path, out_path):
    with open(req_path, "rb") as f:
        req = pickle.load(f)
    ans = {}
    if "train" in req:
        ans["train"] = train(*req["train"])
    if "moe" in req:
        ans["moe"] = moe(*req["moe"])
    if "compress" in req:
        ans["compress"] = compress(*req["compress"])
    if "serve" in req:
        ans["serve"] = serve(*req["serve"])
    with open(out_path, "wb") as f:
        pickle.dump(ans, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
