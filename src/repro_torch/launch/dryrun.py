"""Multi-pod dry run on one host (the port of the JAX package's
``launch/dryrun.py``).

For one (arch x shape x mesh) cell it runs ONE rank's step (rank 0 unless
``--rank``) in this process, over:
  * a ``"fake"`` process group of 256 or 512 ranks (``torch.testing.
    _internal.distributed.fake_pg``: every collective returns at once and
    moves nothing);
  * the production mesh (``launch.mesh.make_production_mesh``, 16 x 16 or
    2 x 16 x 16) on the CPU;
  * a model whose parameters are fake CPU tensors of this rank's shard
    shapes (``FakeTensorMode``: shapes and types, no storage), and inputs
    likewise (``launch.steps.local_inputs``);
  * the cell's step: ``make_train_step`` (``remat`` on unless
    ``--no-remat``; the global batch, which it splits), ``make_prefill_step``
    or ``make_serve_step`` (at the cache's last position, so every cached
    position is read).
Nothing is allocated and no kernel runs: every op is traced on fake
tensors, the attention and SSD wrappers through their plain versions
(the tensors lie on the CPU).  This is a host tool, as the reference's
is (it lowers on forced host devices); it never reaches for CUDA and is
no fallback of the card's path.

What it records, per rank, under the reference's JSON keys (so that one
reader takes either file; ``hlo_chars`` is left out, ``compile_s`` is
the fake run's wall):
  * ``per_device_bytes``: ``arguments``, the bytes of this rank's shard of
    every input (from the shard shapes); ``outputs``, likewise of the
    step's outputs; ``aliased``, the donated inputs (params and optimizer
    state for train, the cache for decode, as the reference's
    ``donate_argnums``); ``temps``, the peak of the fake storage the step
    allocates and frees (its outputs left out) -- the port's own figure,
    not XLA's buffer assignment, and with the plain attention's whole
    score blocks in it, as the reference's XLA path holds its chunks;
    ``total_live`` = arguments + outputs + temps - aliased;
  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``;
  * ``bytes``: the bytes of every aten op's tensor inputs and outputs
    (views left out), the closest counterpart of XLA's "bytes accessed"
    (which likewise counts each op's operands and results);
  * ``attn_score_bytes``: the result bytes of ops whose trailing two dims
    are an attention score block's (``_score_dims``);
  * ``collective_bytes`` / ``collective_counts``: the result bytes (what
    each rank receives or reduces, as the reference's
    ``parse_collective_bytes`` measures them) and the number of every c10d
    op, under the reference's five kinds: ``_allgather_base_`` ->
    all-gather, ``allreduce_`` -> all-reduce, ``_reduce_scatter_base_`` ->
    reduce-scatter, ``alltoall_base_`` -> all-to-all; collective-permute
    stays 0.
  * ``savepoints``: with remat (train), the bytes of each layer input the
    forward keeps for the backward (``ctx.state["savepoints"]``): their
    number, the largest (``per_layer``) and their sum.
The collectives are the port's explicit ones (FSDP gathers and
reduce-scatters, the Megatron pairs and their sequence-parallel forms, the
MoE placements, a decode cache split by head dim summing its partial
scores), not those GSPMD chooses for the reference, so they are compared
with the reference's and recorded, not held equal.

Knobs, as the reference's ``lower_cell``: ``sequence_parallel`` (on by
default for train and prefill, never for decode; a sequence the model
axis does not divide runs without it; ``--no-sp``), ``sp_prenorm``,
``pure_fsdp`` (data over every mesh axis, no tensor parallelism, SP off).
The reference's ``sp_barrier``, ``grad_barrier`` and ``grad_shard`` pin
choices XLA could otherwise make, which the port's explicit collectives
already make: the sequence collectives move the residual in its own type
(``sp_barrier``), the gradients are reduced in the parameters' type
(``grad_barrier``), and each sharded weight's gradient is
reduce-scattered into its shard by its gather's backward
(``grad_shard``).  ``lower_cell`` takes them as keywords, lists those set
under ``"ignored"``, and changes nothing.  Each result's
``"sequence_parallel"`` says whether the step ran with it.

``--probe``: the reference counts a scanned layer once and extrapolates
from compiles at 2 and 3 layer units per stack dim; the port runs every
layer eagerly, so its deploy counts are already whole, and ``--probe``
computes the same extrapolation from fake runs at 2 and 3 units (remat
off, as the reference's probe), which equals the deploy counts where
remat is off (serving).

Usage:
    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k \\
        [--multi-pod] [--probe] [--rank R] [--json out.json] [--no-sp]
        [--sp-prenorm] [--pure-fsdp]
        [--grad-shard]
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--probe]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time
import weakref
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# the c10d ops the port's collectives dispatch to, by the reference's kind
_C10D_KINDS = {"_allgather_base_": "all-gather", "allreduce_": "all-reduce",
               "_reduce_scatter_base_": "reduce-scatter",
               "alltoall_base_": "all-to-all"}


def _score_dims(cfg, shape):
    """Trailing dims of the port's attention-score tensors: the plain
    versions' whole (S, T) blocks (the reference's probe compiles chunk
    them in halves), and in decode the paged version's (G, T) logits of
    each KV head's G query heads."""
    dims = set()
    if shape.kind in ("train", "prefill"):
        S = shape.seq_len
        dims.add((S, S))
        if cfg.family == "vlm":
            dims.add((cfg.n_patches, cfg.n_patches))
        if cfg.family == "encdec":
            e = cfg.enc_seq
            dims.add((e, e))
            dims.add((S, e))
    else:
        if cfg.n_kv_heads:
            dims.add((cfg.n_heads // cfg.n_kv_heads, shape.seq_len))
        if cfg.family == "encdec":
            dims.add((1, cfg.enc_seq))
    return tuple(sorted(dims))


def _probe_dims(cfg):
    """(field, unit_count, unit_size) per independently-scaled stack dim."""
    dims = []
    if cfg.family == "hybrid":
        dims.append(("n_layers", cfg.n_layers // cfg.attn_every,
                     cfg.attn_every))
    else:
        dims.append(("n_layers", cfg.n_layers, 1))
    if cfg.family == "encdec":
        dims.append(("n_enc_layers", cfg.n_enc_layers, 1))
    if cfg.family == "vlm":
        dims.append(("n_vision_layers", cfg.n_vision_layers, 1))
    return dims


def _with_units(cfg, units):
    kw = {}
    for (field, _, unit), u in zip(_probe_dims(cfg), units):
        kw[field] = unit * u
    return dataclasses.replace(cfg, **kw)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts what the ops of a step do: the bytes every aten op reads and
    writes (views left out, and ops outside ``aten``, such as ``prim``'s
    metadata queries), the result bytes of attention-score-shaped tensors
    (``score_dims``), each c10d op by kind (count and result bytes: the
    tensors of its first argument, its output), and the fake storage the
    step allocates, as events for :meth:`temps`."""

    def __init__(self, score_dims=()):
        super().__init__()
        self.score_dims = {tuple(d) for d in score_dims}
        self.bytes = 0
        self.attn_score_bytes = 0
        self.collective_bytes = {k: 0 for k in _COLLECTIVES}
        self.collective_counts = {k: 0 for k in _COLLECTIVES}
        self.events = []            # (storage key, +bytes / -bytes)
        self._live = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "c10d":
            name = func._schema.name.split("::")[-1]
            kind = _C10D_KINDS.get(name)
            if kind is None:
                raise ValueError(f"the dry run has no kind for c10d op "
                                 f"{name}")
            self.collective_counts[kind] += 1
            self.collective_bytes[kind] += sum(
                _nbytes(t) for t in _tensors(args[0]))
            return out
        outs = list(_tensors(out))
        if ns == "aten" and not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            if t.dim() >= 3 and tuple(t.shape[-2:]) in self.score_dims:
                self.attn_score_bytes += _nbytes(t)
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live.add(key)
        self.events.append((key, st.nbytes()))
        weakref.finalize(st, self._free, key, st.nbytes())

    def _free(self, key, n) -> None:
        if key in self._live:
            self._live.discard(key)
            self.events.append((key, -n))

    def temps(self, keep=()) -> int:
        """The peak of the storage allocated during the step and live at
        once, storages ``keep`` (the step's outputs) left out."""
        keep = set(keep)
        live = peak = 0
        for key, n in self.events:
            if key not in keep:
                live += n
                peak = max(peak, live)
        return peak


def _storage_keys(tree):
    return {t.untyped_storage()._cdata for t in _tensors(tree)}


def _fake_world(n: int, rank: int) -> None:
    """The default group: a fake one of ``n`` ranks, this process rank
    ``rank`` (a fake group of another size or rank is replaced; a real
    one is an error)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs the default process "
                               "group for its fake one; one is initialized")
        if dist.get_world_size() == n and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def _mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]], rank: int):
    from torch.distributed.device_mesh import init_device_mesh

    from .mesh import make_production_mesh
    if mesh_shape is None:
        _fake_world(512 if multi_pod else 256, rank)
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}[
        len(mesh_shape)]
    _fake_world(math.prod(mesh_shape), rank)
    return init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=names)


def _fake_model(cfg, specs, sizes, train: bool):
    """The model with fake parameters of this rank's shard shapes, each
    with its ``_spec`` and ``_whole`` (call inside ``FakeTensorMode``)."""
    from torch import nn

    from ..models import Transformer
    from ..parallel.sharding import shard_shape
    model = Transformer(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        q = nn.Parameter(torch.empty(shard_shape(p.shape, specs[name], sizes),
                                     dtype=p.dtype, device="cpu"),
                         requires_grad=train)
        q._spec, q._whole = specs[name], p
        mod._parameters[leaf] = q
    return model


def _fake_like(tree):
    from ..parallel.sharding import map_leaves
    return map_leaves(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                            device="cpu"), tree)


def run_cell(cfg, shape, mesh, ctx, pcfg) -> Dict[str, object]:
    """One rank's step of the cell on fake tensors: per_device_bytes (and
    each input's bytes), flops, bytes, attn_score_bytes and the
    collectives."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..optim import adamw
    from ..parallel.sharding import axis_sizes, param_pspecs
    from . import steps as S

    sizes = axis_sizes(mesh)
    local = S.local_inputs(cfg, shape, mesh, pcfg)
    in_bytes = {k: S.tree_bytes(v) for k, v in local.items()}
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        named = dict(S.Transformer(cfg, device="meta").named_parameters())
        specs = param_pspecs(named, pcfg, cfg)
        train = shape.kind == "train"
        model = _fake_model(cfg, specs, sizes, train)
        if train:
            opt_state = adamw.init(dict(model.named_parameters()))
            step = S.make_train_step(cfg, remat=ctx.remat, ctx=ctx,
                                     specs=specs)
            args = (model, opt_state,
                    _fake_like(S.batch_specs(cfg, shape, True)))
            aliased = in_bytes["params"] + in_bytes["opt_state"]
        elif shape.kind == "prefill":
            step = S.make_prefill_step(cfg, ctx)
            args = (model, _fake_like(local["batch"]))
            aliased = 0
        else:
            step = S.make_serve_step(cfg, ctx)
            args = (model, _fake_like(local["tokens"]),
                    _fake_like(local["cache"]), shape.seq_len - 1)
            aliased = in_bytes["cache"]
        cost = CostMode(_score_dims(cfg, shape))
        flops = FlopCounterMode(display=False)
        # storage is freed by reference counts alone during the step, so
        # ``temps`` does not hang on when the cycle collector runs
        gc.collect()
        gc.disable()
        try:
            with flops, cost:
                out = step(*args)
        finally:
            gc.enable()
        if train:
            out = (dict(out[0].named_parameters()), out[1], out[2])
        wall = time.perf_counter() - t0
        outputs = sum(_nbytes(t) for t in _tensors(out))
        temps = cost.temps(_storage_keys(out))
    arguments = sum(in_bytes.values())
    saved = list(ctx.state["savepoints"]) if train and ctx.remat else []
    return {
        "compile_s": round(wall, 1),
        "per_device_bytes": {
            "arguments": arguments, "outputs": outputs, "temps": temps,
            "aliased": aliased,
            "total_live": arguments + outputs + temps - aliased},
        "input_bytes": in_bytes,
        "flops": float(flops.get_total_flops()),
        "bytes": float(cost.bytes),
        "attn_score_bytes": float(cost.attn_score_bytes),
        "collective_bytes": {k: float(v)
                             for k, v in cost.collective_bytes.items()},
        "collective_counts": dict(cost.collective_counts),
        "savepoints": {"count": len(saved),
                       "per_layer": max(saved, default=0),
                       "total": sum(saved)},
    }


# the reference's pins of XLA's choices, which the port's collectives make
XLA_PINS = ("sp_barrier", "grad_barrier", "grad_shard")


def lower_cell(arch: Union[str, object], shape_name: Union[str, object],
               multi_pod: bool,
               probe: bool = False, verbose: bool = True,
               kv_mode: str = "auto", remat: bool = True,
               moe_shard_map: bool = True, sequence_parallel: bool = True,
               moe_impl: str = "tp", rank: int = 0,
               mesh_shape: Optional[Tuple[int, ...]] = None,
               sp_prenorm: bool = False, pure_fsdp: bool = False,
               **xla_pins: bool):
    """The dry run of one cell on rank ``rank``.  ``arch``: a registered
    id, or a ``ModelConfig`` (another type than the published one);
    ``shape_name``: a name in ``SHAPES`` or a ``ShapeSpec``;
    ``mesh_shape``: another (data, model) or (pod, data, model) mesh than
    the production one (the port's checks on a few cards).  The knobs are
    the reference's (module docstring); ``xla_pins``: any of XLA_PINS,
    recorded and ignored."""
    from ..configs import SHAPES, cell_is_valid, get_config
    from ..parallel import sharding as shard_rules
    from ..parallel.mesh_ctx import MeshCtx

    unknown = set(xla_pins) - set(XLA_PINS)
    if unknown:
        raise TypeError(f"lower_cell: unknown knobs {sorted(unknown)}")
    if isinstance(arch, str):
        cfg = get_config(arch)
    else:
        cfg, arch = arch.validate(), arch.name
    shape = SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    ok, why = cell_is_valid(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "skipped": why,
                "sequence_parallel": False}

    mesh = _mesh(multi_pod, mesh_shape, rank)
    names = tuple(mesh.mesh_dim_names)
    pcfg = shard_rules.make_parallel_cfg(mesh, kv_mode=kv_mode,
                                         pure_fsdp=pure_fsdp)
    dp_axes = tuple(a for a in names if a != "model")
    if pure_fsdp:
        dp_axes, sequence_parallel = names, False
    ctx = MeshCtx(mesh=mesh, dp=dp_axes, tp="model", pure_dp=pure_fsdp,
                  remat=remat and shape.kind == "train",
                  use_shard_map_moe=moe_shard_map, moe_impl=moe_impl,
                  kv_mode=kv_mode, sp_prenorm=sp_prenorm,
                  sequence_parallel=(sequence_parallel
                                     and shape.kind != "decode"))
    sp_ran = (ctx.sequence_parallel and ctx.tp_size > 1
              and shape.seq_len % ctx.tp_size == 0)
    result = {
        "arch": arch, "shape": shape.name,
        "mesh": dict(zip(names, (int(s) for s in mesh.shape))),
        "n_devices": int(mesh.size()), "rank": rank,
        "kind": shape.kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "sequence_parallel": bool(sp_ran),
        "knobs": {"sp_prenorm": sp_prenorm, "pure_fsdp": pure_fsdp},
        "ignored": sorted(k for k, on in xla_pins.items() if on),
    }
    result["deploy"] = run_cell(cfg, shape, mesh, ctx, pcfg)
    if verbose:
        d = result["deploy"]
        pod = "x".join(str(s) for s in mesh.shape)
        print(f"[{arch} x {shape.name} x {pod}] fake run in "
              f"{d['compile_s']}s; live/device = "
              f"{d['per_device_bytes']['total_live'] / 2**30:.2f} GiB",
              flush=True)

    if probe:
        dims = _probe_dims(cfg)
        ctx_p = dataclasses.replace(ctx, remat=False)
        base_units = [min(2, count) for (_, count, _) in dims]
        runs = {}

        def cost_at(units):
            key = tuple(units)
            if key not in runs:
                runs[key] = run_cell(_with_units(cfg, units), shape, mesh,
                                     ctx_p, pcfg)
            return runs[key]

        t0 = time.perf_counter()
        base = cost_at(base_units)
        keys = ("flops", "bytes", "attn_score_bytes", "collective_bytes",
                "collective_counts")
        full = {k: (dict(base[k]) if isinstance(base[k], dict) else base[k])
                for k in keys}
        for i, (field, count, unit) in enumerate(dims):
            up = list(base_units)
            up[i] = min(base_units[i] + 1, count)
            if up[i] == base_units[i]:
                continue
            c2 = cost_at(up)
            scale = count - base_units[i]
            for k in ("flops", "bytes", "attn_score_bytes"):
                full[k] += scale * (c2[k] - base[k])
            for k in ("collective_bytes", "collective_counts"):
                for kk in _COLLECTIVES:
                    full[k][kk] += scale * (c2[k][kk] - base[k][kk])
        full["probe_compile_s"] = round(time.perf_counter() - t0, 1)
        result["probe"] = full
        if verbose:
            tot = sum(full["collective_bytes"].values())
            print(f"    probe: {full['flops'] / 1e12:.2f} TFLOP/dev, "
                  f"{full['bytes'] / 2**30:.2f} GiB/dev, "
                  f"coll {tot / 2**30:.3f} GiB/dev "
                  f"({full['probe_compile_s']}s)", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--kv-mode", default="auto")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-moe-shard-map", action="store_true")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence parallelism (perf baseline)")
    ap.add_argument("--sp-prenorm", action="store_true",
                    help="norms on the gathered sequence")
    ap.add_argument("--pure-fsdp", action="store_true",
                    help="ZeRO-3: data over every axis, no TP, no SP")
    ap.add_argument("--moe-impl", default="tp", choices=["tp", "ep"])
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose step runs (default 0)")
    ap.add_argument("--json")
    args = ap.parse_args(argv)

    from ..configs import all_cells

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    results = []
    for arch, shape in cells:
        try:
            r = lower_cell(arch, shape, args.multi_pod, probe=args.probe,
                           kv_mode=args.kv_mode, remat=not args.no_remat,
                           moe_shard_map=not args.no_moe_shard_map,
                           sequence_parallel=not args.no_sp,
                           moe_impl=args.moe_impl, rank=args.rank,
                           sp_prenorm=args.sp_prenorm,
                           pure_fsdp=args.pure_fsdp)
        except Exception as e:  # noqa: BLE001 -- a cell failure is a report
            r = {"arch": arch, "shape": shape, "error": repr(e),
                 "sequence_parallel": False}
            print(f"[{arch} x {shape}] FAILED: {e}", flush=True)
        results.append(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    n_err = sum(1 for r in results if "error" in r)
    print(f"dry-run: {len(results)} cells, {n_err} failures", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
