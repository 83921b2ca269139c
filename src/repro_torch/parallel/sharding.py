"""Sharding rules: DP / FSDP / TP / EP placement for every parameter family
(the port of the JAX package's ``parallel/sharding.py``).

The rules are *name-based on trailing dims*: each leaf name maps to a spec
for its last-k dims; any extra leading dims (the JAX tree's stacked layer
axes, or the hybrid's (n_super, attn_every) nesting) are padded with
``None``.  One table covers the parameters and AdamW's ``m``, ``v`` and
``master``.

Axes:
  * ``model`` (tp): Megatron-style tensor parallelism — attention heads,
    FFN hidden, MoE expert FFN hidden, SSD heads, vocab;
  * ``data`` (fsdp): storage sharding of the non-TP weight dim, gathered
    layer by layer for the compute (``parallel.collectives``);
  * ``("pod", "data")`` (dp): the batch dim of activations and inputs.
KV caches pick heads / head-dim / replicated sharding per arch by
divisibility.

A spec is :class:`P`, a tuple whose entries are ``None``, an axis name or a
tuple of names, as the entries of JAX's ``PartitionSpec``.
:func:`param_pspecs` takes either the JAX leaf layout (nested dicts of
anything with ``.shape``: stacked layer axes) or the port's named
parameters (``blocks.{i}.attn.wq``: the layer axes split), for which it
gives the spec of the JAX leaf with the split layer axes dropped.
:func:`placements` turns a spec into the ``Shard`` / ``Replicate`` of each
dim of a ``torch.distributed`` device mesh; a mesh is a ``DeviceMesh`` with
named dims or a mapping of axis names to sizes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional, Tuple

from ..convert import stack_shape

if TYPE_CHECKING:                       # models import this package
    from ..models.config import ModelConfig


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name,
    or a tuple of axis names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


# leaf name -> spec for trailing dims (fsdp axis = F, tp axis = T below)
_F = "__fsdp__"
_T = "__tp__"

_RULES = {
    "tok": (_T, _F),
    "unembed": (_F, _T),
    "scale": (None,),
    "wq": (_F, _T), "wk": (_F, _T), "wv": (_F, _T), "wo": (_T, _F),
    "bq": (_T,), "bk": (_T,), "bv": (_T,),
    "w_gate": (_F, _T), "w_up": (_F, _T), "w_down": (_T, _F),
    "b_up": (_T,), "b_down": (None,),
    "wg": (None, None),
    "z_proj": (_F, _T), "x_proj": (_F, _T),
    "bc_proj": (_F, None), "dt_proj": (_F, None),
    "conv_x_w": (None, _T), "conv_x_b": (_T,),
    "conv_bc_w": (None, None), "conv_bc_b": (None,),
    "A_log": (None,), "D": (None,), "dt_bias": (None,),
    "out_proj": (_T, _F),
    "projector": (None, _F),
    "enc_in": (None, _F),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = True
    fsdp_axis: str = "data"
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)
    kv_mode: str = "auto"     # auto | heads | head_dim | replicate
    remat: str = "none"       # none | block
    # ZeRO-3: no tensor parallelism; weights and optimizer state sharded
    # over every mesh axis, the batch data-parallel over every axis
    pure_fsdp: bool = False
    # axis sizes, for divisibility guards (a dim that does not divide its
    # axis size is replicated instead — e.g. whisper's vocab 51865 % 16)
    fsdp_size: int = 1
    tp_size: int = 1
    dp_size: int = 1

    def axis_size(self, axis) -> int:
        if axis == self.tp_axis:
            return self.tp_size
        if axis == self.fsdp_axis:
            return self.fsdp_size
        if axis == self.dp_axes:
            return self.dp_size
        if axis == "pod":
            return max(1, self.dp_size // max(1, self.fsdp_size))
        return 1


def _guard(spec_list, shape, pcfg: ParallelConfig):
    """Drop axis assignments whose dim does not divide the axis size."""
    out = []
    for dim, axis in zip(shape, spec_list):
        if axis is None:
            out.append(None)
            continue
        if isinstance(axis, tuple):
            size = 1
            for a in axis:
                size *= pcfg.axis_size(a)
            if axis == pcfg.dp_axes:
                size = pcfg.dp_size
        else:
            size = pcfg.axis_size(axis)
        out.append(axis if dim % max(1, size) == 0 else None)
    return out


def _resolve(spec, pcfg: ParallelConfig, shape) -> P:
    trans = []
    for s in spec:
        if s == _F:
            if pcfg.pure_fsdp:
                trans.append((pcfg.fsdp_axis, pcfg.tp_axis))
            else:
                trans.append(pcfg.fsdp_axis if pcfg.fsdp else None)
        elif s == _T:
            trans.append(None if pcfg.pure_fsdp else pcfg.tp_axis)
        else:
            trans.append(s)
    full = [None] * (len(shape) - len(trans)) + trans
    return P(*_guard(full, shape, pcfg))


def _rule(name: Optional[str], shape, pcfg: ParallelConfig) -> P:
    spec = _RULES.get(name)
    if spec is None:
        return P(*([None] * len(shape)))
    if len(spec) > len(shape):
        spec = spec[-len(shape):] if shape else ()
    return _resolve(spec, pcfg, tuple(shape))


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and not isinstance(x, Mapping)


def _map(tree, fn, name=None):
    """``fn(name, leaf)`` over a tree of dicts, tuples and lists, ``name``
    the innermost dict key above the leaf (``jax.tree_util.DictKey``)."""
    if isinstance(tree, P):
        return fn(name, tree)
    if isinstance(tree, Mapping):
        return {k: _map(v, fn, str(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not _is_leaf(tree):
        return type(tree)(_map(v, fn, name) for v in tree)
    return fn(name, tree)


def map_leaves(fn, tree, *others):
    """``fn(leaf, *the same leaf of each of others)`` over the leaves of
    ``tree`` (dicts, tuples and lists of tensors), into a tree of its
    structure; ``others`` share it (a tree of specs: each spec one
    leaf)."""
    if isinstance(tree, Mapping):
        return {k: map_leaves(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not _is_leaf(tree):
        return type(tree)(map_leaves(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def _named_layout(tree) -> bool:
    return (isinstance(tree, Mapping) and bool(tree)
            and all(_is_leaf(v) for v in tree.values())
            and any("." in str(k) for k in tree))


def param_pspecs(params_shape, pcfg: ParallelConfig,
                 cfg: Optional[ModelConfig] = None):
    """Specs for a params (or optimizer-state) tree.

    * The JAX leaf layout (nested dicts, stacked layer axes): a tree of
      :class:`P` of the same structure, as the reference maps it.
    * The port's named parameters (``{"blocks.0.attn.wq": tensor, ...}``,
      needs ``cfg``): ``{name: P}``, each the spec of its JAX leaf (the
      layer axes stacked back on: ``convert.stack_shape``) with those axes
      dropped."""
    if _named_layout(params_shape):
        if cfg is None:
            raise ValueError("param_pspecs: named parameters need the "
                             "model's config (their layer axes)")
        out = {}
        for name, t in params_shape.items():
            parts = name.split(".")
            if parts[0] == "blocks" and cfg.family == "hybrid":
                path = ("blocks", *parts[3:])
            elif parts[0] in ("blocks", "enc_blocks", "vision_blocks"):
                path = (parts[0], *parts[2:])
            else:
                path = tuple(parts)
            lead = stack_shape(path, cfg)
            spec = _rule(parts[-1], tuple(lead) + tuple(t.shape), pcfg)
            out[name] = P(*spec[len(lead):])
        return out
    return _map(params_shape, lambda name, leaf: _rule(
        name, tuple(leaf.shape), pcfg))


def kv_layout(cfg: ModelConfig, kv_mode: str, tp_size: int) -> str:
    """The KV caches' split over ``model`` ("heads", "head_dim" or
    "replicate"): ``kv_mode`` where its dim divides ``tp_size`` (else
    "replicate"), or for "auto" the KV heads where they divide it, else
    the head dim where it does, else none."""
    if kv_mode != "auto":
        if kv_mode not in ("heads", "head_dim", "replicate"):
            raise ValueError(f"kv_mode {kv_mode!r}")
        # a dim the axis does not divide stays whole (``_guard``)
        dim = {"heads": cfg.n_kv_heads, "head_dim": cfg.hd}.get(kv_mode)
        return kv_mode if dim is None or dim % tp_size == 0 else "replicate"
    if cfg.n_kv_heads and cfg.n_kv_heads % tp_size == 0:
        return "heads"
    if cfg.hd % tp_size == 0:
        return "head_dim"
    return "replicate"


def kv_cache_pspecs(cache_shape, cfg: ModelConfig, pcfg: ParallelConfig,
                    tp_size: int):
    """Specs for a decode cache tree (leading layer-stack dims)."""
    mode = kv_layout(cfg, pcfg.kv_mode, tp_size)
    dp = pcfg.dp_axes
    tp = pcfg.tp_axis

    def rule(name, leaf):
        ndim = len(leaf.shape)
        if name in ("k", "v"):
            # (..., B, S, KV, hd)
            tail = {
                "heads": [dp, None, tp, None],
                "head_dim": [dp, None, None, tp],
                "replicate": [dp, None, None, None],
            }[mode]
        elif name == "state":      # (..., B, h, hp, n)
            tail = [dp, tp, None, None]
        elif name == "conv_x":     # (..., B, K-1, di)
            tail = [dp, None, tp]
        elif name == "conv_bc":
            tail = [dp, None, None]
        else:
            return P(*([None] * ndim))
        full = [None] * (ndim - len(tail)) + tail
        return P(*_guard(full, tuple(leaf.shape), pcfg))

    return _map(cache_shape, rule)


def batch_pspecs(batch_shape, pcfg: ParallelConfig):
    dp = pcfg.dp_axes

    def rule(_, leaf):
        full = [dp] + [None] * (len(leaf.shape) - 1)
        return P(*_guard(full, tuple(leaf.shape), pcfg))

    return _map(batch_shape, rule)


# ---------------------------------------------------------------------------
# Meshes.
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (named dims) or of a
    mapping of axis names to sizes."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a mesh needs named dims")
    return {n: int(s) for n, s in zip(names, mesh.shape)}


def make_parallel_cfg(mesh, **kw) -> ParallelConfig:
    if mesh is None:
        return ParallelConfig(fsdp=False, dp_axes=(), **kw)
    sizes = axis_sizes(mesh)
    if kw.get("pure_fsdp"):
        dp_axes = tuple(sizes)                 # batch over every axis
    else:
        dp_axes = tuple(a for a in sizes if a != "model")
    dp_size = math.prod(sizes[a] for a in dp_axes)
    return ParallelConfig(
        dp_axes=dp_axes, dp_size=dp_size,
        fsdp_size=sizes.get("data", 1), tp_size=sizes.get("model", 1), **kw)


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec: P, sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """Each rank's shard of a tensor of ``shape`` with ``spec`` on a mesh of
    axis ``sizes``: every dim divided by the product of its axes' sizes
    (the rules only split dims those sizes divide)."""
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = math.prod(sizes.get(a, 1) for a in spec_axes(e))
        if d % n:
            raise ValueError(f"dim {d} does not split over {e} ({n} ranks)")
        out.append(d // n)
    return tuple(out)


def placements(spec: P, mesh) -> tuple:
    """The placement on each mesh dim of a tensor with ``spec``:
    ``Shard(tensor dim)`` where a dim is split over that mesh axis, else
    ``Replicate()`` (the port's ``to_named``)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in axis_sizes(mesh):
        dims = [d for d, e in enumerate(spec) if axis in spec_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Named:
    """A spec on a mesh (the port's ``NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def to_named(tree, mesh):
    return _map(tree, lambda _, s: Named(mesh, s))
