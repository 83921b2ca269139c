"""The collectives of the meshed training path, as autograd pairs over a
``MeshCtx`` axis (XLA inserts these for the reference from its sharding
annotations; here the model code calls them).

Pairs (forward / backward):
  * :func:`gather`: all-gather along a dim / reduce-scatter (``grad="sum"``:
    an FSDP storage dim, each data rank's gradient a partial sum) or the
    own chunk of the gradient (``grad="slice"``: a dim gathered for a
    computation every rank of the group repeats);
  * :func:`copy_to`: identity / all-reduce (the input of a Megatron
    column-parallel region);
  * :func:`reduce_from`: all-reduce / identity (the output of a
    row-parallel region);
  * :func:`split`: the own chunk / all-gather (a replicated tensor read
    by a region that holds a slice of its dim);
  * :func:`reduce_shared`: all-reduce / all-reduce (a statistic summed
    over the group and read by every rank's slice: a norm over a sharded
    dim);
  * :func:`all_to_all`: ``all_to_all_single`` both ways (expert routing);
  * :func:`reduce_scatter`: reduce-scatter along a dim / all-gather (the
    output of a row-parallel region under sequence parallelism).

Sequence parallelism (:class:`SeqShard`) uses two of them at every
tensor-parallel region: the S all-gather at its entry (:func:`gather`,
whose backward reduce-scatters the ranks' partial gradients, in the place
of ``copy_to``) and the S reduce-scatter at its exit (in the place of
``reduce_from``); a region computed whole on every rank gathers with a
``"slice"`` gradient and keeps its own rows (:func:`split`).

At group size 1 (or without a group) every pair returns its input itself:
no collective, no copy, so a (1, 1) mesh computes the meshless path's
values bit for bit in the meshless path's memory.  Only
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce`` and
``all_to_all_single`` are used (present in torch 2.11 and 2.13, gloo and
NCCL).

:func:`weight` reads a parameter for the compute: every sharded dim
gathered except the one the caller keeps split over ``model``.  The
parameter's spec is its ``_spec`` attribute (``parallel.sharding.P``),
set when the Trainer shards the model; a parameter without one is whole.
Under :func:`regather_saved` (the training forward) a gathered weight is
not saved for the backward: the backward gathers it again, so a layer's
gathered weights live only through that layer.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from .sharding import P, spec_axes


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gather_raw(x, dim: int, group):
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + xm.shape[1:])
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_raw(x, dim: int, group):
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + xm.shape[1:])
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _chunk(x, dim: int, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.narrow(dim, r * (x.shape[dim] // n), x.shape[dim] // n)


def _all_reduce(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        return _gather_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if not ctx.summed:
            return _chunk(g, ctx.dim, ctx.group).contiguous(), None, None, \
                None
        return _reduce_scatter_raw(g, ctx.dim, ctx.group), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x.contiguous())
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g.contiguous())
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def gather(x, dim: int, group, grad: str = "sum"):
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group, grad == "sum")


def copy_to(x, group):
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def reduce_shared(x, group):
    return x if group_size(group) == 1 else _ReduceShared.apply(x, group)


def split(x, dim: int, group):
    return x if group_size(group) == 1 else _Split.apply(x, dim, group)


def reduce_scatter(x, dim: int, group):
    """The ranks' partial sums of ``x`` summed, this rank's chunk of dim
    ``dim`` kept; the backward all-gathers the gradient."""
    return x if group_size(group) == 1 else _ReduceScatter.apply(x, dim,
                                                                 group)


def all_to_all(x, group):
    """Chunk i of dim 0 to rank i; chunk j of the result from rank j."""
    return x if group_size(group) == 1 else _AllToAll.apply(x, group)


def own_chunk(x, dim: int, group):
    """This rank's chunk of dim ``dim`` (no collective, no gradient pair:
    serving writes its part of a cache split over ``group``)."""
    return x if group_size(group) == 1 else _chunk(x, dim, group)


def gathered(x, dim: int, group):
    """The ranks' chunks of dim ``dim`` all-gathered, without a gradient
    pair (serving reads a cache split over ``group`` whole)."""
    return x if group_size(group) == 1 else _gather_raw(x, dim, group)


def summed(x, group):
    """The ranks' ``x`` summed, without a gradient pair (serving's partial
    attention scores)."""
    return x if group_size(group) == 1 else _all_reduce(x, group)


class SeqShard:
    """Sequence parallelism at one tensor-parallel region: the region's
    input ``x`` (B, S / n, ...) is this rank's rows of the sequence over
    ``group``.  :meth:`enter` gathers the whole sequence (its gradient
    reduce-scattered where the region is tensor-parallel, ``tp``: each
    rank's is a partial sum; else its own rows of the gradient every rank
    repeats) and applies ``pre`` (the norm, under ``sp_prenorm``) to the
    gathered copy: ``pre(x, partial)``, ``partial`` whether the gradient
    reaching it is each rank's partial sum (a weight of ``pre`` then sums
    its gradient over the group).  :meth:`exit` reduce-scatters a
    tensor-parallel region's partial output over the sequence, or keeps a
    whole region's own rows.  ``mixed``: the region also reads its input
    outside its tensor-parallel products (whole projections), so the
    gather keeps a ``"slice"`` gradient and the region's own ``copy_to``
    sums the partial ones."""

    def __init__(self, group, pre=None):
        self.group, self.pre = group, pre

    def enter(self, x, tp: bool, mixed: bool = False):
        partial = tp and not mixed
        x = gather(x, 1, self.group, "sum" if partial else "slice")
        return x if self.pre is None else self.pre(x, partial)

    def exit(self, x, tp: bool):
        return (reduce_scatter(x, 1, self.group) if tp
                else split(x, 1, self.group))


# ---------------------------------------------------------------------------
# Parameters on a mesh.
# ---------------------------------------------------------------------------

def spec_of(t) -> Optional[P]:
    return getattr(t, "_spec", None)


def on_tp(mctx, t, dim: int) -> bool:
    """Whether dim ``dim`` of parameter ``t`` is split over ``model`` (and
    nothing else)."""
    spec = spec_of(t)
    return spec is not None and spec[dim] == mctx.tp


def tp_region(mctx, *pairs) -> bool:
    """Whether a block runs tensor-parallel: a mesh with more than one
    model rank and every (parameter, dim) of ``pairs`` split over
    ``model``."""
    return (mctx is not None and mctx.active and mctx.tp_size > 1
            and all(t is None or on_tp(mctx, t, d) for t, d in pairs))




def weight(mctx, t, keep: Optional[int] = None, summed: bool = False):
    """Parameter ``t`` for the compute: every dim of its spec gathered
    (innermost axis first), but ``keep``, which stays split over
    ``model``.  A gather over a batch axis reduce-scatters its gradient;
    over another axis it keeps its own chunk, as every rank of that axis
    repeats the computation, unless ``summed`` (each rank computes with a
    different part of the tensor, the expert-parallel weights).  Inside
    :func:`regather_saved` the gathered tensor is not kept for the
    backward: it is gathered again when the backward reads it."""
    spec = spec_of(t)
    if t is None or mctx is None or not mctx.active or spec is None:
        return t
    # (dim, group, gradient) of each gather, a dim's innermost axis first
    steps = [(d, mctx.group(axis),
              "sum" if summed or axis in mctx.dp else "slice")
             for d, entry in enumerate(spec) if d != keep
             for axis in reversed(spec_axes(entry))
             if mctx.axis_size(axis) > 1]
    if not steps:
        return t
    out = t
    for d, g, grad in steps:
        out = gather(out, d, g, grad)
    live = mctx.state["regather"]
    if live is not None:
        live.gathered[id(out)] = (weakref.ref(out), t, steps)
    return out


class _Regather:
    """The weights one forward gathered, by the identity of the tensor
    (``id``, checked against a weak reference, so a freed tensor's reused
    id never matches: the same for real and fake tensors, whose data
    pointers say nothing), each with its parameter and its gathers:
    ``saved_tensors_hooks`` keep the parameter in place of a gathered
    weight that autograd saves, and gather it again when the backward
    reads it."""

    def __init__(self, mctx):
        self.mctx, self.gathered = mctx, {}

    def pack(self, x):
        entry = self.gathered.get(id(x))
        if entry is not None and entry[0]() is x:
            return (entry[1], entry[2])
        return x

    def unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        self.mctx.state["regathered"] += 1
        t, steps = packed
        with torch.no_grad():
            for d, g, _ in steps:
                t = _gather_raw(t, d, g)
        return t


@contextlib.contextmanager
def regather_saved(mctx):
    """Autograd keeps the parameter shard, not the gathered weight, for
    the backward of every product that reads a :func:`weight`, and
    gathers it again when the backward needs it: each layer's gathered
    weights are freed after its forward.  A no-op on a mesh of one
    rank."""
    if mctx is None or not mctx.active \
            or mctx.state["regather"] is not None \
            or mctx.axis_size(mctx.mesh.mesh_dim_names) == 1:
        yield
        return
    live = mctx.state["regather"] = _Regather(mctx)
    try:
        with torch.autograd.graph.saved_tensors_hooks(live.pack,
                                                      live.unpack):
            yield
    finally:
        mctx.state["regather"] = None


def local_slice(t: torch.Tensor, spec: Optional[P], mctx) -> torch.Tensor:
    """This rank's shard of a whole tensor ``t`` (``t`` itself where no
    dim is split over more than one rank)."""
    if spec is None or mctx is None or not mctx.active:
        return t
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        n = mctx.axis_size(axes) if axes else 1
        if n == 1:
            continue
        idx = 0
        for a in axes:
            idx = idx * mctx.axis_size(a) + mctx.coord(a)
        size = t.shape[d] // n
        t = t.narrow(d, idx * size, size)
    return t


@torch.no_grad()
def gather_whole(t: torch.Tensor, spec: Optional[P], mctx) -> torch.Tensor:
    """The whole tensor from each rank's shard (every rank gets it)."""
    if spec is None or mctx is None or not mctx.active:
        return t
    for d, entry in enumerate(spec):
        for axis in reversed(spec_axes(entry)):
            if mctx.axis_size(axis) > 1:
                t = _gather_raw(t, d, mctx.group(axis))
    return t


@torch.no_grad()
def place_model(model, cfg, mctx):
    """Keep this rank's shards of the whole parameters of ``model``, as
    ``Trainer(mesh=...)`` places them: each parameter's spec
    (``sharding.param_pspecs`` on the mesh) as its ``_spec``, the whole
    shape as its ``_whole`` (a meta tensor) and its local slice as its
    data.  Returns the specs by name (None without a mesh, where nothing
    changes)."""
    from .sharding import make_parallel_cfg, param_pspecs
    if mctx is None or not mctx.active:
        return None
    named = dict(model.named_parameters())
    specs = param_pspecs(named, make_parallel_cfg(mctx.mesh), cfg)
    for name, p in named.items():
        p._whole = torch.empty(p.shape, dtype=p.dtype, device="meta")
        p._spec = specs[name]
        part = local_slice(p.data, specs[name], mctx)
        if part is not p.data:
            p.data = part.contiguous().clone()
    return specs


def counted(mctx, spec: Optional[P]) -> bool:
    """Whether this rank's shard of a tensor with ``spec`` is the copy
    counted in a sum over the mesh: index 0 on every axis the tensor is
    replicated over."""
    if mctx is None or not mctx.active:
        return True
    split_axes = {a for e in (spec or ()) for a in spec_axes(e)}
    return all(mctx.coord(a) == 0 for a in mctx.mesh.mesh_dim_names
               if a not in split_axes)


@torch.no_grad()
def reduce_replicated_grads(mctx, grads: Mapping[str, torch.Tensor],
                            specs: Mapping[str, P]) -> None:
    """Sum (in place) each gradient over the batch axes its parameter is
    not split over: the data ranks' partial gradients of a replicated
    leaf.  Gradients of leaves split over a batch axis were summed by
    their gather's reduce-scatter."""
    if mctx.dp_size == 1:
        return
    for name, g in grads.items():
        split_axes = {a for e in specs[name] for a in spec_axes(e)}
        axes = tuple(a for a in mctx.dp if a not in split_axes)
        if mctx.axis_size(axes) > 1:
            dist.all_reduce(g, group=mctx.group(axes))
