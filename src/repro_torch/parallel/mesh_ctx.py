"""Mesh context threaded through model code (the port of the JAX package's
``parallel/mesh_ctx.py``).

Decouples model definitions from the concrete mesh: models only see axis
*roles* (dp/tp).  ``MeshCtx(None)`` is the single-device path — every
collective becomes a no-op and the MoE dispatch runs unplaced.  The mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` with named dims (``data``,
``model``, and ``pod`` on the multi-pod mesh; ``launch.mesh``).  Its rank
layout is read once, as plain Python, when the context is made, so a
context serves under ``FakeTensorMode`` too (the dry run).

``sequence_parallel``: training and prefill keep the residual stream
between the blocks as this rank's rows of the sequence over ``model``
(``models.transformer._seq_shard``; decode never does); ``sp_prenorm``:
the blocks' norms run on the gathered sequence instead of the shard (the
same values; the reference's knob for where XLA puts the norm).
``sp_barrier`` is the reference's pin of the bf16 residual before the
sequence collectives, which the port's explicit collectives always move
in the activation type: it changes nothing here.  ``pure_dp``: the
ZeRO-3 layout of the reference's dry run; the port's rules make it
(``sharding.ParallelConfig.pure_fsdp``: no weight split over ``model``,
so no tensor-parallel region), and the model reads nothing else of it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple, Union

import numpy as np

Axis = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: Optional[Any] = None
    dp: Tuple[str, ...] = ("data",)      # batch / fsdp axes
    tp: str = "model"                    # tensor-parallel axis
    use_shard_map_moe: bool = True
    sequence_parallel: bool = False
    remat: bool = False                  # activation-checkpoint layers
    unroll: bool = False                 # unroll layer scans (cost probes)
    moe_impl: str = "tp"                 # tp (FSDP+TP baseline) | ep (a2a)
    sp_barrier: bool = False             # pin bf16 before SP collectives
    sp_prenorm: bool = False             # gather the raw bf16 residual
                                         # before the norm (not after)
    pure_dp: bool = False                # ZeRO-3: no TP constraints
    kv_mode: str = "auto"                # serving caches: auto | heads |
                                         # head_dim | replicate

    def __post_init__(self):
        # axis sizes, this rank's coordinates and the groups, looked up once
        # (the model reads them for every weight of every step)
        sizes, coords, ranks = {}, {}, None
        if self.mesh is not None:
            for i, name in enumerate(self.mesh.mesh_dim_names):
                sizes[name] = int(self.mesh.shape[i])
                coords[name] = int(self.mesh.get_local_rank(name))
            from torch.utils._python_dispatch import _disable_current_modes
            with _disable_current_modes():
                ranks = np.asarray(self.mesh.mesh.tolist(), dtype=np.int64)
        object.__setattr__(self, "_sizes", sizes)
        object.__setattr__(self, "_coords", coords)
        object.__setattr__(self, "_ranks", ranks)
        object.__setattr__(self, "_groups", {})
        # the training forward's gathered weights
        # (``collectives.regather_saved``), how many weights backwards
        # have gathered again, and the bytes of each layer input the last
        # forward kept for a remat backward
        object.__setattr__(self, "state", {"regather": None,
                                           "regathered": 0,
                                           "savepoints": []})

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def wsc(self, x, *spec):
        """The identity.  The reference's ``with_sharding_constraint`` is a
        layout hint to GSPMD with no effect on the values; here every
        tensor's layout is explicit in the model code (local shards and the
        collectives of ``parallel.collectives``), so there is nothing to
        hint."""
        return x

    def axis_size(self, axis: Axis) -> int:
        if isinstance(axis, str):
            return self._sizes.get(axis, 1)
        return math.prod(self._sizes.get(a, 1) for a in axis)

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp)

    @property
    def tp_size(self) -> int:
        return self._sizes.get(self.tp, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along mesh dim ``axis``."""
        return self._coords.get(axis, 0)

    def group(self, axis: Axis):
        """The process group of a mesh dim, or of a tuple of dims (ranks in
        the order of the tuple's flattened index, outermost first); None
        without a mesh."""
        if not self.active:
            return None
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if axes not in self._groups:
            self._groups[axes] = self._make_group(axes)
        return self._groups[axes]

    def group_ranks(self, axes: Tuple[str, ...]):
        """Every group over mesh dims ``axes``: a list of rank lists, one
        for each coordinate of the other dims, each in the order of the
        tuple's flattened index (outermost first)."""
        names = list(self.mesh.mesh_dim_names)
        if len(set(axes)) != len(axes) or not set(axes) <= set(names):
            raise ValueError(f"mesh dims {axes} of a {tuple(names)} mesh")
        rest = [names.index(a) for a in names if a not in axes]
        order = rest + [names.index(a) for a in axes]
        n = math.prod(self._sizes[a] for a in axes)
        return self._ranks.transpose(order).reshape(-1, n).tolist()

    def _make_group(self, axes):
        import torch.distributed as dist
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        groups = self.group_ranks(axes)
        if len(groups) == 1 and groups[0] == list(
                range(dist.get_world_size())):
            return dist.group.WORLD
        # every rank makes every group (``new_group`` is collective), in
        # the same order on every rank, and keeps its own
        mine, _ = dist.new_subgroups_by_enumeration(groups)
        return mine


def make_ctx(mesh, **kw) -> MeshCtx:
    """The context of ``mesh``: the batch over every dim but ``model``;
    ``kw``: the other fields."""
    if mesh is None:
        return MeshCtx(None, **kw)
    dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
    return MeshCtx(mesh=mesh, dp=dp, tp="model", **kw)
