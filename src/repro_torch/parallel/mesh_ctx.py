"""Mesh context threaded through model code (the port of the JAX package's
``parallel/mesh_ctx.py``).

Decouples model definitions from the concrete mesh: models only see axis
*roles* (dp/tp).  ``MeshCtx(None)`` is the single-device path — every
collective becomes a no-op and the MoE dispatch runs unplaced.  The mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` with named dims (``data``,
``model``; ``launch.mesh.make_mesh_for``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple, Union

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

    def __post_init__(self):
        # axis sizes, this rank's coordinates and the groups, looked up once
        # (the model reads them for every weight of every step)
        sizes, coords = {}, {}
        if self.mesh is not None:
            for i, name in enumerate(self.mesh.mesh_dim_names):
                sizes[name] = int(self.mesh.shape[i])
                coords[name] = int(self.mesh.get_local_rank(name))
        object.__setattr__(self, "_sizes", sizes)
        object.__setattr__(self, "_coords", coords)
        object.__setattr__(self, "_groups", {})
        # the training forward's gathered weights
        # (``collectives.regather_saved``) and how many weights backwards
        # have gathered again
        object.__setattr__(self, "state", {"regather": None,
                                           "regathered": 0})

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

    def _make_group(self, axes):
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        names = tuple(self.mesh.mesh_dim_names)
        if axes == names:
            import torch.distributed as dist
            ranks = self.mesh.mesh.flatten().tolist()
            if ranks == list(range(dist.get_world_size())):
                return dist.group.WORLD
        raise NotImplementedError(
            f"a process group over mesh dims {axes} of a {names} mesh")


def make_ctx(mesh) -> MeshCtx:
    if mesh is None:
        return MeshCtx(None)
    dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
    return MeshCtx(mesh=mesh, dp=dp, tp="model")
