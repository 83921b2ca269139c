"""Parallel placement of the port: sharding rules, the mesh context, the
collectives of the meshed training path and the quantized all-reduce."""

from .mesh_ctx import MeshCtx, make_ctx
from .sharding import P, ParallelConfig, make_parallel_cfg, param_pspecs
