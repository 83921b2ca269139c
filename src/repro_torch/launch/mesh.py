"""Device meshes for the port (the port of the JAX package's
``launch/mesh.py``): a ``torch.distributed`` ``DeviceMesh`` with dims
``("data", "model")`` over the initialized default process group.

The production meshes (256 and 512 ranks, ``make_production_mesh``) belong
with the dry run, which is not ported yet.
"""

from __future__ import annotations

from typing import Optional


def make_mesh_for(n_devices: Optional[int] = None, model_parallel: int = 1,
                  device_type: str = "cuda"):
    """A (data, model) mesh of ``n_devices`` ranks (default: the default
    group's world size), ``model_parallel`` of them a model row.  The
    default group must be initialized (``torch.distributed.
    init_process_group``): gloo for ``device_type="cpu"``, NCCL for
    ``"cuda"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = n_devices or dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model rows of "
                         f"{model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))
