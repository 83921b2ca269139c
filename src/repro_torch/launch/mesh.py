"""Device meshes for the port (the port of the JAX package's
``launch/mesh.py``): ``torch.distributed`` ``DeviceMesh``es with named
dims over the initialized default process group.

``make_production_mesh`` builds the reference's two production meshes
(16 x 16 ``("data", "model")``, or 2 x 16 x 16 ``("pod", "data",
"model")``); the dry run (``launch.dryrun``) builds them on the CPU over a
fake process group of 256 or 512 ranks.  ``make_mesh_for`` is the
(data, model) mesh of any world size (tests, elastic restarts).
"""

from __future__ import annotations

from typing import Optional


def _mk(shape, names, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs a world of {n} ranks, the "
                         f"default group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 single pod (256 ranks) or 2 x 16 x 16 (512 ranks, 2 pods)
    over the default group, which must hold that many ranks."""
    if multi_pod:
        return _mk((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mk((16, 16), ("data", "model"), device_type)


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
