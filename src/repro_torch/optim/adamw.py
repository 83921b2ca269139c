"""AdamW with float32 master weights, decay masking and global-norm
clipping (the port of the JAX package's ``optim/adamw.py``).

Model parameters stay in the model's type (what the products consume); the
optimizer carries float32 master copies and both moments, in a state dict
``{"master": {name: tensor}, "m": {...}, "v": {...}, "step": int32}``
keyed by the model's parameter names.  The arithmetic is the reference's:
decay only where the reference's leaf has ``ndim >= 2`` (its stacked
leaves carry the layer axis, so the caller passes the mask:
``launch.steps.decay_mask``), clipping by the global norm with
``max(gnorm, 1e-9)``, bias corrections ``1 - b ** step`` in float32, new
parameters cast back to each parameter's type.  :func:`update` walks the
leaves one at a time and updates the state and the parameters in place, so
a step holds float32 temporaries of one leaf, never a second float32 copy
of every gradient (the reference casts the whole gradient tree at once).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@torch.no_grad()
def init(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """Float32 master copies and zero moments of ``params`` (name ->
    tensor, e.g. ``dict(model.named_parameters())``), and step 0."""
    dev = next(iter(params.values())).device
    return {
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in params.items()},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def global_norm(tree: Mapping[str, torch.Tensor],
                counted: Optional[Mapping[str, bool]] = None,
                group=None) -> torch.Tensor:
    """The norm of every leaf together.  On a mesh each rank passes its
    shards, ``counted`` (name -> bool) says which it counts (a leaf
    replicated over some mesh axes only on one rank of them) and the
    squared sums are summed over ``group`` (the whole mesh)."""
    leaves = [x.float().square().sum() for x in tree.values()]
    if counted is not None:
        leaves = [s if counted[n] else torch.zeros_like(s)
                  for n, s in zip(tree, leaves)]
    total = torch.stack(leaves).sum()
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: Dict[str, object],
           params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
           decay: Mapping[str, bool],
           counted: Optional[Mapping[str, bool]] = None, group=None):
    """One step: ``state`` and ``params`` (the model's own tensors) are
    updated in place, leaf by leaf; ``decay`` (name -> bool) says which
    leaves take weight decay.  Returns (params, state, metrics) with
    ``metrics = {"grad_norm", "lr"}``, as the reference returns them.  On
    a mesh the tensors are this rank's shards and the clipping norm is
    the global one (``global_norm``'s ``counted`` and ``group``)."""
    step = state["step"] + 1
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr

    gnorm = global_norm(grads, counted, group)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 else None

    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for name, g in grads.items():
        g = g.float() * scale if scale is not None else g.float()
        m, v, w = state["m"][name], state["v"][name], state["master"][name]
        m.mul_(cfg.b1).add_(g * (1.0 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square().mul_(1.0 - cfg.b2))
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        if decay[name]:
            upd.add_(cfg.weight_decay * w)
        w.sub_(upd.mul_(lr))
        params[name].copy_(w)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
