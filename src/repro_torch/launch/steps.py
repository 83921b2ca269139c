"""The training step (the port of the training half of the JAX package's
``launch/steps.py``): the loss and ``make_train_step``.

The mesh, ``shardings_for`` and the ShapeDtypeStruct input specs belong
with ``parallel/``, which is not ported yet (ROADMAP A10).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..convert import jax_leaf_order, stack_shape
from ..models import train_logits
from ..models.config import ModelConfig
from ..optim import adamw

AUX_COEF = 0.01


def loss_fn(model, batch, cfg: ModelConfig, *, remat: bool = False):
    """(loss + AUX_COEF * aux, (loss, aux)): the mean next-token negative
    log-likelihood of ``batch["labels"]`` under float32 log-softmax (the
    vlm's image positions dropped) and the MoE load-balance term."""
    logits, aux = train_logits(model, batch, cfg, remat=remat)
    labels = batch["labels"]
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_patches:]
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    loss = -ll.mean()
    return loss + AUX_COEF * aux, (loss, aux)


def decay_mask(params: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Dict[str, bool]:
    """Which parameters AdamW decays.  The reference decays the leaves of
    its parameter tree with ``ndim >= 2``, and a stacked leaf carries its
    layer axes: so it decays every per-layer vector (norm scales, biases)
    and no top-level one (the final norm's scale).  ``params``: the port
    model's parameters by name."""
    out = {}
    for path, names in jax_leaf_order(params, cfg):
        lead = len(stack_shape(path, cfg))
        for n in names:
            out[n] = params[n].dim() + lead >= 2
    return out


def grads_of(model, batch, cfg: ModelConfig, remat: bool):
    """(grads, loss, aux): every parameter's gradient by name (zeros where
    the loss does not reach it), in the parameter's type."""
    model.zero_grad(set_to_none=True)
    total, (loss, aux) = loss_fn(model, batch, cfg, remat=remat)
    total.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return grads, loss.detach(), aux.detach()


def _split(batch: Dict[str, torch.Tensor], n: int, i: int):
    return {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    microbatches: int = 1, remat: bool = False):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: gradients of the loss (with ``microbatches`` > 1, each
    microbatch's summed in float32 in order and divided by their number,
    as the reference's ``lax.scan`` does), then one AdamW update of the
    model's parameters and ``opt_state`` in place.  ``metrics``: loss, aux,
    grad_norm and lr as 0-d tensors."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(model, opt_state, batch):
        if microbatches > 1:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in model.named_parameters()}
            dev = next(iter(grads.values())).device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                g, l, a = grads_of(model, _split(batch, microbatches, i),
                                    cfg, remat)
                for n, t in g.items():
                    grads[n].add_(t)
                loss, aux = loss + l, aux + a
            model.zero_grad(set_to_none=True)
            for t in grads.values():
                t.div_(microbatches)
            loss, aux = loss / microbatches, aux / microbatches
        else:
            grads, loss, aux = grads_of(model, batch, cfg, remat)
        params = dict(model.named_parameters())
        _, opt_state, om = adamw.update(grads, opt_state, params, opt_cfg,
                                        decay=decay_mask(params, cfg))
        del grads
        model.zero_grad(set_to_none=True)
        return model, opt_state, {"loss": loss, "aux": aux, **om}

    return train_step
