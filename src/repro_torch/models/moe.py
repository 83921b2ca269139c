"""Mixture-of-Experts FFN with capacity dispatch (the port of the JAX
package's ``models/moe.py``, its single-device placement).

Each token's router picks its top-k experts; each (token, choice) pair
takes the next free slot of its expert's buffer of ``C`` slots, in token
order and then choice order, and a pair past the capacity is dropped.  The
experts run as batched products over their (E, C, D) buffers, and each
token sums its kept experts' outputs, weighted by its renormalized router
probabilities.  The reference's ``shard_map`` placements ("tp", "ep") need
``parallel/``, which is not ported yet (ROADMAP A10).

Bit-level choices, so that the port rounds where the reference does:
  * the router runs in float32 (``x.float() @ wg``; TF32 stays off, the
    PyTorch default for matmuls);
  * top-k breaks ties to the lower expert index, as ``jax.lax.top_k`` does
    (a stable descending sort; ``torch.topk`` promises no order);
  * the buffer and the combine are plain assignments and sums, no
    ``index_add_`` (unrepeatable on the card): each kept (expert, slot) has
    exactly one contributor, and the reference's dropped pairs only add
    zeros at slot 0;
  * a token's k weighted rows are summed in choice order from zero in the
    activation type, as the reference's scatter-add adds them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _dense_init, silu


class MoE(nn.Module):
    """The router ``wg`` (D, E) in float32 and the experts' SwiGLU weights
    ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D), drawn as
    ``init_moe`` draws them (``_dense_init``: fan-in the leading axis)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
        dt = cfg.torch_dtype
        self.wg = _dense_init(gen, (D, E), torch.float32, device, scale=0.02)
        self.w_gate = _dense_init(gen, (E, D, Fd), dt, device)
        self.w_up = _dense_init(gen, (E, D, Fd), dt, device)
        self.w_down = _dense_init(gen, (E, Fd, D), dt, device)


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``ceil(T k cf / E)`` rounded up to a multiple of
    8, at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, int(math.ceil(c / 8) * 8))


def _top_k(probs, k: int):
    """(weights, experts) of the k largest probabilities per row, ties to
    the lower expert index (``jax.lax.top_k``'s order)."""
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[:, :k], e[:, :k]


def _dispatch_ffn(x_flat, p: MoE, cfg: ModelConfig):
    """Route T tokens (T, D) through the E experts with capacity dropping;
    returns (y (T, D), aux) with the Switch-style load-balance aux
    ``E * sum_e frac_e * mean_p_e`` over each token's first choice."""
    T, D = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    dev = x_flat.device

    probs = torch.softmax(x_flat.float() @ p.wg, dim=-1)        # (T, E)
    top_w, top_e = _top_k(probs, k)                             # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                  # (T*k,)
    flat_w = top_w.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)

    # each pair's slot in its expert's buffer: the exclusive cumsum of the
    # one-hot over the flat (token, choice) order
    onehot = F.one_hot(flat_e, E)
    slot = (onehot.cumsum(dim=0) - onehot).gather(1, flat_e[:, None])[:, 0]
    keep = slot < C
    slot = torch.where(keep, slot, torch.zeros_like(slot))

    # the (E, C, D) buffer as the first E * C rows of a flat one; dropped
    # pairs write row E * C, which nothing reads
    rows = torch.where(keep, flat_e * C + slot,
                       torch.full_like(slot, E * C))
    buf = x_flat.new_zeros(E * C + 1, D)
    buf[rows] = x_flat[flat_t]
    buf = buf[:E * C].view(E, C, D)

    h = torch.bmm(buf, p.w_gate)                                # (E, C, F)
    u = torch.bmm(buf, p.w_up)
    out = torch.bmm(silu(h) * u, p.w_down)                      # (E, C, D)

    # the weight is cast to the activation type before the product, as the
    # reference casts it
    gathered = out[flat_e, slot] * (flat_w * keep)[:, None].to(out.dtype)
    gathered = gathered.view(T, k, D)
    y = x_flat.new_zeros(T, D)
    for j in range(k):
        y = y + gathered[:, j]

    frac = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    aux = E * (frac * probs.mean(dim=0)).sum()
    return y, aux


def moe_ffn(p: MoE, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux float32 scalar): the reference's
    single-device branch."""
    B, S, D = x.shape
    y, aux = _dispatch_ffn(x.reshape(-1, D), p, cfg)
    return y.reshape(B, S, D), aux
