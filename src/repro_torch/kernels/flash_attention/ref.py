"""Plain PyTorch version of the flash attention kernel.

The formula of the JAX package's ``flash_attention_reference``, in the
model layout of ``ops.flash_attention``: float32 scores and softmax over
the whole (S, T) block, GQA by repeating each KV head over its group,
queries right-aligned to the key timeline.  As in the kernels (the Pallas
one and this port's), the unnormalized probabilities are rounded to the
value type before the product with V and the sum is divided out after it;
in float32 that rounding is the identity.
"""

from __future__ import annotations

import math

import torch


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              softcap: float = 0.0):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) -> (B, S, H, hd) in q's type."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().transpose(1, 2)                         # (B, H, S, hd)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
        kpos = torch.arange(T, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (p.to(v.dtype).float() @ vf) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype).transpose(1, 2).contiguous()
