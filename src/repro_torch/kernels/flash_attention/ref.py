"""Plain PyTorch versions of the flash attention kernels.

The formula of the JAX package's ``flash_attention_reference``, in the
model layout of ``ops.flash_attention``: float32 scores and softmax over
the whole (S, T) block, GQA by repeating each KV head over its group,
queries right-aligned to the key timeline.  As in the kernels (the Pallas
one and this port's), the unnormalized probabilities are rounded to the
value type before the product with V and the sum is divided out after it;
in float32 that rounding is the identity.

:func:`flash_attention_backward_reference` is the gradient of the same
attention from the forward's output and its per-row log-sum-exp, the
formula of the backward kernels in ``csrc/flash_attention_bwd.cu``:
``P = exp(s - lse)``, ``dV = P^T dO``, ``dS = P * (dO V^T - D)`` with
``D = rowsum(dO * O)``, times ``1 - tanh^2`` at the capped score under a
softcap, ``dQ = dS K * scale`` and ``dK = dS^T Q * scale``, summed over
each KV head's group.  The forward's rounding of P to the value type is
passed straight through (its gradient is the identity).
"""

from __future__ import annotations

import math

import torch


def _expand(x, G: int):
    """(B, T, KV, hd) -> float32 (B, H, T, hd), each KV head repeated over
    its group of G query heads."""
    return x.float().repeat_interleave(G, dim=2).transpose(1, 2)


def _live(S: int, T: int, causal: bool, device):
    """(S, T) mask of the (query, key) pairs attention keeps, or None."""
    if not causal:
        return None
    qpos = torch.arange(S, device=device)[:, None] + (T - S)
    return torch.arange(T, device=device)[None, :] <= qpos


def _capped(s, softcap: float):
    return softcap * torch.tanh(s / softcap) if softcap > 0.0 else s


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              softcap: float = 0.0,
                              return_lse: bool = False):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) -> (B, S, H, hd) in q's type,
    and with ``return_lse`` also each query row's log-sum-exp of its
    scores, float32 (B, H, S)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().transpose(1, 2)                         # (B, H, S, hd)
    kf, vf = _expand(k, G), _expand(v, G)
    s = _capped((qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(hd)), softcap)
    live = _live(S, T, causal, q.device)
    if live is not None:
        s = torch.where(live, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (p.to(v.dtype).float() @ vf) / l
    out = out.to(q.dtype).transpose(1, 2).contiguous()
    if not return_lse:
        return out
    return out, (m + torch.log(l))[..., 0]


def flash_attention_backward_reference(q, k, v, out, lse, dout, *,
                                       causal: bool = True,
                                       softcap: float = 0.0):
    """(dq, dk, dv) of :func:`flash_attention_reference` from its output
    ``out`` (B, S, H, hd), its log-sum-exp ``lse`` (B, H, S) and the
    output's gradient ``dout``, each in its input's type."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().transpose(1, 2)
    kf, vf = _expand(k, G), _expand(v, G)
    dof = dout.float().transpose(1, 2)
    u = (qf @ kf.transpose(-1, -2)) * scale
    c = _capped(u, softcap)
    p = torch.exp(c - lse.float()[..., None])
    live = _live(S, T, causal, q.device)
    if live is not None:
        p = torch.where(live, p, torch.zeros_like(p))
    dsum = (dof * out.float().transpose(1, 2)).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - dsum)
    if softcap > 0.0:
        ds = ds * (1.0 - (c / softcap).square())
    ds = ds * scale
    dq = ds @ kf
    dk = (ds.transpose(-1, -2) @ qf).view(B, KV, G, T, hd).sum(dim=2)
    dv = (p.transpose(-1, -2) @ dof).view(B, KV, G, T, hd).sum(dim=2)
    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous())
