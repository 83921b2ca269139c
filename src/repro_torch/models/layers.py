"""Shared model building blocks (the port of the JAX package's
``models/layers.py``).

Conventions:
  * parameters live in ``nn.Module``s whose attribute names are the JAX
    parameter tree's keys (``attn.wq``, ``mlp.w_gate``, ``norm1.scale``),
    and matrices keep the JAX orientation (``x @ W``, ``W`` of shape
    ``(d_in, d_out)``), so carrying weights across is a copy;
  * the functions (``attention(p, x, cfg)``, ``mlp(p, x, cfg)``, ...) take
    such a module as ``p`` and compute what their JAX namesakes compute, in
    ``cfg.torch_dtype`` with float32 islands for norms, softmax and rope;
  * parameters take gradients; serving runs under ``torch.no_grad()``
    (``prefill``, ``decode_step``), where attention calls the forward
    kernel alone, and with gradients enabled it goes through the
    autograd Function of ``kernels/flash_attention/ops.py`` (the forward
    kernel with its log-sum-exp, then the backward kernels);
  * KV caches are dicts ``{"k": (B, max_len, KV, hd), "v": ...}`` per
    layer.  Decode writes the new token's K/V into the cache in place (the
    JAX code returns an updated copy; the values are the same) and reads it
    through the paged attention kernel, with the dense cache viewed as a
    page pool under an identity block table.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention.ops import (flash_attention,
                                           flash_attention_trainable)
from ..kernels.paged_attention.ops import paged_decode_attention
from .config import ModelConfig

DECODE_PAGE = 16          # tokens per page of the decode view of a cache


# ---------------------------------------------------------------------------
# Init helpers.
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: Optional[float] = None) -> nn.Parameter:
    """Normal x 1/sqrt(fan_in) (or ``scale``), drawn in float32 on the
    generator's device, cast to ``dtype`` and placed on ``device``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else float(1.0 / np.sqrt(fan_in))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return nn.Parameter(w.to(device=device, dtype=dtype))


def _zeros(n: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=dtype, device=device))


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device))


def rms_norm(x, p: RMSNorm, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves, float32).
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def rope_tables(positions, hd: int, theta: float):
    """(C, S), each (..., S, 1, hd) float32: C = [cos, cos] and
    S = [-sin, sin] over the two halves of the head dim, so that
    ``x * C + swap_halves(x) * S`` is the split-halves rotation
    ``[x1 cos - x2 sin, x2 cos + x1 sin]`` rounded as the reference rounds
    it.  A forward pass builds them once for all its layers."""
    ang = positions.float()[..., None] * rope_freqs(hd, theta,
                                                    positions.device)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def _rotate(x, rope):
    C, S = rope
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * C + torch.cat([x2, x1], dim=-1) * S).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return _rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Attention (GQA, optional QKV bias and softcap, KV cache).
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = cfg.torch_dtype
        self.wq = _dense_init(gen, (d, h * hd), dt, device)
        self.wk = _dense_init(gen, (d, kv * hd), dt, device)
        self.wv = _dense_init(gen, (d, kv * hd), dt, device)
        self.wo = _dense_init(gen, (h * hd, d), dt, device)
        for name, n in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            self.register_parameter(
                name, _zeros(n, dt, device) if cfg.qkv_bias else None)


def decode_pages(batch: int, max_len: int, pos: int, device):
    """The page view of a dense per-slot decode cache: an identity block
    table (row b holds pages b * n_pages ...) and every row's length
    ``pos + 1``, the JAX decode mask ``kpos <= pos``."""
    if max_len % DECODE_PAGE:
        raise ValueError(f"decode cache length {max_len} is not a multiple "
                         f"of the {DECODE_PAGE}-token decode page")
    n_pages = max_len // DECODE_PAGE
    table = torch.arange(batch * n_pages, dtype=torch.int32,
                         device=device).view(batch, n_pages)
    lengths = torch.full((batch,), pos + 1, dtype=torch.int32, device=device)
    return table, lengths


def attention(p: Attention, x, cfg: ModelConfig, *,
              positions=None,
              kv_cache: Optional[Dict[str, torch.Tensor]] = None,
              pos: Optional[int] = None,
              causal: bool = True,
              rope=None,
              pages: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              x_kv=None,
              use_rope: bool = True,
              hd: Optional[int] = None):
    """General attention (GQA, optional bias and softcap).

    * training / prefill (``pos`` None): the flash attention kernel over the
      fresh keys; with ``kv_cache`` given (any dict) the fresh,
      unexpanded K/V come back as the new cache.
    * cross-attention: K/V come from ``x_kv`` (the encoder's states), with
      no rope; pass ``causal=False``.
    * decode (``kv_cache`` and ``pos``): ``x`` is (B, 1, D); its K/V are
      written at ``pos`` into the cache in place, and the token attends over
      positions ``<= pos`` through the paged attention kernel.

    Rope applies unless ``use_rope`` is false or ``x_kv`` is given.
    ``hd`` overrides ``cfg.hd`` (an encoder's or the vision tower's head
    dim).  ``rope`` (:func:`rope_tables` of the positions, at this head
    dim) and ``pages`` (:func:`decode_pages`' table and lengths) are built
    here when not given; a forward pass builds them once for all its
    layers.
    """
    B, S, _ = x.shape
    src = x if x_kv is None else x_kv
    q = x @ p.wq
    k = src @ p.wk
    v = src @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    hd = hd or cfg.hd
    H = q.shape[-1] // hd
    KV = k.shape[-1] // hd
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, src.shape[1], KV, hd)
    v = v.reshape(B, src.shape[1], KV, hd)

    if use_rope and x_kv is None:
        if rope is None:
            if positions is None:
                base = pos if pos is not None else 0
                positions = (base + torch.arange(S, device=x.device)).expand(
                    B, S)
            rope = rope_tables(positions, hd, cfg.rope_theta)
        q = _rotate(q, rope)
        k = _rotate(k, rope)

    if kv_cache is not None and pos is not None:
        if S != 1:
            raise ValueError(f"decode takes one token per step, got {S}")
        kc, vc = kv_cache["k"], kv_cache["v"]
        kc[:, pos] = k[:, 0]
        vc[:, pos] = v[:, 0]
        Bc, max_len = kc.shape[:2]
        table, lengths = pages if pages is not None else decode_pages(
            Bc, max_len, pos, x.device)
        pool = (Bc * max_len // DECODE_PAGE, DECODE_PAGE, KV, hd)
        out = paged_decode_attention(q, kc.view(pool), vc.view(pool), table,
                                     lengths, softcap=cfg.logit_softcap)
        return out.reshape(B, S, H * hd) @ p.wo, kv_cache

    new_cache = {"k": k, "v": v} if kv_cache is not None else None
    attend = flash_attention_trainable if torch.is_grad_enabled() \
        else flash_attention
    out = attend(q, k, v, causal=causal, softcap=cfg.logit_softcap)
    return out.reshape(B, S, H * hd) @ p.wo, new_cache


# ---------------------------------------------------------------------------
# MLPs.
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        if cfg.mlp == "swiglu":
            self.w_gate = _dense_init(gen, (d, f), dt, device)
            self.w_up = _dense_init(gen, (d, f), dt, device)
            self.w_down = _dense_init(gen, (f, d), dt, device)
        else:
            self.register_parameter("w_gate", None)
            self.w_up = _dense_init(gen, (d, f), dt, device)
            self.b_up = _zeros(f, dt, device)
            self.w_down = _dense_init(gen, (f, d), dt, device)
            self.b_down = _zeros(d, dt, device)


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x), with the sigmoid as XLA expands it,
    1 / (1 + exp(-x)), every step rounded to x's type (in bf16 this differs
    from ``torch.sigmoid``, which rounds once, in about a third of the
    values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(p: MLP, x, cfg: ModelConfig):
    if p.w_gate is not None:
        g = x @ p.w_gate
        return (silu(g) * (x @ p.w_up)) @ p.w_down
    h = F.gelu(x @ p.w_up + p.b_up, approximate="tanh")   # jax.nn.gelu
    return h @ p.w_down + p.b_down


# ---------------------------------------------------------------------------
# Embedding / unembedding.
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        dt = cfg.torch_dtype
        self.tok = _dense_init(gen, (cfg.vocab, cfg.d_model), dt, device,
                               scale=0.02)
        if cfg.tie_embeddings:
            self.register_parameter("unembed", None)
        else:
            self.unembed = _dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                                       device, scale=0.02)


def embed(p: Embed, tokens):
    return p.tok[tokens]


def unembed(p: Embed, x):
    w = p.unembed if p.unembed is not None else p.tok.T
    return (x @ w).float()
