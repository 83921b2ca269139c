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
  * on a mesh (``ctx``, a ``parallel.MeshCtx``; training and serving)
    each weight is read through ``collectives.weight`` (its FSDP dims
    gathered) and a block runs tensor-parallel over ``model`` where its
    weights are split there (``collectives.tp_region``): column-parallel
    ``wq``/``wk``/``wv``, ``w_gate``/``w_up`` on local heads or columns
    behind ``copy_to``, row-parallel ``wo``/``w_down`` summed by
    ``reduce_from``, the vocabulary split for ``tok`` and ``unembed``;
    elsewhere the weights are gathered whole and the op is the meshless
    one.  A serving cache on a mesh is this rank's shard in the layout
    ``sharding.kv_layout`` gives (``ctx.kv_mode``): split by KV heads, the
    attention runs on the local heads (tensor-parallel) against it; split
    by head dim, or replicated, the attention computes every head (its
    weights gathered whole), writes its part of the new K/V and, split,
    all-gathers the layer's cache before the kernel reads it;
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
from ..parallel import collectives as C
from ..parallel.sharding import kv_layout
from .config import ModelConfig

DECODE_PAGE = 16          # tokens per page of the decode view of a cache


# ---------------------------------------------------------------------------
# Init helpers.
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: Optional[float] = None) -> nn.Parameter:
    """Normal x 1/sqrt(fan_in) (or ``scale``), drawn in float32 on the
    generator's device, cast to ``dtype`` and placed on ``device``; no
    generator: an empty tensor (the meta device's shapes)."""
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
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


def rms_norm_split(x, scale, eps: float, group, d: int):
    """``rms_norm`` of a tensor whose last dim (``d`` wide) is split over
    ``group``: ``x`` and ``scale`` this rank's slices, the sum of squares
    summed over the group."""
    xf = x.float()
    var = C.reduce_shared(xf.square().sum(dim=-1, keepdim=True), group) / d
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


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
              hd: Optional[int] = None,
              ctx=None):
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
    layers.  ``ctx``: the mesh, on which the block runs on its local heads
    when ``wq``/``wk``/``wv`` (columns) and ``wo`` (rows) are split over
    ``model`` at head boundaries and a cache, if any, is split by heads;
    a cache is this rank's shard (``kv_split``).
    """
    B, S, _ = x.shape
    hd = hd or cfg.hd
    tp, cdim = kv_split(ctx, cfg, kv_cache is not None,
                        heads_split(ctx, p, hd))
    col, row = (1, 0) if tp else (None, None)
    if tp:
        group = ctx.group(ctx.tp)
        x = C.copy_to(x, group)
        x_kv = None if x_kv is None else C.copy_to(x_kv, group)
    src = x if x_kv is None else x_kv
    q = x @ C.weight(ctx, p.wq, col)
    k = src @ C.weight(ctx, p.wk, col)
    v = src @ C.weight(ctx, p.wv, col)
    if p.bq is not None:
        q, k, v = (q + C.weight(ctx, p.bq, row), k + C.weight(ctx, p.bk, row),
                   v + C.weight(ctx, p.bv, row))
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
        if cdim is None:
            kc[:, pos] = k[:, 0]
            vc[:, pos] = v[:, 0]
        else:       # write this rank's part, read the layer's whole cache
            tg = ctx.group(ctx.tp)
            kc[:, pos] = C.own_chunk(k[:, 0], cdim - 1, tg)
            vc[:, pos] = C.own_chunk(v[:, 0], cdim - 1, tg)
            kc, vc = C.gathered(kc, cdim, tg), C.gathered(vc, cdim, tg)
        Bc, max_len = kc.shape[:2]
        table, lengths = pages if pages is not None else decode_pages(
            Bc, max_len, pos, x.device)
        pool = (Bc * max_len // DECODE_PAGE, DECODE_PAGE, KV, hd)
        out = paged_decode_attention(q, kc.view(pool), vc.view(pool), table,
                                     lengths, softcap=cfg.logit_softcap)
        out = out.reshape(B, S, H * hd) @ C.weight(ctx, p.wo, row)
        return (C.reduce_from(out, group) if tp else out), kv_cache

    new_cache = None
    if kv_cache is not None:
        new_cache = {"k": k, "v": v} if cdim is None else {
            "k": C.own_chunk(k, cdim, ctx.group(ctx.tp)),
            "v": C.own_chunk(v, cdim, ctx.group(ctx.tp))}
    attend = flash_attention_trainable if torch.is_grad_enabled() \
        else flash_attention
    out = attend(q, k, v, causal=causal, softcap=cfg.logit_softcap)
    out = out.reshape(B, S, H * hd) @ C.weight(ctx, p.wo, row)
    if tp:
        out = C.reduce_from(out, group)
    return out, new_cache


def heads_split(ctx, p: Attention, hd: int) -> bool:
    """Whether ``p``'s weights are split over ``model`` at head
    boundaries (columns of ``wq``/``wk``/``wv``, rows of ``wo``)."""
    return C.tp_region(ctx, (p.wq, 1), (p.wk, 1), (p.wv, 1), (p.wo, 0),
                       (p.bq, 0), (p.bk, 0), (p.bv, 0)) \
        and p.wq.shape[1] % hd == 0 and p.wk.shape[1] % hd == 0


def kv_split(ctx, cfg: ModelConfig, cached: bool, tp_ok: bool):
    """(tp, cdim) of an attention on a mesh: whether it runs on its local
    heads (``tp_ok``: its weights allow it; a cache, if ``cached``, split
    by heads too), and the dim of a (B, T, KV, hd) cache that is split
    over ``model`` while the attention computes every head (2 for heads,
    3 for the head dim), else None."""
    if not cached or ctx is None or not ctx.active or ctx.tp_size == 1:
        return tp_ok, None
    layout = kv_layout(cfg, ctx.kv_mode, ctx.tp_size)
    if tp_ok and layout == "heads":
        return True, None
    return False, {"heads": 2, "head_dim": 3}.get(layout)


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


def mlp(p: MLP, x, cfg: ModelConfig, ctx=None):
    """The FFN; on a mesh column-parallel ``w_gate``/``w_up`` (``b_up``)
    and row-parallel ``w_down`` where they are split over ``model``."""
    b_up = getattr(p, "b_up", None)
    tp = C.tp_region(ctx, (p.w_gate, 1), (p.w_up, 1), (b_up, 0),
                     (p.w_down, 0))
    col, row = (1, 0) if tp else (None, None)
    if tp:
        group = ctx.group(ctx.tp)
        x = C.copy_to(x, group)
    w_up, w_down = C.weight(ctx, p.w_up, col), C.weight(ctx, p.w_down, row)
    if p.w_gate is not None:
        g = x @ C.weight(ctx, p.w_gate, col)
        out = (silu(g) * (x @ w_up)) @ w_down
        return C.reduce_from(out, group) if tp else out
    h = F.gelu(x @ w_up + C.weight(ctx, b_up, row),
               approximate="tanh")                       # jax.nn.gelu
    out = h @ w_down
    if tp:
        out = C.reduce_from(out, group)
    return out + p.b_down


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


def embed(p: Embed, tokens, ctx=None):
    """Token rows of ``tok``; on a mesh with the vocabulary split over
    ``model``, each rank looks up the tokens of its rows (zeros for the
    others) and the ranks' rows are summed."""
    if not C.tp_region(ctx, (p.tok, 0)):
        return C.weight(ctx, p.tok)[tokens]
    w = C.weight(ctx, p.tok, 0)
    n = w.shape[0]
    local = tokens - ctx.coord(ctx.tp) * n
    inside = (local >= 0) & (local < n)
    rows = w[local.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return C.reduce_from(rows, ctx.group(ctx.tp))


def unembed(p: Embed, x, ctx=None):
    """Float32 logits; on a mesh with the vocabulary split over ``model``,
    each rank's columns all-gathered (the gradient keeps its own)."""
    tied = p.unembed is None
    tp = C.tp_region(ctx, (p.tok, 0) if tied else (p.unembed, 1))
    if not tp:
        w = C.weight(ctx, p.tok).T if tied else C.weight(ctx, p.unembed)
        return (x @ w).float()
    group = ctx.group(ctx.tp)
    w = C.weight(ctx, p.tok, 0).T if tied else C.weight(ctx, p.unembed, 1)
    logits = (C.copy_to(x, group) @ w).float()
    return C.gather(logits, logits.dim() - 1, group, grad="slice")
