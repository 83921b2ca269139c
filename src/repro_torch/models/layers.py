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
    one.  Where the query heads split over ``model`` but the K/V heads do
    not (``attn_mode`` "q"), the attention runs on its local query heads
    against the K/V heads they read, computed from ``wk``/``wv`` gathered
    whole.  A serving cache on a mesh is this rank's shard in the layout
    ``sharding.kv_layout`` gives (``ctx.kv_mode``): split by KV heads, the
    attention runs on the local heads against it; split by head dim,
    prefill writes its slice of every head and decode sums each head's
    partial scores over ``model`` (the split mode of ``paged_attention``);
    replicated, decode computes every head;
  * sequence parallelism (``sp``, a ``collectives.SeqShard``): a block's
    input is this rank's rows of the sequence; a tensor-parallel region
    all-gathers the sequence at entry (in the place of ``copy_to``) and
    reduce-scatters it at exit (in the place of ``reduce_from``), a whole
    one gathers and keeps its own rows;
  * KV caches are dicts ``{"k": (B, max_len, KV, hd), "v": ...}`` per
    layer.  Decode writes the new token's K/V into the cache in place (the
    JAX code returns an updated copy; the values are the same) and reads it
    through the paged attention kernel, with the dense cache viewed as a
    page pool under an identity block table.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention.ops import (flash_attention,
                                           flash_attention_trainable)
from ..kernels.paged_attention.ops import (paged_decode_apply,
                                           paged_decode_attention,
                                           paged_decode_scores)
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
    return rms_norm_scaled(x, p.scale, eps)


def rms_norm_scaled(x, scale, eps: float = 1e-5):
    """``rms_norm`` with the scale given as a tensor."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


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
              ctx=None,
              sp: Optional[C.SeqShard] = None):
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
    layers.  ``ctx``: the mesh (:func:`attn_mode`: the block on its local
    query heads, with the K/V heads local too or computed whole; a cache
    is this rank's shard).  ``sp``: ``x`` is this rank's rows of the
    sequence (sequence parallelism), gathered at entry, and the result is
    this rank's rows again.
    """
    hd = hd or cfg.hd
    mode, cdim = attn_mode(ctx, p, cfg, hd, kv_cache is not None,
                           pos is not None)
    qtp = mode is not None
    col, row = (1, 0) if qtp else (None, None)
    kcol, krow = (1, 0) if mode == "heads" else (None, None)
    group = ctx.group(ctx.tp) if qtp else None
    if sp is not None:
        x = sp.enter(x, qtp)
    elif qtp:
        x = C.copy_to(x, group)
    if qtp and x_kv is not None:
        x_kv = C.copy_to(x_kv, group)
    B, S, _ = x.shape
    src = x if x_kv is None else x_kv
    # K/V heads computed whole for local query heads: each rank reads
    # other columns of wk / wv, so their gradients are summed over model
    kv_sum = mode == "q"
    q = x @ C.weight(ctx, p.wq, col)
    k = src @ C.weight(ctx, p.wk, kcol, summed=kv_sum)
    v = src @ C.weight(ctx, p.wv, kcol, summed=kv_sum)
    if p.bq is not None:
        q = q + C.weight(ctx, p.bq, row)
        k = k + C.weight(ctx, p.bk, krow, summed=kv_sum)
        v = v + C.weight(ctx, p.bv, krow, summed=kv_sum)
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
        Bc, max_len = kc.shape[:2]
        table, lengths = pages if pages is not None else decode_pages(
            Bc, max_len, pos, x.device)
        if cdim == 3:   # write this rank's slice, sum the partial scores
            tg = ctx.group(ctx.tp)
            kc[:, pos] = C.own_chunk(k[:, 0], 2, tg)
            vc[:, pos] = C.own_chunk(v[:, 0], 2, tg)
            pool = (Bc * max_len // DECODE_PAGE, DECODE_PAGE) + kc.shape[2:]
            out = split_attend(q, kc.view(pool), vc.view(pool), table,
                               lengths, ctx, qtp, hd, cfg.logit_softcap)
        else:
            if cdim is None:
                kc[:, pos] = k[:, 0]
                vc[:, pos] = v[:, 0]
            else:   # write this rank's heads, read the layer's whole cache
                tg = ctx.group(ctx.tp)
                kc[:, pos] = C.own_chunk(k[:, 0], cdim - 1, tg)
                vc[:, pos] = C.own_chunk(v[:, 0], cdim - 1, tg)
                kc, vc = C.gathered(kc, cdim, tg), C.gathered(vc, cdim, tg)
            pool = (Bc * max_len // DECODE_PAGE, DECODE_PAGE, KV, hd)
            out = paged_decode_attention(q, kc.view(pool), vc.view(pool),
                                         table, lengths,
                                         softcap=cfg.logit_softcap)
        out = out.reshape(B, S, -1) @ C.weight(ctx, p.wo, row)
        return (C.reduce_from(out, group) if qtp else out), kv_cache

    new_cache = None
    if kv_cache is not None:
        new_cache = {"k": k, "v": v} if cdim is None else {
            "k": C.own_chunk(k, cdim, ctx.group(ctx.tp)),
            "v": C.own_chunk(v, cdim, ctx.group(ctx.tp))}
    if mode == "q":
        k, v = _kv_for_heads(k, v, ctx.coord(ctx.tp) * H, H,
                             H * ctx.tp_size // KV)
    attend = flash_attention_trainable if torch.is_grad_enabled() \
        else flash_attention
    out = attend(q, k, v, causal=causal, softcap=cfg.logit_softcap)
    out = out.reshape(B, S, H * hd) @ C.weight(ctx, p.wo, row)
    if sp is not None:
        out = sp.exit(out, qtp)
    elif qtp:
        out = C.reduce_from(out, group)
    return out, new_cache


def _kv_for_heads(k, v, h0: int, n: int, G: int):
    """The K/V heads that query heads ``h0 ... h0 + n - 1`` read (head h
    reads KV head h // G), as a GQA pair for those heads: a run of whole
    groups, one head for all of them, or else one K/V head a query head."""
    lo, hi = h0 // G, (h0 + n - 1) // G + 1
    if (h0 % G == 0 and n % G == 0) or hi - lo == 1:
        return (k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous())
    idx = torch.arange(h0, h0 + n, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def split_attend(q, k_pages, v_pages, table, lengths, ctx, qtp: bool,
                 hd: int, softcap: float = 0.0):
    """Attention of one query a row over paged K/V split over ``model`` by
    head dim (the reference's partial scores): the rank's slice of every
    query head's scores (``paged_decode_scores``) summed over ``model``,
    the softmax and its product with the rank's V slice
    (``paged_decode_apply``), the slices all-gathered.  With ``qtp`` the
    query heads are this rank's (gathered first) and this rank's heads of
    the output come back.  q (B, 1, H or H / tp, hd) -> the same shape."""
    tg = ctx.group(ctx.tp)
    if qtp:
        q = C.gathered(q, 2, tg)
    qs = C.own_chunk(q, 3, tg).contiguous()
    scores = C.summed(paged_decode_scores(qs, k_pages, table, lengths), tg)
    out = paged_decode_apply(scores, v_pages, table, lengths,
                             scale=1.0 / math.sqrt(hd), softcap=softcap)
    out = C.gathered(out, 3, tg)
    return C.own_chunk(out, 2, tg) if qtp else out


def attn_mode(ctx, p: Attention, cfg: ModelConfig, hd: int, cached: bool,
              decode: bool):
    """(mode, cdim) of an attention on a mesh.  ``mode``: "heads" (the
    query and K/V heads this rank's: ``wq``/``wk``/``wv`` split over
    ``model`` at head boundaries, and a cache, if ``cached``, split by
    heads), "q" (the query heads this rank's, ``wq`` and ``wo`` split at
    head boundaries, the K/V heads computed whole from ``wk``/``wv``
    gathered), or None (every head, the weights gathered whole).
    ``cdim``: the dim of a (B, T, KV, hd) cache split over ``model`` that
    the attention does not hold whole (2 for heads, 3 for the head dim),
    else None.  A decode over a replicated cache computes every head, as
    the reference's does."""
    if ctx is None or not ctx.active or ctx.tp_size == 1:
        return None, None
    q_ok = C.tp_region(ctx, (p.wq, 1), (p.wo, 0), (p.bq, 0)) \
        and p.wq.shape[1] % hd == 0
    kv_ok = q_ok and C.tp_region(ctx, (p.wk, 1), (p.wv, 1), (p.bk, 0),
                                 (p.bv, 0)) and p.wk.shape[1] % hd == 0
    if not cached:
        return ("heads" if kv_ok else "q" if q_ok else None), None
    layout = kv_layout(cfg, ctx.kv_mode, ctx.tp_size)
    if layout == "heads":
        return ("heads", None) if kv_ok else (None, 2)
    if decode and layout == "replicate":
        return None, None
    return ("q" if q_ok else None), {"heads": 2, "head_dim": 3}.get(layout)


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


def mlp(p: MLP, x, cfg: ModelConfig, ctx=None,
        sp: Optional[C.SeqShard] = None):
    """The FFN; on a mesh column-parallel ``w_gate``/``w_up`` (``b_up``)
    and row-parallel ``w_down`` where they are split over ``model``;
    ``sp``: ``x`` is this rank's rows of the sequence (see
    :func:`attention`)."""
    b_up = getattr(p, "b_up", None)
    tp = C.tp_region(ctx, (p.w_gate, 1), (p.w_up, 1), (b_up, 0),
                     (p.w_down, 0))
    col, row = (1, 0) if tp else (None, None)
    group = ctx.group(ctx.tp) if tp else None
    if sp is not None:
        x = sp.enter(x, tp)
    elif tp:
        x = C.copy_to(x, group)
    w_up, w_down = C.weight(ctx, p.w_up, col), C.weight(ctx, p.w_down, row)
    if p.w_gate is not None:
        g = x @ C.weight(ctx, p.w_gate, col)
        out = (silu(g) * (x @ w_up)) @ w_down
    else:
        h = F.gelu(x @ w_up + C.weight(ctx, b_up, row),
                   approximate="tanh")                   # jax.nn.gelu
        out = h @ w_down
    if sp is not None:
        out = sp.exit(out, tp)
    elif tp:
        out = C.reduce_from(out, group)
    if p.w_gate is not None:
        return out
    # under sequence parallelism each rank adds the bias to its own rows
    return out + (p.b_down if sp is None else C.copy_to(p.b_down, sp.group))


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
