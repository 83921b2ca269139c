"""Mamba2 (SSD) block: projections -> causal depthwise conv -> SSD -> gated
out (the port of the JAX package's ``models/mamba2.py``).

Used standalone for ``mamba2-1.3b`` and as the backbone block of the
``zamba2`` hybrid.  The projections are split per stream (``z_proj``,
``x_proj``, ``bc_proj``, ``dt_proj``) as in the reference.  Training and
prefill run the SSD scan through the autograd Function
``kernels.ssd_scan.ops.SSD`` (forward ``ops.ssd``, backward
``ops.ssd_backward``: the CUDA kernels on the card, their plain versions
on the CPU); decode runs the one-token recurrence ``ssd_decode_step`` as
torch ops, as the reference does.

On a mesh (``ctx``; training and serving) the block runs on its local
heads where ``z_proj``, ``x_proj``, ``conv_x`` (channels) and
``out_proj`` (rows) are split over ``model`` at head boundaries: the
replicated ``bc_proj`` and ``dt_proj`` streams are computed whole, their
heads (``dt``, ``A``, ``D``) and groups sliced, B and C read through
``copy_to`` (one group) or sliced (groups split evenly), the gate norm
taken over the whole ``d_inner`` (its sum of squares summed over
``model``) and ``out_proj``'s partial rows summed by ``reduce_from``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd_scan.ops import SSD
from ..kernels.ssd_scan.ref import ssd_decode_step
from ..parallel import collectives as C
from .config import ModelConfig
from .layers import (RMSNorm, _dense_init, _zeros, rms_norm, rms_norm_split,
                     silu)

Cache = Dict[str, torch.Tensor]


class MambaBlock(nn.Module):
    """The JAX parameter names; ``A_log``, ``D``, ``dt_bias`` and the gate
    norm's scale are float32, every other weight ``cfg.torch_dtype``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        gn2, h, K = 2 * cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_conv
        dt, f32 = cfg.torch_dtype, torch.float32
        self.z_proj = _dense_init(gen, (d, di), dt, device)
        self.x_proj = _dense_init(gen, (d, di), dt, device)
        self.bc_proj = _dense_init(gen, (d, gn2), dt, device)
        self.dt_proj = _dense_init(gen, (d, h), dt, device)
        self.conv_x_w = _dense_init(gen, (K, di), dt, device, scale=0.5)
        self.conv_x_b = _zeros(di, dt, device)
        self.conv_bc_w = _dense_init(gen, (K, gn2), dt, device, scale=0.5)
        self.conv_bc_b = _zeros(gn2, dt, device)
        self.A_log = _zeros(h, f32, device)
        self.D = nn.Parameter(torch.ones(h, dtype=f32, device=device))
        self.dt_bias = _zeros(h, f32, device)
        self.gate_norm = RMSNorm(di, device=device)
        self.out_proj = _dense_init(gen, (di, d), dt, device)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))         # jax.nn.softplus


def _causal_conv(u, w, b):
    """Depthwise causal conv along the sequence: u (B, S, C), w (K, C).  The
    K-shifted sum of the reference, rounded per term as it rounds, and no
    cuDNN convolution (which would run float32 in TF32 on the card)."""
    K, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = pad[:, :S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _conv_step(win, w, b):
    """One conv output from a (B, K, C) window: exact products, float32
    sum, one rounding (the reference's einsum ``bkc,kc->bc``)."""
    return (win.float() * w.float()).sum(dim=1).to(win.dtype) + b


def mamba_block(p: MambaBlock, x, cfg: ModelConfig,
                cache: Optional[Cache] = None, pos: Optional[int] = None,
                ctx=None, sp: Optional[C.SeqShard] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, D).  Training/prefill when ``pos`` is None; decode
    otherwise.

    cache = {"state": (B, h, hp, n) float32, "conv_x": (B, K-1, di),
    "conv_bc": (B, K-1, 2gn)}.  With a cache, prefill starts from its state
    and writes the final state and the last K-1 raw conv inputs into it;
    decode takes one token against it and updates the state and the conv
    windows.  Both update the cache in place and return it (the reference
    returns a new one with the same values).  ``ctx``: the mesh, where a
    cache is this rank's shard: its heads (``state``) and channels
    (``conv_x``) split over ``model`` as the block's tensor-parallel
    region splits them.  ``sp``: ``x`` is this rank's rows of the sequence
    (sequence parallelism), gathered at entry (its gradient this rank's
    rows: the whole projections read it too, and ``copy_to`` sums the
    tensor-parallel ones), and so is the result."""
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    hp, K = cfg.ssm_head_dim, cfg.ssm_conv
    tp = C.tp_region(ctx, (p.z_proj, 1), (p.x_proj, 1), (p.conv_x_w, 1),
                     (p.conv_x_b, 0), (p.out_proj, 0)) \
        and h % ctx.tp_size == 0 and (g == 1 or g % ctx.tp_size == 0)
    col, row = (1, 0) if tp else (None, None)
    if sp is not None:
        x = sp.enter(x, tp, mixed=True)
    B, S, _ = x.shape
    xt = x
    if tp:
        group = ctx.group(ctx.tp)
        xt = C.copy_to(x, group)
        h = h // ctx.tp_size
    if cache is not None and cache["state"].shape[1] != h:
        raise NotImplementedError(
            f"a cache of {cache['state'].shape[1]} heads for a block of "
            f"{h}: the cache is split over model where the block is not")

    z = xt @ C.weight(ctx, p.z_proj, col)
    xr = xt @ C.weight(ctx, p.x_proj, col)
    bc = x @ C.weight(ctx, p.bc_proj)
    dtp = x @ C.weight(ctx, p.dt_proj)
    A = -torch.exp(p.A_log)

    if pos is None:
        xc = silu(_causal_conv(xr, C.weight(ctx, p.conv_x_w, col),
                               C.weight(ctx, p.conv_x_b, row)))
        bcc = silu(_causal_conv(bc, C.weight(ctx, p.conv_bc_w),
                                C.weight(ctx, p.conv_bc_b)))
        xs = xc.reshape(B, S, h, hp)
        Bm = bcc[..., :g * n].reshape(B, S, g, n)          # strided views
        Cm = bcc[..., g * n:].reshape(B, S, g, n)
        dtv = _softplus(dtp.float() + p.dt_bias)
        Dv = p.D
        if tp:
            dtv, A, Dv = (C.split(dtv, 2, group), C.split(A, 0, group),
                          C.split(Dv, 0, group))
            Bm, Cm = ((C.copy_to(Bm, group), C.copy_to(Cm, group)) if g == 1
                      else (C.split(Bm, 2, group), C.split(Cm, 2, group)))
        init = None if cache is None else cache["state"]
        # the Function's backward writes dense dB and dC; autograd places
        # them into bcc's gradient through the views
        y, state = SSD.apply(xs, dtv, A, Bm, Cm, init, cfg.ssm_chunk)
        y = (y + xs * Dv[None, None, :, None]).reshape(B, S, h * hp)
        if cache is not None:
            cache["state"].copy_(state)
            cache["conv_x"].copy_(F.pad(xr, (0, 0, K - 1, 0))[:, -(K - 1):])
            cache["conv_bc"].copy_(
                F.pad(bc, (0, 0, K - 1, 0))[:, -(K - 1):])
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per step, got {S}")
        win_x = torch.cat([cache["conv_x"], xr], dim=1)
        win_bc = torch.cat([cache["conv_bc"], bc], dim=1)
        xc = silu(_conv_step(win_x, C.weight(ctx, p.conv_x_w, col),
                             C.weight(ctx, p.conv_x_b, row)))
        bcc = silu(_conv_step(win_bc, C.weight(ctx, p.conv_bc_w),
                              C.weight(ctx, p.conv_bc_b)))
        xs = xc.reshape(B, h, hp)
        Bm = bcc[:, :g * n].reshape(B, g, n)
        Cm = bcc[:, g * n:].reshape(B, g, n)
        dtv = _softplus(dtp[:, 0].float() + p.dt_bias)
        Dv = p.D
        if tp:
            dtv, A, Dv = (C.split(dtv, 1, group), C.split(A, 0, group),
                          C.split(Dv, 0, group))
            if g > 1:
                Bm, Cm = C.split(Bm, 1, group), C.split(Cm, 1, group)
        y_t, state = ssd_decode_step(cache["state"], xs, dtv, A, Bm, Cm)
        y = (y_t + xs * Dv[None, :, None]).reshape(B, 1, h * hp)
        cache["state"].copy_(state)
        cache["conv_x"].copy_(win_x[:, 1:])
        cache["conv_bc"].copy_(win_bc[:, 1:])

    y = y.to(x.dtype)
    if tp:
        y = rms_norm_split(y * silu(z), C.split(p.gate_norm.scale, 0, group),
                           cfg.norm_eps, group, di)
        out = y @ C.weight(ctx, p.out_proj, row)
        out = sp.exit(out, True) if sp is not None else \
            C.reduce_from(out, group)
        return out.to(x.dtype), cache
    y = rms_norm(y * silu(z), p.gate_norm, cfg.norm_eps)
    out = (y @ C.weight(ctx, p.out_proj)).to(x.dtype)
    return (out if sp is None else sp.exit(out, False)), cache


def init_mamba_cache(cfg: ModelConfig, batch: int, *, device=None) -> Cache:
    di, g, n, K = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    return {
        "state": torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, n,
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros(batch, K - 1, di, dtype=cfg.torch_dtype,
                              device=device),
        "conv_bc": torch.zeros(batch, K - 1, 2 * g * n,
                               dtype=cfg.torch_dtype, device=device),
    }
