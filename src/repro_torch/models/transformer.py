"""Model assembly (the port of the JAX package's ``models/transformer.py``)
for the dense, ssm and hybrid families.

Public API, as in the reference, with a :class:`Transformer` module in the
place of the parameter tree:
    init_params(generator, cfg, device=None)         -> Transformer
    train_logits(model, batch, cfg)                  -> (logits, aux)
    prefill(model, batch, cfg, max_len)              -> (logits, cache)
    decode_step(model, tokens, cache, pos, cfg)      -> (logits, cache)
    init_cache(cfg, batch, max_len, device=None)     -> cache

Caches keep the reference's layout:
  * dense: ``{"kv": {"k": (L, B, max_len, KV, hd), "v": ...}}``;
  * ssm: ``{"state": (L, B, h, hp, n) float32, "conv_x": (L, B, K-1, di),
    "conv_bc": (L, B, K-1, 2gn)}``;
  * hybrid: ``(mstack, {"kv": {"k", "v"}})`` with the ssm leaves stacked
    ``(n_super, attn_every, B, ...)`` and one KV cache per application of
    the shared attention block, ``(n_super, B, max_len, KV, hd)``.
``prefill`` allocates the cache (KV at its padded length) and fills it
(the reference pads each layer's K/V and stacks them; the values are the
same); ``decode_step`` updates it in place and returns it.  Entry points
run on the CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from .._device import resolve_device
from . import layers as L
from .config import ModelConfig
from .mamba2 import MambaBlock, init_mamba_cache, mamba_block

_TODO = {
    "moe": "ROADMAP A10 (moe.py)",
    "encdec": "ROADMAP A10 (encoder and cross-attention)",
    "vlm": "ROADMAP A10 (vision tower)",
}


def require_ported(cfg: ModelConfig) -> ModelConfig:
    """``cfg``, validated; raises for the families the port lacks."""
    cfg = cfg.validate()
    if cfg.family in _TODO:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet: "
            f"{_TODO[cfg.family]}")
    return cfg


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, gen, device=device)
        self.norm2 = L.RMSNorm(cfg.d_model, device=device)
        self.mlp = L.MLP(cfg, gen, device=device)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        self.norm = L.RMSNorm(cfg.d_model, device=device)
        self.mamba = MambaBlock(cfg, gen, device=device)


class Transformer(nn.Module):
    """Embedding, the blocks and the final norm, with random weights drawn
    from ``generator`` (default: seed 0 on the model's device).  The
    parameter names follow the JAX tree with the stacked layer axes split:
    ``blocks.{i}.attn.wq`` is ``params["blocks"]["attn"]["wq"][i]``
    (dense), ``blocks.{i}.mamba.x_proj`` likewise (ssm); the hybrid's
    ``blocks.{s}.{j}.mamba.x_proj`` is ``params["blocks"]["mamba"]
    ["x_proj"][s, j]`` for super-block ``s`` and its ``j``-th Mamba2 layer,
    and its one shared attention block is ``shared.*``."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        cfg = require_ported(cfg)
        dev = resolve_device(device, "Transformer")
        gen = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.embed = L.Embed(cfg, gen, device=dev)
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        if cfg.family == "dense":
            self.blocks = nn.ModuleList(
                DenseBlock(cfg, gen, device=dev)
                for _ in range(cfg.n_layers))
        elif cfg.family == "ssm":
            self.blocks = nn.ModuleList(
                SSMBlock(cfg, gen, device=dev) for _ in range(cfg.n_layers))
        else:
            self.blocks = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, gen, device=dev)
                              for _ in range(cfg.attn_every))
                for _ in range(cfg.n_layers // cfg.attn_every))
            self.shared = DenseBlock(cfg, gen, device=dev)


def init_params(generator: Union[int, torch.Generator], cfg: ModelConfig, *,
                device=None) -> Transformer:
    """A :class:`Transformer` with weights from ``generator`` (a
    ``torch.Generator``, or an int seed for one on ``device``)."""
    if isinstance(generator, int):
        generator = torch.Generator(
            device=resolve_device(device, "init_params")).manual_seed(
                generator)
    return Transformer(cfg, generator=generator, device=device)


# ---------------------------------------------------------------------------
# Block application and forward passes.
# ---------------------------------------------------------------------------

def _dense_block(p: DenseBlock, x, cfg: ModelConfig, *, cache=None,
                 pos=None, rope=None, pages=None):
    """Attention + MLP block.  Returns (x, new_kv) as ``L.attention``."""
    h, kv_new = L.attention(p.attn, L.rms_norm(x, p.norm1, cfg.norm_eps),
                            cfg, kv_cache=cache, pos=pos, rope=rope,
                            pages=pages)
    x = x + h
    return x + L.mlp(p.mlp, L.rms_norm(x, p.norm2, cfg.norm_eps), cfg), \
        kv_new


def _ssm_block(p: SSMBlock, x, cfg: ModelConfig, *, cache=None, pos=None):
    h, _ = mamba_block(p.mamba, L.rms_norm(x, p.norm, cfg.norm_eps), cfg,
                       cache=cache, pos=pos)
    return x + h


def _layer(tree, *index):
    """The views of one layer's leaves in a stacked ssm cache."""
    return {k: v[index] for k, v in tree.items()}


def _forward(model: Transformer, batch, cfg: ModelConfig, make_cache: bool,
             max_len: Optional[int] = None, last_only: bool = False):
    x = L.embed(model.embed, batch["tokens"])
    B, S, _ = x.shape
    cache = init_cache(cfg, B, max(S, max_len or S), device=x.device) \
        if make_cache else None
    rope = None if cfg.family == "ssm" else L.rope_tables(
        torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    if cfg.family == "dense":
        for i, blk in enumerate(model.blocks):
            x, kv = _dense_block(blk, x, cfg,
                                 cache={} if make_cache else None, rope=rope)
            if make_cache:
                cache["kv"]["k"][i, :, :S] = kv["k"]
                cache["kv"]["v"][i, :, :S] = kv["v"]
    elif cfg.family == "ssm":
        for i, blk in enumerate(model.blocks):
            x = _ssm_block(blk, x, cfg,
                           cache=_layer(cache, i) if make_cache else None)
    else:
        mstack, kvs = cache if make_cache else (None, None)
        for s, sup in enumerate(model.blocks):
            for j, blk in enumerate(sup):
                x = _ssm_block(blk, x, cfg, cache=_layer(mstack, s, j)
                               if make_cache else None)
            x, kv = _dense_block(model.shared, x, cfg,
                                 cache={} if make_cache else None, rope=rope)
            if make_cache:
                kvs["kv"]["k"][s, :, :S] = kv["k"]
                kvs["kv"]["v"][s, :, :S] = kv["v"]
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model.embed, x), cache


@torch.no_grad()
def train_logits(model: Transformer, batch, cfg: ModelConfig):
    """Full-sequence logits (float32) and the auxiliary loss (0 for the
    ported families).  Forward only: training is not ported yet."""
    logits, _ = _forward(model, batch, require_ported(cfg),
                         make_cache=False)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


@torch.no_grad()
def prefill(model: Transformer, batch, cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Last-position logits (B, vocab) and the cache padded to
    ``max_len``.  Only the last position is unembedded; the reference
    unembeds every position and keeps the last."""
    logits, cache = _forward(model, batch, require_ported(cfg),
                             make_cache=True, max_len=max_len,
                             last_only=True)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(model: Transformer, tokens, cache, pos: int,
                cfg: ModelConfig):
    """tokens: (B, 1); pos: the write position (a Python int)."""
    x = L.embed(model.embed, tokens)
    B = x.shape[0]
    pos = int(pos)
    if cfg.family == "ssm":
        for i, blk in enumerate(model.blocks):
            x = _ssm_block(blk, x, cfg, cache=_layer(cache, i), pos=pos)
    else:
        kv = cache["kv"] if cfg.family == "dense" else cache[1]["kv"]
        kc, vc = kv["k"], kv["v"]
        rope = L.rope_tables(torch.full((1,), pos, device=x.device), cfg.hd,
                             cfg.rope_theta)
        pages = L.decode_pages(B, kc.shape[2], pos, x.device)
        if cfg.family == "dense":
            for i, blk in enumerate(model.blocks):
                x, _ = _dense_block(blk, x, cfg,
                                    cache={"k": kc[i], "v": vc[i]}, pos=pos,
                                    rope=rope, pages=pages)
        else:
            for s, sup in enumerate(model.blocks):
                for j, blk in enumerate(sup):
                    x = _ssm_block(blk, x, cfg, cache=_layer(cache[0], s, j),
                                   pos=pos)
                x, _ = _dense_block(model.shared, x, cfg,
                                    cache={"k": kc[s], "v": vc[s]}, pos=pos,
                                    rope=rope, pages=pages)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model.embed, x)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    cfg = require_ported(cfg)
    dev = resolve_device(device, "init_cache")
    dt = cfg.torch_dtype

    def kv(n: int):
        shape = (n, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"kv": {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}}

    def stacked(*lead):
        return {k: torch.zeros(lead + v.shape, dtype=v.dtype, device=dev)
                for k, v in init_mamba_cache(cfg, batch,
                                             device="meta").items()}

    if cfg.family == "dense":
        return kv(cfg.n_layers)
    if cfg.family == "ssm":
        return stacked(cfg.n_layers)
    n_super = cfg.n_layers // cfg.attn_every
    return stacked(n_super, cfg.attn_every), kv(n_super)
