"""Model assembly (the port of the JAX package's ``models/transformer.py``),
dense family only.

Public API, as in the reference, with a :class:`Transformer` module in the
place of the parameter tree:
    init_params(generator, cfg, device=None)         -> Transformer
    train_logits(model, batch, cfg)                  -> (logits, aux)
    prefill(model, batch, cfg, max_len)              -> (logits, cache)
    decode_step(model, tokens, cache, pos, cfg)      -> (logits, cache)
    init_cache(cfg, batch, max_len, device=None)     -> cache

The cache is the reference's ``{"kv": {"k": (L, B, max_len, KV, hd),
"v": ...}}``.  ``prefill`` allocates it at its padded length and fills
each layer's rows (the reference pads each layer's K/V and stacks them;
the values are the same); ``decode_step`` updates it in place and returns
it.  Entry points run on the CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from .._device import resolve_device
from . import layers as L
from .config import ModelConfig

_TODO = {
    "moe": "ROADMAP A10 (moe.py)",
    "ssm": "ROADMAP A10 and B4 (mamba2.py, ssd_scan)",
    "hybrid": "ROADMAP A10 and B4 (mamba2.py, ssd_scan)",
    "encdec": "ROADMAP A10 (encoder and cross-attention)",
    "vlm": "ROADMAP A10 (vision tower)",
}


def require_dense(cfg: ModelConfig) -> ModelConfig:
    """``cfg``, validated; raises for the families the port lacks."""
    cfg = cfg.validate()
    if cfg.family != "dense":
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


class Transformer(nn.Module):
    """Embedding, ``n_layers`` dense blocks and the final norm, with random
    weights drawn from ``generator`` (default: seed 0 on the model's
    device).  The parameter names follow the JAX tree with the layer axis
    split: ``blocks.{i}.attn.wq`` is ``params["blocks"]["attn"]["wq"][i]``."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        cfg = require_dense(cfg)
        dev = resolve_device(device, "Transformer")
        gen = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.embed = L.Embed(cfg, gen, device=dev)
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, gen, device=dev) for _ in range(cfg.n_layers))


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


def _forward(model: Transformer, batch, cfg: ModelConfig, make_cache: bool,
             max_len: Optional[int] = None, last_only: bool = False):
    x = L.embed(model.embed, batch["tokens"])
    B, S, _ = x.shape
    cache = init_cache(cfg, B, max(S, max_len or S), device=x.device) \
        if make_cache else None
    rope = L.rope_tables(torch.arange(S, device=x.device), cfg.hd,
                         cfg.rope_theta)
    for i, blk in enumerate(model.blocks):
        x, kv = _dense_block(blk, x, cfg, cache={} if make_cache else None,
                             rope=rope)
        if make_cache:
            cache["kv"]["k"][i, :, :S] = kv["k"]
            cache["kv"]["v"][i, :, :S] = kv["v"]
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model.embed, x), cache


@torch.no_grad()
def train_logits(model: Transformer, batch, cfg: ModelConfig):
    """Full-sequence logits (float32) and the auxiliary loss (0 for the
    dense family).  Forward only: training is not ported yet."""
    logits, _ = _forward(model, batch, require_dense(cfg), make_cache=False)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


@torch.no_grad()
def prefill(model: Transformer, batch, cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Last-position logits (B, vocab) and the cache padded to
    ``max_len``.  Only the last position is unembedded; the reference
    unembeds every position and keeps the last."""
    logits, cache = _forward(model, batch, require_dense(cfg),
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
    kc, vc = cache["kv"]["k"], cache["kv"]["v"]
    rope = L.rope_tables(torch.full((1,), pos, device=x.device), cfg.hd,
                         cfg.rope_theta)
    pages = L.decode_pages(B, kc.shape[2], pos, x.device)
    for i, blk in enumerate(model.blocks):
        x, _ = _dense_block(blk, x, cfg, cache={"k": kc[i], "v": vc[i]},
                            pos=pos, rope=rope, pages=pages)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model.embed, x)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    cfg = require_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device, "init_cache")
    return {"kv": {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
                   "v": torch.zeros(shape, dtype=cfg.torch_dtype,
                                    device=dev)}}
