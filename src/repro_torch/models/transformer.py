"""Model assembly (the port of the JAX package's ``models/transformer.py``)
for every family: dense, moe, ssm, hybrid, encdec and vlm.

Public API, as in the reference, with a :class:`Transformer` module in the
place of the parameter tree:
    init_params(generator, cfg, device=None)         -> Transformer
    train_logits(model, batch, cfg, remat=False, ctx=None) -> (logits, aux)
    prefill(model, batch, cfg, max_len, ctx=None)    -> (logits, cache)
    decode_step(model, tokens, cache, pos, cfg, ctx=None) -> (logits, cache)
    init_cache(cfg, batch, max_len, device=None)     -> cache

``batch`` holds ``tokens`` (B, S), and for encdec ``enc_frames`` (B, T_enc,
``frontend_dim or d_model``), for vlm ``patches`` (B, n_patches,
``vision_d_model``).  The vlm's sequence is ``[image, text]``: rope
positions run 0 ... n_patches + S - 1 and decode continues at
``n_patches + S``.  ``aux`` is the sum of the MoE layers' load-balance
terms (0 for the other families).

Caches keep the reference's layout:
  * dense, moe, vlm: ``{"kv": {"k": (L, B, max_len, KV, hd), "v": ...}}``;
  * encdec: that, and ``"cross": {"k": (L, B, enc_seq, KV, hd), "v": ...}``,
    the decoder's cross-attention K/V over the encoder's states, written by
    prefill and read by every decode step (not padded to ``max_len``);
  * ssm: ``{"state": (L, B, h, hp, n) float32, "conv_x": (L, B, K-1, di),
    "conv_bc": (L, B, K-1, 2gn)}``;
  * hybrid: ``(mstack, {"kv": {"k", "v"}})`` with the ssm leaves stacked
    ``(n_super, attn_every, B, ...)`` and one KV cache per application of
    the shared attention block, ``(n_super, B, max_len, KV, hd)``.
``prefill`` allocates the cache (KV at its padded length) and fills it
(the reference pads each layer's K/V and stacks them; the values are the
same); ``decode_step`` updates it in place and returns it.  Every
attention, the encoders' and the cross-attention's included, runs the
``flash_attention`` kernel in prefill; decode self-attention runs
``paged_attention`` and decode cross-attention ``flash_attention`` (one
query over the encoder's keys).  Entry points run on the CUDA card unless
given ``device="cpu"``.

``train_logits`` takes gradients: its attention goes through the flash
kernels' autograd Function (forward with log-sum-exp, backward kernels),
its Mamba2 layers through ``ssd_scan``'s (forward kernel, backward
kernel), and ``remat`` recomputes each layer's block in the backward pass
(``torch.utils.checkpoint``; the reference's ``jax.checkpoint`` on its
layer-scan body): a dense layer, a Mamba2 block, or the hybrid's
super-block (its Mamba2 layers and the shared attention block's
application).  On a mesh (``ctx``, a ``parallel.MeshCtx``) the batch is
this rank's data shard and every block reads its weights through
``parallel.collectives`` (FSDP gathers, tensor-parallel regions; see
``layers``); with ``ctx.sequence_parallel`` training and prefill keep
the residual stream between the blocks as this rank's rows of the
sequence (``_seq_shard``; decode never does), each block's regions
gathering the sequence at entry and reduce-scattering it at exit.
``prefill`` and ``decode_step`` run under
``torch.no_grad()``; on a mesh their batch, tokens and cache are this
rank's shards (the cache split over ``model`` as
``parallel.sharding.kv_cache_pspecs`` splits it), and at a mesh of one
rank they are the meshless path bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..parallel import collectives as C
from ..parallel import sharding as shard_rules
from . import layers as L
from .config import ModelConfig
from .mamba2 import MambaBlock, init_mamba_cache, mamba_block
from .moe import MoE, moe_ffn


def encoder_config(cfg: ModelConfig, vision: bool = False) -> ModelConfig:
    """The geometry of an encoder layer (``vision``: the vlm's vision
    tower), as the reference's ``_init_enc_layer`` builds it: its width,
    heads (as many KV heads), d_ff, head dim ``d // h`` and no QKV bias;
    the rest (mlp kind, softcap, rope theta) is the model's."""
    if vision:
        d, h, f = cfg.vision_d_model, cfg.vision_heads, cfg.vision_d_ff
    else:
        d, h, f = cfg.d_model, cfg.n_heads, cfg.d_ff
    return dataclasses.replace(cfg, d_model=d, n_heads=h, n_kv_heads=h,
                               d_ff=f, head_dim=d // h, qkv_bias=False)


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    """Attention and MLP; the moe family's block has ``moe`` in the place
    of ``mlp``, the encdec decoder's adds ``norm_x`` and ``cross``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, gen, device=device)
        self.norm2 = L.RMSNorm(cfg.d_model, device=device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, gen, device=device)
        else:
            self.mlp = L.MLP(cfg, gen, device=device)
        if cfg.family == "encdec":
            self.norm_x = L.RMSNorm(cfg.d_model, device=device)
            self.cross = L.Attention(cfg, gen, device=device)


class EncoderBlock(nn.Module):
    """An encoder (or vision tower) layer at ``encoder_config``'s
    geometry."""

    def __init__(self, sub: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        self.norm1 = L.RMSNorm(sub.d_model, device=device)
        self.attn = L.Attention(sub, gen, device=device)
        self.norm2 = L.RMSNorm(sub.d_model, device=device)
        self.mlp = L.MLP(sub, gen, device=device)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        self.norm = L.RMSNorm(cfg.d_model, device=device)
        self.mamba = MambaBlock(cfg, gen, device=device)


class Transformer(nn.Module):
    """Embedding, the blocks and the final norm (and the encdec's encoder,
    the vlm's vision tower and projector), with random weights drawn from
    ``generator`` (default: seed 0 on the model's device).  The parameter
    names follow the JAX tree with the stacked layer axes split:
    ``blocks.{i}.attn.wq`` is ``params["blocks"]["attn"]["wq"][i]``
    (dense, moe, encdec, vlm), ``blocks.{i}.mamba.x_proj`` likewise (ssm),
    and ``enc_blocks.{i}.*`` and ``vision_blocks.{i}.*`` as ``blocks``;
    the hybrid's ``blocks.{s}.{j}.mamba.x_proj`` is ``params["blocks"]
    ["mamba"]["x_proj"][s, j]`` for super-block ``s`` and its ``j``-th
    Mamba2 layer, and its one shared attention block is ``shared.*``.
    ``device="meta"`` builds the shapes alone (no weights drawn)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        cfg = cfg.validate()
        if str(device) == "meta":          # shapes only (sharding specs)
            dev, gen = torch.device("meta"), None
        else:
            dev = resolve_device(device, "Transformer")
            gen = generator if generator is not None else \
                torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.embed = L.Embed(cfg, gen, device=dev)
        self.final_norm = L.RMSNorm(cfg.d_model, device=dev)
        if cfg.family == "ssm":
            self.blocks = nn.ModuleList(
                SSMBlock(cfg, gen, device=dev) for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            self.blocks = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, gen, device=dev)
                              for _ in range(cfg.attn_every))
                for _ in range(cfg.n_layers // cfg.attn_every))
            self.shared = DenseBlock(cfg, gen, device=dev)
        else:
            self.blocks = nn.ModuleList(
                DenseBlock(cfg, gen, device=dev)
                for _ in range(cfg.n_layers))
        if cfg.family == "encdec":
            self.enc_in = L._dense_init(
                gen, (cfg.frontend_dim or cfg.d_model, cfg.d_model),
                cfg.torch_dtype, dev)
            sub = encoder_config(cfg)
            self.enc_blocks = nn.ModuleList(
                EncoderBlock(sub, gen, device=dev)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = L.RMSNorm(cfg.d_model, device=dev)
        if cfg.family == "vlm":
            sub = encoder_config(cfg, vision=True)
            self.vision_blocks = nn.ModuleList(
                EncoderBlock(sub, gen, device=dev)
                for _ in range(cfg.n_vision_layers))
            self.vision_norm = L.RMSNorm(cfg.vision_d_model, device=dev)
            self.projector = L._dense_init(
                gen, (cfg.vision_d_model, cfg.d_model), cfg.torch_dtype, dev)


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

def _region_in(x, norm, cfg: ModelConfig, ctx, sp):
    """(input, sp) of a block's region: ``x``'s norm, or under sequence
    parallelism with ``sp_prenorm`` ``x`` itself and a ``SeqShard`` that
    norms the gathered copy.  Under sequence parallelism the norm's scale
    sums its gradient over ``model`` wherever the ranks' gradients of the
    norm are partial: on the shard (each rank its rows), and on the
    gathered copy ahead of a tensor-parallel region (each rank its
    heads or columns)."""
    if sp is None:
        return L.rms_norm(x, norm, cfg.norm_eps), sp

    def normed(t, partial=True):
        scale = C.copy_to(norm.scale, sp.group) if partial else norm.scale
        return L.rms_norm_scaled(t, scale, cfg.norm_eps)
    if ctx.sp_prenorm:
        return x, C.SeqShard(sp.group, pre=normed)
    return normed(x), sp


def _dense_block(p: DenseBlock, x, cfg: ModelConfig, *, cache=None,
                 pos=None, rope=None, pages=None, enc_out=None, cross=None,
                 ctx=None, sp=None):
    """Attention (+ cross-attention) + MLP/MoE block.  Returns (x, kv,
    cross_kv, aux): ``kv`` as ``L.attention`` returns it; ``cross_kv`` the
    cross-attention's K/V over ``enc_out`` (prefill with a cache), else
    None; ``aux`` the MoE's load-balance term, else None.  In decode the
    cross-attention reads ``cross``, the layer's cached K/V.  ``sp``: ``x``
    is this rank's rows of the sequence, and so is the result."""
    a_in, a_sp = _region_in(x, p.norm1, cfg, ctx, sp)
    h, kv_new = L.attention(p.attn, a_in, cfg, kv_cache=cache, pos=pos,
                            rope=rope, pages=pages, ctx=ctx, sp=a_sp)
    x = x + h
    cross_kv = None
    if enc_out is not None:
        c_in, c_sp = _region_in(x, p.norm_x, cfg, ctx, sp)
        h, cross_kv = L.attention(
            p.cross, c_in, cfg, kv_cache=cache, causal=False, x_kv=enc_out,
            use_rope=False, ctx=ctx, sp=c_sp)
        x = x + h
    elif cross is not None:
        x = x + _cross_decode(p.cross, L.rms_norm(x, p.norm_x, cfg.norm_eps),
                              cross, cfg, ctx)
    m_in, m_sp = _region_in(x, p.norm2, cfg, ctx, sp)
    if hasattr(p, "moe"):
        h, aux = moe_ffn(p.moe, m_in, cfg, ctx, sp=m_sp)
    else:
        h, aux = L.mlp(p.mlp, m_in, cfg, ctx, sp=m_sp), None
    return x + h, kv_new, cross_kv, aux


def _cross_decode(p: L.Attention, x, cross, cfg: ModelConfig, ctx=None):
    """Decode cross-attention over the cached encoder K/V, as the
    reference computes it (its ``_sdpa`` with no mask and no softcap): the
    query without bias or rope, through the flash attention kernel (one
    query a row over the ``enc_seq`` keys, not causal).  On a mesh the
    cache is this rank's shard, read as ``layers.attention`` reads a
    decode cache (``layers.attn_mode``): split by head dim, each row's
    encoder positions are one page of the split mode's two launches."""
    B, S, _ = x.shape
    mode, cdim = L.attn_mode(ctx, p, cfg, cfg.hd, True, True)
    qtp = mode is not None
    col, row = (1, 0) if qtp else (None, None)
    k, v = cross["k"], cross["v"]
    if qtp:
        x = C.copy_to(x, ctx.group(ctx.tp))
    q = (x @ C.weight(ctx, p.wq, col)).reshape(B, S, -1, cfg.hd)
    if cdim == 3:
        table = torch.arange(B, dtype=torch.int32,
                             device=x.device).view(B, 1)
        lengths = torch.full((B,), k.shape[1], dtype=torch.int32,
                             device=x.device)
        out = L.split_attend(q, k, v, table, lengths, ctx, qtp, cfg.hd)
    else:
        if cdim is not None:
            k = C.gathered(k, cdim, ctx.group(ctx.tp))
            v = C.gathered(v, cdim, ctx.group(ctx.tp))
        out = L.flash_attention(q, k, v, causal=False)
    out = out.reshape(B, S, -1) @ C.weight(ctx, p.wo, row)
    return C.reduce_from(out, ctx.group(ctx.tp)) if qtp else out


def _ssm_block(p: SSMBlock, x, cfg: ModelConfig, *, cache=None, pos=None,
               ctx=None, sp=None):
    m_in, m_sp = _region_in(x, p.norm, cfg, ctx, sp)
    h, _ = mamba_block(p.mamba, m_in, cfg, cache=cache, pos=pos, ctx=ctx,
                       sp=m_sp)
    return x + h


def _seq_shard(ctx, S: int):
    """The ``SeqShard`` of a forward over ``S`` positions under sequence
    parallelism (``ctx.sequence_parallel`` on a model axis over one rank
    that divides ``S``, as the reference's ``_sp_constrain`` guards it),
    else None."""
    if ctx is None or not ctx.active or not ctx.sequence_parallel \
            or ctx.tp_size == 1 or S % ctx.tp_size:
        return None
    return C.SeqShard(ctx.group(ctx.tp))


def _layer(tree, *index):
    """The views of one layer's leaves in a stacked cache."""
    return {k: v[index] for k, v in tree.items()}


def _layers(fn, x, remat: bool, ctx=None):
    """``fn(x)``, or (``remat``) the same under ``torch.utils.checkpoint``:
    its activations dropped after the forward and recomputed in the
    backward, ``x`` kept (its bytes, the layer's savepoint, appended to
    ``ctx.state["savepoints"]`` on a mesh)."""
    if not remat:
        return fn(x)
    if ctx is not None:
        ctx.state["savepoints"].append(x.numel() * x.element_size())
    return checkpoint(fn, x, use_reentrant=False)


def _encoder(blocks: nn.ModuleList, x, cfg: ModelConfig, heads: int,
             remat: bool = False, ctx=None):
    """The encoder (or vision tower) stack: non-causal attention with rope
    at the stack's head dim, the model's softcap and mlp kind."""
    hd = x.shape[-1] // heads
    rope = L.rope_tables(torch.arange(x.shape[1], device=x.device), hd,
                         cfg.rope_theta)
    for blk in blocks:
        def layer(x, blk=blk):
            a, _ = L.attention(blk.attn,
                               L.rms_norm(x, blk.norm1, cfg.norm_eps), cfg,
                               causal=False, rope=rope, hd=hd, ctx=ctx)
            x = x + a
            return x + L.mlp(blk.mlp, L.rms_norm(x, blk.norm2, cfg.norm_eps),
                             cfg, ctx)
        x = _layers(layer, x, remat, ctx)
    return x


def _input_embeds(model: Transformer, batch, cfg: ModelConfig,
                  remat: bool = False, ctx=None):
    """The token embeddings; for the vlm ``[image, text]``, the image
    through the vision tower, its norm and the projector."""
    txt = L.embed(model.embed, batch["tokens"], ctx)
    if cfg.family != "vlm":
        return txt
    v = _encoder(model.vision_blocks,
                 batch["patches"].to(cfg.torch_dtype), cfg, cfg.vision_heads,
                 remat, ctx)
    v = L.rms_norm(v, model.vision_norm, cfg.norm_eps)
    img = (v @ C.weight(ctx, model.projector)).to(cfg.torch_dtype)
    return torch.cat([img, txt], dim=1)


def _encode(model: Transformer, batch, cfg: ModelConfig,
            remat: bool = False, ctx=None):
    """The encdec's encoder states (B, T_enc, D)."""
    x = batch["enc_frames"].to(cfg.torch_dtype) @ C.weight(ctx, model.enc_in)
    x = _encoder(model.enc_blocks, x, cfg, cfg.n_heads, remat, ctx)
    return L.rms_norm(x, model.enc_norm, cfg.norm_eps)


def _forward(model: Transformer, batch, cfg: ModelConfig, make_cache: bool,
             max_len: Optional[int] = None, last_only: bool = False,
             remat: bool = False, ctx=None):
    """(logits, aux, cache); ``remat`` (no cache) checkpoints each layer;
    ``ctx`` the mesh, with sequence parallelism (``_seq_shard``) the
    residual stream between the blocks this rank's rows of the
    sequence."""
    if ctx is not None and ctx.active:
        ctx.state["savepoints"] = []
    x = _input_embeds(model, batch, cfg, remat, ctx)
    B, S, _ = x.shape
    enc_out = _encode(model, batch, cfg, remat, ctx) \
        if cfg.family == "encdec" else None
    cache = _alloc_cache(cfg, B, max(S, max_len or S), x.device,
                         None if enc_out is None else enc_out.shape[1],
                         ctx) if make_cache else None
    rope = None if cfg.family == "ssm" else L.rope_tables(
        torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sp = _seq_shard(ctx, S)
    if sp is not None:
        x = C.split(x, 1, sp.group)
    if cfg.family == "ssm":
        for i, blk in enumerate(model.blocks):
            def layer(x, blk=blk, c=_layer(cache, i) if make_cache else None):
                return _ssm_block(blk, x, cfg, cache=c, ctx=ctx, sp=sp)
            x = _layers(layer, x, remat, ctx)
    elif cfg.family == "hybrid":
        mstack, kvs = cache if make_cache else (None, None)
        for s, sup in enumerate(model.blocks):
            def super_block(x, s=s, sup=sup):
                for j, blk in enumerate(sup):
                    x = _ssm_block(blk, x, cfg, cache=_layer(mstack, s, j)
                                   if make_cache else None, ctx=ctx, sp=sp)
                x, kv, _, _ = _dense_block(model.shared, x, cfg,
                                           cache={} if make_cache else None,
                                           rope=rope, ctx=ctx, sp=sp)
                if make_cache:
                    kvs["kv"]["k"][s, :, :S] = kv["k"]
                    kvs["kv"]["v"][s, :, :S] = kv["v"]
                return x
            x = _layers(super_block, x, remat, ctx)
    elif not make_cache:
        for blk in model.blocks:
            def layer(x, blk=blk):
                x, _, _, a = _dense_block(blk, x, cfg, rope=rope,
                                          enc_out=enc_out, ctx=ctx, sp=sp)
                return x, a
            x, a = _layers(layer, x, remat, ctx)
            if a is not None:
                aux = aux + a
    else:
        for i, blk in enumerate(model.blocks):
            x, kv, cross, _ = _dense_block(
                blk, x, cfg, cache={}, rope=rope, enc_out=enc_out, ctx=ctx,
                sp=sp)
            cache["kv"]["k"][i, :, :S] = kv["k"]
            cache["kv"]["v"][i, :, :S] = kv["v"]
            if cross is not None:
                cache["cross"]["k"][i] = cross["k"]
                cache["cross"]["v"][i] = cross["v"]
    if sp is not None:
        x = C.gather(x, 1, sp.group, grad="slice")
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model.embed, x, ctx), aux, cache


def train_logits(model: Transformer, batch, cfg: ModelConfig, *,
                 remat: bool = False, ctx=None):
    """Full-sequence logits (float32) and the auxiliary loss: the sum of
    the MoE layers' load-balance terms, 0 for the other families.  With
    gradients enabled it records the graph for ``backward``; ``remat``
    recomputes each layer in the backward pass instead of keeping its
    activations; ``ctx``: the mesh, ``batch`` then this rank's shard."""
    cfg = cfg.validate()
    logits, aux, _ = _forward(model, batch, cfg, make_cache=False,
                              remat=remat, ctx=ctx)
    return logits, aux


@torch.no_grad()
def prefill(model: Transformer, batch, cfg: ModelConfig,
            max_len: Optional[int] = None, ctx=None):
    """Last-position logits (B, vocab) and the cache padded to
    ``max_len``.  Only the last position is unembedded; the reference
    unembeds every position and keeps the last.  On a mesh (``ctx``) the
    model holds this rank's shards (``collectives.place_model``), ``batch``
    is this rank's rows and the cache comes back as this rank's shard
    (``sharding.kv_cache_pspecs`` with ``ctx.kv_mode``); the logits are
    the rows' whole vocabulary."""
    logits, _, cache = _forward(model, batch, cfg.validate(),
                                make_cache=True, max_len=max_len,
                                last_only=True, ctx=ctx)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(model: Transformer, tokens, cache, pos: int,
                cfg: ModelConfig, ctx=None):
    """tokens: (B, 1); pos: the write position (a Python int).  On a mesh
    ``tokens`` and ``cache`` are this rank's shards, as ``prefill`` left
    them."""
    x = L.embed(model.embed, tokens, ctx)
    B = x.shape[0]
    pos = int(pos)
    if cfg.family == "ssm":
        for i, blk in enumerate(model.blocks):
            x = _ssm_block(blk, x, cfg, cache=_layer(cache, i), pos=pos,
                           ctx=ctx)
    else:
        kv = cache[1]["kv"] if cfg.family == "hybrid" else cache["kv"]
        kc, vc = kv["k"], kv["v"]
        rope = L.rope_tables(torch.full((1,), pos, device=x.device), cfg.hd,
                             cfg.rope_theta)
        pages = L.decode_pages(B, kc.shape[2], pos, x.device)
        if cfg.family == "hybrid":
            for s, sup in enumerate(model.blocks):
                for j, blk in enumerate(sup):
                    x = _ssm_block(blk, x, cfg, cache=_layer(cache[0], s, j),
                                   pos=pos, ctx=ctx)
                x, _, _, _ = _dense_block(
                    model.shared, x, cfg, cache={"k": kc[s], "v": vc[s]},
                    pos=pos, rope=rope, pages=pages, ctx=ctx)
        else:
            cross = cache.get("cross")
            for i, blk in enumerate(model.blocks):
                x, _, _, _ = _dense_block(
                    blk, x, cfg, cache={"k": kc[i], "v": vc[i]}, pos=pos,
                    rope=rope, pages=pages,
                    cross=None if cross is None else _layer(cross, i),
                    ctx=ctx)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model.embed, x, ctx)[:, 0], cache


def _alloc_cache(cfg: ModelConfig, batch: int, max_len: int, dev,
                 enc_len: Optional[int] = None, ctx=None):
    """Zeros of the family's cache layout; the encdec's cross K/V at
    ``enc_len`` encoder positions (default ``cfg.enc_seq``).  On a mesh
    (``ctx``) each leaf is this rank's part of its split over ``model``
    (``batch`` is already this rank's rows)."""
    if ctx is not None and ctx.active and ctx.tp_size > 1:
        whole = _alloc_cache(cfg, batch, max_len, torch.device("meta"),
                             enc_len)
        specs = shard_rules.kv_cache_pspecs(
            whole, cfg, shard_rules.make_parallel_cfg(
                {ctx.tp: ctx.tp_size}, kv_mode=ctx.kv_mode), ctx.tp_size)
        return shard_rules.map_leaves(
            lambda t, spec: torch.zeros(
                shard_rules.shard_shape(t.shape, spec,
                                        {ctx.tp: ctx.tp_size}),
                dtype=t.dtype, device=dev), whole, specs)
    dt = cfg.torch_dtype

    def kv(n: int, length: int):
        shape = (n, batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    def stacked(*lead):
        return {k: torch.zeros(lead + v.shape, dtype=v.dtype, device=dev)
                for k, v in init_mamba_cache(cfg, batch,
                                             device="meta").items()}

    if cfg.family == "ssm":
        return stacked(cfg.n_layers)
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        return stacked(n_super, cfg.attn_every), {"kv": kv(n_super, max_len)}
    cache = {"kv": kv(cfg.n_layers, max_len)}
    if cfg.family == "encdec":
        cache["cross"] = kv(cfg.n_layers, enc_len or cfg.enc_seq)
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """Zeros of the family's cache layout (``device="meta"``: the shapes
    alone)."""
    dev = torch.device("meta") if str(device) == "meta" else \
        resolve_device(device, "init_cache")
    return _alloc_cache(cfg.validate(), batch, max_len, dev)
