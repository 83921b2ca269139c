"""Unified model configuration covering all assigned architecture families
(a copy of the JAX package's ``models/config.py``; ``torch_dtype`` takes the
place of ``jdtype``).

One ``ModelConfig`` describes every LM-family backbone in the pool:
dense GQA transformers, MoE transformers, SSM (Mamba2/SSD), hybrid
(Mamba2 + shared attention), encoder-decoder (Whisper) and VLM
(Pixtral = ViT tower + decoder).  ``family`` selects the block program;
unused fields are ignored by other families.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0       # grok-1 uses 30.0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    mlp: str = "swiglu"              # swiglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    ssm_conv: int = 4
    attn_every: int = 6              # hybrid: shared attn block period

    # enc-dec / vlm frontends (stubs provide precomputed embeddings)
    n_enc_layers: int = 0
    enc_seq: int = 1500              # whisper audio frames / pixtral patches
    frontend_dim: int = 0            # stub embedding dim (= d_model if 0)

    # vlm vision tower
    n_vision_layers: int = 0
    vision_d_model: int = 0
    vision_heads: int = 0
    vision_d_ff: int = 0
    n_patches: int = 256

    dtype: str = "bfloat16"

    # ---------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic families only (long_500k eligibility)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k of n_experts)."""
        return _param_count(self, active_only=True)

    def validate(self) -> "ModelConfig":
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec",
                               "vlm")
        if self.family in ("dense", "moe", "encdec", "vlm"):
            assert self.n_heads % max(1, self.n_kv_heads) == 0
            assert self.d_model % self.n_heads == 0 or self.head_dim
        if self.family == "moe":
            assert self.n_experts >= 2 and self.top_k <= self.n_experts
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        return self


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.hd
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    b = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + b


def _mlp_params(cfg: ModelConfig, d_model=None, d_ff=None) -> int:
    dm = d_model or cfg.d_model
    ff = d_ff or cfg.d_ff
    return (3 if cfg.mlp == "swiglu" else 2) * dm * ff


def _mamba_params(cfg: ModelConfig) -> int:
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    in_proj = cfg.d_model * (2 * di + 2 * g * n + h)
    conv = (di + 2 * g * n) * cfg.ssm_conv
    out = di * cfg.d_model
    extras = 3 * h + di          # A_log, D, dt_bias, gating norm
    return in_proj + conv + out + extras


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    norms = 2 * cfg.d_model * cfg.n_layers + cfg.d_model
    if cfg.family == "dense":
        per = _attn_params(cfg) + _mlp_params(cfg)
        return emb + norms + cfg.n_layers * per
    if cfg.family == "moe":
        ne = cfg.top_k if active_only else cfg.n_experts
        per = (_attn_params(cfg) + ne * _mlp_params(cfg)
               + cfg.d_model * cfg.n_experts)
        return emb + norms + cfg.n_layers * per
    if cfg.family == "ssm":
        return emb + norms + cfg.n_layers * _mamba_params(cfg)
    if cfg.family == "hybrid":
        n_attn_applications = cfg.n_layers // cfg.attn_every
        shared = _attn_params(cfg) + _mlp_params(cfg)
        return (emb + norms + cfg.n_layers * _mamba_params(cfg) + shared)
    if cfg.family == "encdec":
        enc = cfg.n_enc_layers * (_attn_params(cfg) + _mlp_params(cfg))
        dec = cfg.n_layers * (2 * _attn_params(cfg) + _mlp_params(cfg))
        return emb + norms + enc + dec
    if cfg.family == "vlm":
        vis_cfg = dataclasses.replace(
            cfg, d_model=cfg.vision_d_model, n_heads=cfg.vision_heads,
            n_kv_heads=cfg.vision_heads, d_ff=cfg.vision_d_ff, head_dim=None)
        vis = cfg.n_vision_layers * (_attn_params(vis_cfg)
                                     + _mlp_params(vis_cfg))
        proj = cfg.vision_d_model * cfg.d_model
        dec = cfg.n_layers * (_attn_params(cfg) + _mlp_params(cfg))
        return emb + norms + vis + proj + dec
    raise ValueError(cfg.family)
