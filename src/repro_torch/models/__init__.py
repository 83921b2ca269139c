"""Model definitions of the port, for every family: dense, moe (``moe.py``),
ssm (Mamba2), hybrid (zamba2), encdec (whisper: an encoder and
cross-attention) and vlm (pixtral: a vision tower and projector)."""

from .config import ModelConfig
from .transformer import (
    Transformer,
    decode_step,
    init_cache,
    init_params,
    prefill,
    train_logits,
)

__all__ = [
    "ModelConfig", "Transformer", "decode_step", "init_cache", "init_params",
    "prefill", "train_logits",
]
