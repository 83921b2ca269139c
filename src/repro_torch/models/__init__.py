"""Model definitions of the port: the dense, ssm (Mamba2) and hybrid
(zamba2) families."""

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
