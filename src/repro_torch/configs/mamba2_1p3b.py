"""mamba2-1.3b: 48L d2048 attn-free SSD, ssm_state=128, vocab=50280.
[arXiv:2405.21060; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
)
