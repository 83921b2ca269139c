"""zamba2-2.7b: 54 Mamba2 layers d2560 + shared attention block (32H kv=32,
d_ff=10240) applied every 6 layers, ssm_state=64.  [arXiv:2411.15242; hf].
Simplification noted in DESIGN.md: the two alternating shared blocks of the
release model are modeled as one shared block; concat-LoRA input is modeled
as a plain residual."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
    attn_every=2,
)
