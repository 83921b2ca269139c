"""granite-8b: 36L d4096 32H (GQA kv=8) d_ff=14336 vocab=49152 (llama-arch,
code).  [arXiv:2405.04324; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152,
)

SMOKE = ModelConfig(
    name="granite-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
)
