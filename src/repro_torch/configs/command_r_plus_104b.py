"""command-r-plus-104b: 64L d12288 96H (GQA kv=8) d_ff=33792 vocab=256000,
no biases, tied embeddings.  [hf:CohereForAI/c4ai-command-r-plus; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    tie_embeddings=True,
)
