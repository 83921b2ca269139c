"""pixtral-12b: 40L d5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim
128 (mistral-nemo decoder) + pixtral ViT tower (24L d1024 16H d_ff 4096);
patch frontend stubbed (input_specs provides patch embeddings).
[hf:mistralai/Pixtral-12B-2409; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    n_vision_layers=24, vision_d_model=1024, vision_heads=16,
    vision_d_ff=4096, n_patches=1024,
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    n_vision_layers=2, vision_d_model=32, vision_heads=2,
    vision_d_ff=64, n_patches=8,
)
