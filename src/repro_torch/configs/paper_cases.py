"""The paper's own LLM evaluation cases (§IV-B), as selectable configs.

* bert-enlarged: the 24.16B-parameter, 480-layer BERT the paper serves from
  an 80 GiB HMS (encoder-only: modeled as the framework's encoder stack with
  a minimal 1-layer decoder head, noted in DESIGN.md §7).
* gpt3-xl: the 1.3B GPT-3 XL used for the paper's single-GPU LLM-training
  study (Fig. 16a).
"""
from ..models.config import ModelConfig

BERT_ENLARGED = ModelConfig(
    name="bert-enlarged-24b", family="encdec",
    n_layers=1, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=30522,
    mlp="gelu", n_enc_layers=480, enc_seq=512, frontend_dim=2048,
)

GPT3_XL = ModelConfig(
    name="gpt3-xl", family="dense",
    n_layers=24, d_model=2048, n_heads=24, n_kv_heads=24,
    d_ff=8192, vocab=50257, head_dim=128,
    mlp="gelu", tie_embeddings=True,     # GPT-2/3 style: 1.3B params
)

CONFIG = GPT3_XL            # default export for the registry
SMOKE = ModelConfig(
    name="gpt3-xl-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
)
