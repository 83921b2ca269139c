"""whisper-tiny: enc-dec, 4L d384 6H (kv=6) d_ff=1536 vocab=51865, conv
frontend stubbed (input_specs provides precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    mlp="gelu", n_enc_layers=4, enc_seq=1500, frontend_dim=384,
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    mlp="gelu", n_enc_layers=2, enc_seq=16, frontend_dim=64,
)
