"""seamless-m4t-medium — enc-dec, audio frontend stubbed (precomputed frame
embeddings) [arXiv:2308.11596; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256206,
    encoder_layers=12, frontend="audio",
    rope_theta=1e4,
)
