"""qwen2-vl-72b — VLM backbone with M-RoPE; vision frontend stubbed
(precomputed patch embeddings) [arXiv:2409.12191; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    frontend="vision", mrope=True,
    rope_theta=1e6,
    fsdp_axes=("pod", "data"),
)
