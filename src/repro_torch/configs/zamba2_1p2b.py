"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks
[arXiv:2411.15242; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, conv_width=4,
    hybrid_attn_every=6,
    window=4096,  # shared-attn blocks go sliding-window at long context
)
