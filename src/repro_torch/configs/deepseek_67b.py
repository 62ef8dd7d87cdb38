"""deepseek-67b — dense llama-arch, GQA [arXiv:2401.02954; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=102400,
    rope_theta=1e4,
    fsdp_axes=("pod", "data"),  # 67B fp32 master+adam: shard over both axes
)
