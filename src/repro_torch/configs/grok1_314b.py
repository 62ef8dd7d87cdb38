"""grok-1-314b — MoE 8 experts top-2, GQA [hf:xai-org/grok-1; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2,
    rope_theta=1e4,
    fsdp_axes=("pod", "data"),
)
