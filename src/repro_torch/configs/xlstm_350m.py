"""xlstm-350m — sLSTM + mLSTM blocks (attention-free) [arXiv:2405.04517;
unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304,
    slstm_ratio=4,  # 3 mLSTM : 1 sLSTM per group
    tie_embeddings=True,
)
