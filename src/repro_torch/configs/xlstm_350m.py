"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304; alternating
mLSTM (matrix memory, parallelizable) and sLSTM (scalar memory, true
recurrence) blocks; no FFN sublayer (d_ff=0 — projections live inside the
mixers).  [arXiv:2405.04517; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
    remat="dots",
    microbatches=1,
)

SMOKE = CONFIG.reduced(d_ff=0, head_dim=16)
