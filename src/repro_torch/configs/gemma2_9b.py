"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; alternating local(4k sliding window)/global attention,
attention + final logit softcaps, gated-GELU, tied embeddings, embeddings
scaled by sqrt(d_model).  [arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    block_pattern=("swa", "attn"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="geglu",
    tie_embeddings=True,
    rope_theta=1e4,
    remat="full",
    microbatches=2,
)

SMOKE = CONFIG.reduced(sliding_window=8)
