"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B
family scaling; hf].  QK-norm, no attention bias, rope 1e6."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab=151936,
    n_experts=128,
    top_k=8,
    d_expert=1536,
    qk_norm=True,
    rope_theta=1e6,
    remat="full",
    microbatches=8,
)

SMOKE = CONFIG.reduced()
