"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (kv=16) expert
d_ff=1408 vocab=163840, MoE 64 experts top-6 + 2 shared experts
(kimi/moonlight, deepseek-style).  [hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab=163840,
    n_experts=64,
    top_k=6,
    d_expert=1408,
    n_shared_experts=2,
    rope_theta=5e4,
    remat="full",
    microbatches=4,
)

SMOKE = CONFIG.reduced()
