"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + Mamba heads in every block
(outputs fused), sliding-window attention so the global state lives in the
SSM — this is what makes long_500k decoding O(1)/token.
[arXiv:2411.13676; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    block_pattern=("hymba",),
    sliding_window=1024,
    ssm_state=16,
    ssm_expand=2,
    rope_theta=1e4,
    remat="dots",
    microbatches=1,
)

SMOKE = CONFIG.reduced(n_heads=4, n_kv_heads=2, ssm_expand=2)
