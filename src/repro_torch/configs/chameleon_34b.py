"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion: VQ image tokens are ordinary ids in the shared
vocab (the VQ-VAE tokenizer is the stubbed frontend — ``input_specs``
emits token ids + a modality mask), QK-norm for training stability.
[arXiv:2405.09818; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    frontend="vq_tokens",
    rope_theta=1e4,
    remat="full",
    microbatches=4,
)

SMOKE = CONFIG.reduced(qk_norm=True)
