"""whisper-large-v3 [audio] — enc-dec, 32+32L d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866; conv frontend is a STUB (``input_specs`` provides
precomputed frame embeddings (B, enc_seq, d_model)); sinusoidal encoder
positions, learned decoder positions (extended to the assigned sequence
lengths — adaptation noted in DESIGN.md), plain GELU MLPs, cross-attention
in every decoder layer.  [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    enc_layers=32,
    enc_seq=1500,
    cross_attn=True,
    frontend="audio_frames",
    act="gelu",
    pos="learned",
    remat="dots",
    microbatches=2,
)

SMOKE = CONFIG.reduced()
