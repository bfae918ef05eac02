"""Model configuration for the LM substrate (the port's copy of
``repro.models.config``, pinned to it field for field by
tests/test_torch_lm_modules.py).

One frozen dataclass drives every assigned architecture: dense GQA
transformers, MoE (GShard-style routed experts), gemma2-style local/global
alternation with logit softcaps, hybrid attention+SSM (hymba), xLSTM
(sLSTM/mLSTM alternation), early-fusion VLM (chameleon) and encoder-decoder
audio (whisper).  The port's forward runs every decoder block kind below,
dense, MoE or without a feed-forward, rotary or learned positions, and
whisper's encoder (``enc_layers`` bidirectional blocks over ``enc_seq``
frame embeddings with sinusoidal positions) with ``cross_attn`` in every
decoder block (``models.transformer``).  ``frontend`` is carried and not
read: the reference stubs both front ends (frames arrive as embeddings;
VQ image tokens are ids of the shared vocab).  ``skip_attention`` (the
roofline probe) drops the attention outside decode.  Of the runtime knobs,
``remat`` (train mode's checkpointing), ``microbatches`` and
``xent_chunk`` (the train step's) are read; ``scan_layers``,
``fsdp_embed``, ``use_flash`` and ``attn_bf16_scores`` are carried and not
read, and ``attn_chunk`` is read by the mLSTM's parallel form only.

Block kinds (``block_pattern``; ``n_layers`` must be divisible by
``len(block_pattern)``):

  attn    full (causal for decoders, bidirectional for encoders) attention
  swa     sliding-window attention (``sliding_window`` tokens)
  hymba   parallel attention + Mamba-style SSM heads, outputs fused
  mamba   pure Mamba-style selective SSM mixer
  mlstm   xLSTM matrix-memory block (parallelizable linear attention form)
  slstm   xLSTM scalar-memory block (recurrent gating)
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0              # per-expert FFN hidden size
    n_shared_experts: int = 0      # moonshot/deepseek-style always-on experts
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3
    moe_impl: str = "scatter"      # scatter | einsum (oracle) | dense

    # --- attention flavor ----------------------------------------------------
    attn_bias: bool = False        # qwen1.5 QKV bias
    qk_norm: bool = False          # qwen3 / chameleon
    attn_softcap: float = 0.0      # gemma2 attention logit softcap
    final_softcap: float = 0.0     # gemma2 final logit softcap
    sliding_window: int = 0        # used by 'swa' blocks
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- SSM (hymba / mamba) -------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 1

    # --- encoder-decoder (whisper) -------------------------------------------
    enc_layers: int = 0
    enc_seq: int = 1500            # stubbed conv frontend output length
    cross_attn: bool = False
    frontend: str = "none"         # none | audio_frames | vq_tokens

    # --- misc -----------------------------------------------------------------
    act: str = "silu"              # silu | gelu
    pos: str = "rope"              # rope | learned
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- runtime knobs (hillclimb levers; do not change math) -----------------
    remat: str = "full"            # nothing | dots | full
    microbatches: int = 1
    use_flash: bool = False        # reference: Pallas kernels (unread;
    #                                the port always runs its kernels)
    scan_layers: bool = True
    fsdp_embed: bool = True        # shard d_model dim of params over "data"
    attn_chunk: int = 512          # query-chunk size (0 = no chunking)
    xent_chunk: int = 0            # seq chunks for fused xent (0 = off)
    attn_bf16_scores: bool = False  # bf16 score/prob tensors (f32 stats)
    skip_attention: bool = False   # roofline probe: mixer ablated, used to
    #                                measure attention's exact byte/flop
    #                                share by difference (never for training)
    serve_weights_stationary: bool = False  # decode: 2D weight sharding,
    #                                 no per-step FSDP gathers (hillclimb)

    # ------------------------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {self.period}")
        return self.n_layers // self.period

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_enc_dec(self) -> bool:
        return self.enc_layers > 0

    @property
    def d_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test scale sibling: same family/pattern, tiny dims."""
        small = dict(
            n_layers=2 * self.period,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128,
            vocab=256,
            enc_layers=2 if self.is_enc_dec else 0,
            enc_seq=16 if self.is_enc_dec else self.enc_seq,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window
            else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            n_experts=8 if self.is_moe else 0,
            top_k=2 if self.is_moe else 0,
            d_expert=32 if self.is_moe else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            microbatches=1,
            remat="nothing",
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    # rough parameter counts (for roofline MODEL_FLOPS = 6·N·D) -------------
    def param_count(self, active_only: bool = False) -> int:
        D, V = self.d_model, self.vocab
        embed = V * D * (1 if self.tie_embeddings else 2)
        attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
        if self.attn_bias:
            attn += self.q_dim + 2 * self.kv_dim
        per_layer = {}
        for kind in set(self.block_pattern):
            p = 0
            if kind in ("attn", "swa"):
                p = attn
            elif kind == "hymba":
                p = attn + self._ssm_params()
            elif kind == "mamba":
                p = self._ssm_params()
            elif kind == "mlstm":
                p = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D \
                    + 2 * D * self.n_heads
            elif kind == "slstm":
                p = 4 * D * D + 4 * D
            per_layer[kind] = p + 2 * D          # norms
        mixer = sum(per_layer[k] for k in self.block_pattern) * self.n_periods
        if self.is_moe:
            e = self.top_k if active_only else self.n_experts
            ffn = (e + self.n_shared_experts) * 3 * D * self.d_expert \
                + D * self.n_experts            # router
        else:
            ffn = 3 * D * self.d_ff if self.act == "silu" else 2 * D * self.d_ff
        ffn_total = ffn * self.n_layers
        enc = 0
        if self.is_enc_dec:
            enc = self.enc_layers * (attn + 3 * D * self.d_ff + 4 * D)
            mixer += self.n_layers * attn        # decoder cross-attention
        return embed + mixer + ffn_total + enc + D

    def _ssm_params(self) -> int:
        Ds, S = self.d_ssm, self.ssm_state
        return (self.d_model * 2 * Ds          # in_proj (x, z)
                + Ds * self.ssm_conv           # depthwise conv
                + Ds * (2 * S + 1)             # B, C, dt projections (simpl.)
                + Ds * S                       # A
                + Ds * self.d_model)           # out_proj


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def sub_quadratic(cfg: ModelConfig) -> bool:
    """True when every block's cost is bounded in seq_len (SWA / SSM)."""
    return all(k in ("swa", "hymba", "mamba", "mlstm", "slstm")
               for k in cfg.block_pattern) and not cfg.is_enc_dec


def supported_shapes(cfg: ModelConfig):
    """The assigned-shape subset this architecture runs (skips recorded in
    DESIGN.md §Arch-applicability): long_500k needs sub-quadratic mixers."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if sub_quadratic(cfg):
        names.append("long_500k")
    return [SHAPES[n] for n in names]
