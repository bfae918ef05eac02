"""Serve step builders (port of the serving part of
``repro.train.step``): ``make_prefill`` and ``make_serve_step`` return
plain functions of (params, tensors), for every configuration the model
runs (attn/swa/hymba/mamba/mlstm/slstm blocks, dense, MoE or no FFN,
rotary or learned positions, whisper's encoder-decoder, whose prefill
takes the frames); as in the reference they discard ``forward``'s aux
(the MoE loss).  The train step is not ported
yet (ROADMAP Queue 1 item 17)."""
from __future__ import annotations

from ..models import transformer
from ..models.config import ModelConfig


def make_prefill(cfg: ModelConfig):
    """(params, tokens (B, S), cache, frames=None) -> (logits (B, vocab)
    at the last position, new_cache); ``frames`` (B, enc_seq, D) for an
    encoder-decoder, whose prefill runs the encoder and stores its
    projected keys and values in the cache.  The head runs on the last
    position only: the same logits as the reference's full head sliced
    at -1."""

    def prefill(params, tokens, cache, frames=None):
        x, new_cache, _ = transformer.forward(
            cfg, params, tokens, mode="prefill", cache=cache, frames=frames,
            skip_head=True)
        return transformer.head(cfg, params, x[:, -1:])[:, 0], new_cache

    return prefill


def make_serve_step(cfg: ModelConfig):
    """One-token decode: (params, cache, token (B, 1), pos int) ->
    (logits (B, vocab), new_cache)."""

    def serve_step(params, cache, token, pos):
        logits, new_cache, _ = transformer.forward(
            cfg, params, token, mode="decode", cache=cache, pos=pos)
        return logits[:, 0], new_cache

    return serve_step
