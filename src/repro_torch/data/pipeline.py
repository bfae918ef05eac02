"""Deterministic synthetic token pipeline (port of
``repro.data.pipeline``).

A batch is a pure function of (seed, step, shard): a host generator,
``numpy.random.default_rng([seed, step, shard])``, draws it, so the
same bits come out on the CPU and beside the card, with the two
properties a distributed trainer needs:

  * restart determinism: resuming from step k replays exactly the batches
    k, k+1, ... with no data state in the checkpoint (skip-ahead is free);
  * shard determinism: each data shard draws its own reproducible stream
    whatever the number of hosts the job restarts with.

The reference draws with ``jax.random``, whose bits cannot be reproduced
here; the port keeps its laws.  Tokens are i.i.d. from the reference's
Zipf-like categorical, ``softmax(-alpha * log rank)`` (a heavy head and a
long tail, so cross-entropy curves behave like text rather than uniform
noise); labels are the next tokens, the last position masked with -1.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.types import resolve_device

__all__ = ["DataConfig", "batch_iterator", "get_batch", "zipf_pmf"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2
    n_shards: int = 1


@functools.lru_cache(maxsize=8)
def zipf_pmf(vocab: int, alpha: float) -> np.ndarray:
    """The token marginal, softmax(-alpha * log rank) over ranks 1..vocab,
    in float64."""
    logits = -alpha * np.log(np.arange(1, vocab + 1, dtype=np.float64))
    p = np.exp(logits - logits.max())
    p /= p.sum()
    p.setflags(write=False)           # cached: every caller shares it
    return p


def get_batch(dc: DataConfig, step: int, shard: int = 0, device=None):
    """{"tokens" (B_shard, S) int32, "labels"} for this (step, shard), on
    ``device`` (the card unless the caller asks for the CPU)."""
    if dc.global_batch % dc.n_shards:
        raise ValueError(f"global batch {dc.global_batch} does not split "
                         f"into {dc.n_shards} shards")
    if not 0 <= shard < dc.n_shards:
        raise ValueError(f"shard {shard} of {dc.n_shards}")
    b = dc.global_batch // dc.n_shards
    rng = np.random.default_rng([dc.seed, step, shard])
    toks = rng.choice(dc.vocab, size=(b, dc.seq_len + 1),
                      p=zipf_pmf(dc.vocab, dc.zipf_alpha)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1                         # mask the boundary position
    dev = resolve_device(device)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1]))
            .to(dev), "labels": torch.from_numpy(labels).to(dev)}


def batch_iterator(dc: DataConfig, start_step: int = 0, shard: int = 0,
                   device=None):
    step = start_step
    while True:
        yield step, get_batch(dc, step, shard, device)
        step += 1
