"""Sharded training with microbatches over batch ranks, on spawned CPU
ranks (gloo): the microbatches cross the batch ranks (2 over 4), neither
number divides the other (3 over 2), or a rank holds several (4 over
2), for smoke hymba and, in waves with the top-1 counts summed between
forward and backward, smoke qwen3-moe, in float32.  Each holds two steps
of ``make_train_step(cfg, mesh)`` against ``jax.jit(repro.train.step.
make_train_step)`` with the same ``microbatches`` and against the port's
one-device step, within ``tests/torch_train_cases.py``'s bands, on a
batch whose microbatches hold unequal numbers of valid labels (a mean of
the ranks' means would weigh them alike).  The segment and wave plans
are pinned on their own."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.train import step as tstep

from torch_train_cases import S, run_case

torch.set_num_threads(1)


def _unequal_batch(vocab, B, seed=9):
    """(jax, torch) batches of B rows whose valid labels differ from row to
    row: row r keeps its first 2 + 5 r labels (at most S - 1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    for r in range(B):
        labels[r, min(2 + 5 * r, S - 1):] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


@pytest.mark.parametrize("arch,mb,ranks,B", [
    ("hymba_1_5b", 2, 4, 4),
    ("hymba_1_5b", 3, 2, 6),
    ("hymba_1_5b", 4, 2, 4),
    ("qwen3_moe_235b_a22b", 3, 2, 6),
    ("qwen3_moe_235b_a22b", 2, 4, 4),
], ids=["hymba-2over4", "hymba-3over2", "hymba-4over2", "moe-3over2",
        "moe-2over4"])
def test_microbatches_over_batch_ranks_match_jax(arch, mb, ranks, B):
    run_case(arch, mb=mb, mesh_shape=(ranks, 1),
             batch=_unequal_batch(256, B))


def test_segments_and_waves():
    # 3 microbatches of 2 rows over 2 ranks of 3 rows
    assert tstep.segments(6, 3, 2, 0) == [(0, 0, 2), (1, 2, 3)]
    assert tstep.segments(6, 3, 2, 1) == [(1, 0, 1), (2, 1, 3)]
    assert tstep.waves(6, 3, 2) == [0, 1, 2]
    # 2 over 4: each rank one segment, one wave
    assert [tstep.segments(8, 2, 4, r) for r in range(4)] == \
        [[(0, 0, 2)], [(0, 0, 2)], [(1, 0, 2)], [(1, 0, 2)]]
    assert tstep.waves(8, 2, 4) == [0, 0]
    # 4 over 2: two whole microbatches a rank, two waves
    assert tstep.segments(8, 4, 2, 1) == [(2, 0, 2), (3, 2, 4)]
    assert tstep.waves(8, 4, 2) == [0, 1, 0, 1]
    # every row in exactly one segment
    for B, mb, n in ((12, 3, 4), (12, 4, 3), (16, 8, 16 // 4), (256, 4, 16)):
        got = sorted((r, lo, hi) for r in range(n)
                     for _, lo, hi in tstep.segments(B, mb, n, r))
        assert sum(hi - lo for _, lo, hi in got) == B
