"""Seeded numpy inputs for the port's kernels, and the edge cases of the
LM kernels: one builder for the CPU tests, the card tests
(tests/test_torch_cuda.py) and chip_smoke.py.
Imports neither JAX nor pytest, so it loads on a machine with a card and
PyTorch alone."""
from __future__ import annotations

import math

import numpy as np
import torch

INF = 1.0e30


def dcsim_inputs(n, c, seed, throttled=True):
    """A random farm slab: every server state, half the cores busy, some
    slots finishing exactly at t_next, timers armed on half the servers,
    ~30% throttled."""
    rng = np.random.default_rng(seed)
    t = np.float32(rng.uniform(0, 10))
    t_next = np.float32(t + rng.uniform(0, 1))
    busy = np.where(rng.random((n, c)) < 0.5,
                    rng.uniform(t, t + 2, (n, c)), INF).astype(np.float32)
    busy[rng.random((n, c)) < 0.05] = t_next
    state = rng.integers(0, 6, n).astype(np.int32)
    energy = rng.uniform(0, 100, n).astype(np.float32)
    bsec = rng.uniform(0, 10, n).astype(np.float32)
    wake = np.where(state == 5, rng.uniform(t, t + 3, n), INF
                    ).astype(np.float32)
    isince = rng.uniform(0, t, n).astype(np.float32)
    tau = np.where(rng.random(n) < 0.5, rng.uniform(0.1, 2.0, n), INF
                   ).astype(np.float32)
    thr = (rng.random(n) < 0.3).astype(np.int32) if throttled else None
    table = np.asarray([65.0, 65.0, 15.0, 9.0, 0.0, 145.0], np.float32)
    return (busy, state, energy, bsec, t, t_next, table, 13.0, 2.0, wake,
            isince, tau, thr)


def edge_free_vals(rng, n, lo=1e-5, hi=1e3, B=64):
    """Log-uniform latencies over [lo/10, 10 hi] (both clamps hit), moved
    off the bin edges: a 1-ulp difference between two ``log``
    implementations can move an edge value by one bin."""
    scale = B / math.log(hi / lo)
    v = np.exp(rng.uniform(math.log(lo / 10), math.log(hi * 10), n))
    raw = np.log(np.maximum(v, lo) / lo) * scale
    near = (np.abs(raw - np.round(raw)) < 1e-3) & (v > lo) & (v < hi)
    v[near] *= 1.0 + 2e-3 / scale
    return v.astype(np.float32)


def tb_inputs(J, M, B, W, K, seed, unit=True):
    """telemetry_accum inputs: 0/1 weights (``unit``; otherwise weights
    from {0, 0.5, 1, 2}, whose sums are exact in any order too),
    integer-valued histograms."""
    rng = np.random.default_rng(seed)

    def wts(n, p):
        w = (rng.random(n) < p).astype(np.float32)
        return w if unit else w * rng.choice(
            np.float32([0.5, 1.0, 2.0]), n)
    return (edge_free_vals(rng, J, B=B), wts(J, 0.4),
            edge_free_vals(rng, M, B=B), wts(M, 0.6),
            rng.integers(0, 9, B).astype(np.float32),
            rng.integers(0, 9, B).astype(np.float32),
            rng.uniform(0, 1, (W, K)).astype(np.float32),
            np.int32(rng.integers(0, W)),
            rng.uniform(0, 1, K).astype(np.float32), 1e-5, 1e3)


def torch_args(np_args, device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device)
                 if isinstance(a, (np.ndarray, np.generic)) else a
                 for a in np_args)


def flash_inputs(B, H, KV, Sq, Skv, hd, seed):
    """Standard-normal q (B, H, Sq, hd) and k/v (B, KV, Skv, hd), float32;
    cast them to bfloat16 on each side for the bf16 cases."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in
                 ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd)))


def ssm_inputs(B, S, Dss, N, seed):
    """(dt, Bm, Cm, x, A) as the Mamba mixer makes them: dt = softplus of a
    pre-activation around the init's -4.6 bias (0.001..0.2), A = -(1..N)
    per channel times a random factor, standard-normal B, C and x; all
    float32."""
    rng = np.random.default_rng(seed)
    pre = rng.normal(-4.6, 1.5, (B, S, Dss))
    dt = np.log1p(np.exp(pre)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    x = rng.standard_normal((B, S, Dss), dtype=np.float32)
    A = -(np.arange(1, N + 1, dtype=np.float32)[None, :]
          * rng.uniform(0.5, 1.5, (Dss, 1)).astype(np.float32))
    return dt, Bm, Cm, x, A


# Edges of the tensor-core (bf16) flash-attention instance, held against
# the plain version by tests/test_torch_cuda.py and chip_smoke.py:
# B, H, KV, Sq, Skv, hd, causal, window, softcap
FLASH_TC_EDGES = [
    (1, 4, 2, 100, 170, 64, True, 0, 0.0),      # Sq, Skv ragged, Sq < Skv
    (2, 4, 4, 77, 45, 64, False, 0, 0.0),       # non-causal, Sq > Skv, G=1
    (1, 10, 2, 200, 200, 128, True, 0, 0.0),    # hd 128, G=5
    (1, 5, 1, 150, 150, 256, True, 100, 0.0),   # hd 256 (32-key tiles)
    (1, 2, 2, 130, 130, 64, True, 20, 0.0),     # window < one tile
    (2, 4, 2, 300, 300, 64, True, 100, 0.0),    # window edge inside a tile
    (1, 2, 1, 300, 90, 64, True, 40, 0.0),      # rows with no unmasked key
    (1, 4, 2, 190, 190, 64, True, 0, 30.0),     # softcap
    (1, 2, 1, 65, 200, 16, False, 33, 0.0),     # hd 16, non-causal window
    (1, 4, 4, 129, 129, 32, True, 0, 0.0),      # hd 32
]

# Edges of the lane-split SSM scan: B, S, Dss, N (N of every lane split
# and a ragged last lane; S = 1 and S off the 16-step chunk; Dss off the
# channel tile)
SSM_EDGES = [
    (2, 40, 50, 1), (2, 9, 11, 2), (1, 17, 13, 3), (2, 21, 30, 7),
    (1, 33, 100, 16), (2, 1, 20, 16), (1, 20, 37, 17), (1, 50, 70, 33),
    (2, 19, 9, 64),
]
