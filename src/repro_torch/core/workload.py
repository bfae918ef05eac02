"""Workload arrival models (paper §III-D): a copy of
``repro.core.workload``, kept numpy-only so the port never imports the
JAX package (tests pin the two bit-identical for the same seed).

Three arrival models, matching the paper:
  * Poisson: exponential inter-arrivals at rate ``lam``.
  * MMPP(2): two-state Markov-modulated Poisson process — a bursty state with
    rate ``lam_h`` and a quiet state with rate ``lam_l``; sojourn times are
    exponential with rates ``r_hl`` / ``r_lh``.
  * Trace: replay of absolute arrival timestamps (e.g. a Wikipedia-like
    diurnal trace synthesized by :func:`wiki_like_trace`).

Generation is host-side (numpy) by design: arrival streams are inputs to the
simulation, exactly like the paper feeding the NLANR/Wikipedia traces in, and
keeping RNG off the device keeps the DES engine pure.

The MMPP(2) and diurnal-trace generators are VECTORIZED (batched
exponential draws + thinning over chunked numpy arrays): the seed
implementations were scalar Python while-loops that dominated setup time
at the million-job scale the ROADMAP targets.  Both draw from dedicated
``SeedSequence``-spawned child streams (modulating state / candidate gaps
/ acceptance uniforms), and candidate times are recomputed as one cumsum
over every gap drawn so far, so the output is a pure function of the seed
— bit-identical for every chunk size, including the one-candidate-at-a-
time scalar discipline the regression tests mirror.  (Outputs differ from
the pre-vectorization generators for the same seed; rates, burstiness,
and diurnal shape are unchanged.)
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "poisson_arrivals",
    "mmpp2_arrivals",
    "trace_arrivals",
    "wiki_like_trace",
    "utilization_to_rate",
]


def utilization_to_rate(rho: float, mean_service: float, n_servers: int,
                        n_cores: int) -> float:
    """Paper §III-D: rho = lambda / (mu * nServers * nCores)."""
    mu = 1.0 / mean_service
    return rho * mu * n_servers * n_cores


def poisson_arrivals(lam: float, n_jobs: int, seed: int = 0,
                     t0: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / lam, size=n_jobs)
    return t0 + np.cumsum(gaps)


def _thin(rate_at, lam_max: float, n_jobs: int, gap_rng, acc_rng,
          p_hint: float, chunk: int) -> np.ndarray:
    """Vectorized non-homogeneous Poisson sampling by thinning: candidate
    times from a rate-``lam_max`` homogeneous process, the i-th candidate
    accepted iff ``u_i·lam_max < rate_at(t_i)``.  Gap and acceptance
    draws come from dedicated streams; candidate times are one cumsum
    over ALL gaps drawn so far (np.cumsum accumulates sequentially, so
    the times are bit-identical to a scalar ``t += gap`` loop and
    invariant to chunk size).  ``p_hint`` sizes the first batch near the
    expected acceptance rate so the common case is one round."""
    if n_jobs <= 0:
        return np.empty(0)
    gaps, us = [], []
    n_acc = 0
    while n_acc < n_jobs:
        m = max(chunk, int(1.2 * (n_jobs - n_acc) / max(p_hint, 1e-6)))
        gaps.append(gap_rng.exponential(1.0 / lam_max, size=m))
        us.append(acc_rng.random(m))
        ts = np.cumsum(np.concatenate(gaps))
        acc = ts[np.concatenate(us) * lam_max < rate_at(ts)]
        n_acc = acc.size
    return acc[:n_jobs]


def mmpp2_arrivals(lam_h: float, lam_l: float, r_hl: float, r_lh: float,
                   n_jobs: int, seed: int = 0,
                   chunk: int = 16384) -> np.ndarray:
    """2-state MMPP.  State H emits at ``lam_h`` (bursty), state L at
    ``lam_l``.  ``r_hl`` is the H->L transition rate (so mean burst length is
    1/r_hl) and ``r_lh`` the L->H rate.  Burstiness is tuned via the ratio
    R_a = lam_h/lam_l or the stationary fraction of time in H (paper §III-D).

    Vectorized: the modulating chain is independent of the arrivals, so
    its sojourn trajectory is generated first (standard-exponential draws
    from a dedicated stream, scaled by the per-state rate) and arrivals
    are thinned from a rate-``max(lam_h, lam_l)`` process against the
    piecewise-constant rate.  Output depends on the seed only, not on
    ``chunk``.
    """
    state_rng, gap_rng, acc_rng = [
        np.random.default_rng(s)
        for s in np.random.SeedSequence(seed).spawn(3)]
    start_h = bool(state_rng.random() < r_lh / (r_lh + r_hl))
    lam_max = max(lam_h, lam_l)

    # modulating-state switch times, extended on demand; recomputed from
    # the full raw-draw list each extension so values never depend on how
    # far the trajectory happened to be materialized
    raws = []
    switch = np.empty(0)

    def _extend(tmax):
        nonlocal switch
        while switch.size == 0 or switch[-1] < tmax:
            n0 = sum(r.size for r in raws)
            need = max(64, int(1.2 * (tmax * 0.5 * (r_hl + r_lh) - n0)))
            raws.append(state_rng.exponential(1.0, size=need))
            raw = np.concatenate(raws)
            k = np.arange(raw.size)
            in_h = (k % 2 == 0) == start_h          # state during sojourn k
            switch = np.cumsum(raw * np.where(in_h, 1.0 / r_hl, 1.0 / r_lh))

    def rate_at(ts):
        _extend(ts[-1])
        idx = np.searchsorted(switch, ts, side="right")
        in_h = (idx % 2 == 0) == start_h
        return np.where(in_h, lam_h, lam_l)

    pi_h = r_lh / (r_lh + r_hl)
    p_hint = (pi_h * lam_h + (1.0 - pi_h) * lam_l) / lam_max
    return _thin(rate_at, lam_max, n_jobs, gap_rng, acc_rng, p_hint, chunk)


def trace_arrivals(timestamps, n_jobs: int | None = None,
                   rate_scale: float = 1.0) -> np.ndarray:
    """Replay absolute timestamps; optionally truncate and rescale rate."""
    ts = np.asarray(timestamps, dtype=np.float64)
    ts = np.sort(ts) / rate_scale
    if n_jobs is not None:
        ts = ts[:n_jobs]
    return ts


def wiki_like_trace(n_jobs: int, mean_rate: float, period: float = 600.0,
                    swing: float = 0.6, seed: int = 0,
                    chunk: int = 16384) -> np.ndarray:
    """Synthetic diurnal-fluctuation trace in the spirit of the Wikipedia
    trace [59] used by the paper's case studies: a non-homogeneous Poisson
    process whose rate follows ``mean_rate * (1 + swing*sin(2*pi*t/period))``
    (vectorized thinning; output depends on the seed only, not ``chunk``)."""
    gap_rng, acc_rng = [np.random.default_rng(s)
                        for s in np.random.SeedSequence(seed).spawn(2)]
    lam_max = mean_rate * (1.0 + swing)

    def rate_at(ts):
        return mean_rate * (1.0 + swing * np.sin(2.0 * np.pi * ts / period))

    p_hint = 1.0 / (1.0 + swing)
    return _thin(rate_at, lam_max, n_jobs, gap_rng, acc_rng, p_hint, chunk)
