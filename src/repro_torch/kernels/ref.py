"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, with the same
roundings in the same order where the kernel can repeat them (the
attention's and the scan's sums run in another order), so the kernel can
be held against it on the card and the CPU paths run through it (``ops``
dispatches CPU tensors here).  They are ports of ``repro.kernels.ref``'s
oracles.
"""
from __future__ import annotations

import math

import numpy as np
import torch

INF = 1.0e30
NEG_INF = -1.0e30
F64 = torch.float64


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``like``'s dtype and device.  Binary ops
    take it instead of a Python scalar: CUDA turns a division by a host
    scalar into a multiplication by its reciprocal, which rounds
    differently from the reference's true division.  ``torch.full`` fills
    on the device (no host-to-device copy, so no stream sync)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python constant ``c`` as the reference's compiled
    step computes it: XLA rewrites a division by a constant into a
    multiplication by the constant's reciprocal, folded in ``x``'s dtype,
    and the two differ by an ulp on some inputs."""
    if x.dtype == F64:
        return x * _const(1.0 / c, x)
    return x * _const(inv_f32(c), x)


def inv_f32(c: float) -> float:
    """The float32 reciprocal ``fl(1 / fl(c))`` that XLA folds for a
    division of a float32 value by the constant ``c``."""
    return float(np.float32(1.0) / np.float32(c))


def _round_once(x, y, dtype):
    """``x + y`` of two float64 tensors, rounded once to ``dtype``.

    The float64 sum rounds to 53 bits, and a second rounding to float32
    would differ from one rounding of the exact sum where the float64
    value lands on a float32 midpoint.  So the sum is taken to odd: its
    exact residual (Knuth's two-sum) tells whether it was inexact, and an
    inexact sum with an even last bit moves one ulp toward the exact
    value.  A float32 rounding of that is the correctly rounded exact
    sum (53 >= 24 + 2 bits).  Every step is one IEEE operation, so the
    CPU and the card give the same bits."""
    s = x + y
    if dtype == F64:
        return s
    yv = s - x
    err = (x - (s - yv)) + (y - yv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.full_like(s, torch.inf).copysign(err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(dtype)


def _fms(a, b, c, dtype):
    """``a - b * c`` rounded once to ``dtype``: for float32 operands the
    product is exact in float64, so this is the fused multiply-subtract
    the reference's compiled step computes (XLA contracts the pair into
    an FMA).  A float64 ``c`` (the float64 clock) rounds the product."""
    return _round_once(a.to(F64), -(b.to(F64) * c.to(F64)), dtype)


def _fma(a, b, c, dtype):
    """``a * b + c`` rounded once to ``dtype`` (see :func:`_fms`)."""
    return _round_once(a.to(F64) * b.to(F64), c.to(F64), dtype)


def log_bin(vals: torch.Tensor, lo: float, hi: float,
            n_bins: int) -> torch.Tensor:
    """Log-spaced histogram bin index (int64) of each value: values below
    ``lo`` clamp into bin 0, values >= ``hi`` into bin n_bins-1.

    Three roundings in the order of the reference's compiled step:
    ``max(v, lo) * fl(1 / lo)`` (XLA turns the division by the constant
    ``lo`` into a multiplication by its reciprocal, ``div_const``), then
    ``log``, then ``* scale`` with ``scale`` the Python float rounded to
    the values' dtype; then a truncating cast and a clip (clamping before
    the cast is the same map and never overflows the integer)."""
    scale = n_bins / math.log(hi / lo)
    raw = torch.log(div_const(torch.maximum(vals, _const(lo, vals)), lo)) \
        * _const(scale, vals)
    return raw.clamp(0, n_bins - 1).to(torch.int64)


def telemetry_accum_reference(job_vals, job_wts, task_vals, task_wts,
                              job_hist, task_hist, win, widx, wvals,
                              lo, hi):
    """One fused telemetry update:

      job_hist  += histogram(job_vals, weights=job_wts)   (log-spaced bins)
      task_hist += histogram(task_vals, weights=task_wts)
      win[widx] += wvals                                  (dropped when
                                                           widx is out of
                                                           range)

    Every argument may carry a leading replica batch shape (job_vals (*R,
    J), job_hist (*R, B), win (*R, W, K), widx (*R,), wvals (*R, K)); each
    replica bins into its own histograms and window.  Returns new
    (job_hist, task_hist, win); the inputs are not modified."""
    B = job_hist.shape[-1]
    jh = job_hist.scatter_add(-1, log_bin(job_vals, lo, hi, B), job_wts)
    th = task_hist.scatter_add(-1, log_bin(task_vals, lo, hi, B), task_wts)
    rows = torch.arange(win.shape[-2], device=win.device)
    w = torch.where((rows == widx[..., None])[..., None],
                    win + wvals[..., None, :], win)
    return jh, th, w


def dcsim_advance_reference(core_busy, srv_state, energy, busy_seconds,
                            t, t_next, state_power, p_core_active,
                            p_core_idle, srv_wake_at=None,
                            srv_idle_since=None, srv_tau=None,
                            throttled=None, throttle_power_scale=1.0):
    """One fused farm advance to ``t_next``:

      dt      = t_next - t                                   (f32)
      power_i = table[0] + busy_i·p_act + idle_i·p_idle  (awake servers;
                p_act scales by throttle_power_scale where throttled)
              = table[clip(state_i, 0, 5)]               (otherwise)
      energy += power·dt ; busy_seconds += busy·dt
      completions: core slots with busy_until <= t_next -> freed (INF)
      next candidate = min(surviving busy_until, wake completions,
                           idle delay-timer expiries)

    Time-typed inputs keep their dtype (an f64 clock stays f64 on the
    CPU); power and energy are f32.  Every per-server input may carry a
    leading replica batch shape (core_busy (*R, N, C), t and t_next (*R,)),
    with one candidate a replica; ``state_power`` is shared.  Returns
    (new_core_busy, done_mask, energy, busy_seconds, next_cand)."""
    C = core_busy.shape[-1]
    dev, tdt = core_busy.device, core_busy.dtype
    shape = core_busy.shape[:-1]
    if srv_wake_at is None:
        srv_wake_at = torch.full(shape, INF, dtype=tdt, device=dev)
    if srv_idle_since is None:
        srv_idle_since = torch.zeros(shape, dtype=tdt, device=dev)
    if srv_tau is None:
        srv_tau = torch.full(shape, INF, dtype=tdt, device=dev)
    f32 = torch.float32
    dt = (t_next - t).to(f32)[..., None]
    busy = (core_busy < INF).sum(dim=-1, dtype=torch.int32).to(f32)
    awake = srv_state <= 1                       # ACTIVE=0 / IDLE=1
    p_act = _const(p_core_active, busy)
    if throttled is not None:
        p_thr = _const(p_core_active * throttle_power_scale, busy)
        p_act = torch.where(throttled.to(torch.int32) != 0, p_thr, p_act)
    p_awake = state_power[0] + busy * p_act \
        + (_const(float(C), busy) - busy) * _const(p_core_idle, busy)
    p = torch.where(awake, p_awake,
                    state_power[srv_state.clamp(0, 5).to(torch.int64)])
    energy = energy + p * dt
    busy_seconds = busy_seconds + busy * dt
    done = core_busy <= t_next[..., None, None]
    new_busy = torch.where(done, _const(INF, core_busy), core_busy)
    timer = torch.where(srv_state == 1, srv_idle_since + srv_tau,
                        _const(INF, srv_idle_since))
    next_cand = torch.minimum(new_busy.amin(dim=(-2, -1)),
                              torch.minimum(srv_wake_at.amin(dim=-1),
                                            timer.amin(dim=-1)))
    return new_busy, done, energy, busy_seconds, next_cand


def mha_reference(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Dense softmax attention.  q (B, H, Sq, hd); k/v (B, KV, Skv, hd)
    with H % KV == 0 (kv head = q head // (H / KV)); any strides.  Scores,
    softmax and the value product in float32; returns (B, H, Sq, hd) in
    q's dtype.  A masked score is NEG_INF, so a row with no unmasked key
    averages every value uniformly."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    f32 = torch.float32
    qg = q.reshape(B, KV, G, Sq, hd).to(f32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(f32)) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, _const(NEG_INF, s))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(f32))
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def ssm_scan_reference(dt, Bm, Cm, x, A):
    """Selective-SSM recurrence in float32, one step at a time:

      h = exp(dt_t * A) * h + (dt_t * x_t) * B_t ;  y_t = sum_n h * C_t

    dt/x (B, S, Dss); Bm/Cm (B, S, N); A (Dss, N).  Returns (y (B, S, Dss)
    in x's dtype, h_final (B, Dss, N) float32)."""
    Bsz, S, Dss = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    dt, Bm, Cm, xf, A = (t.to(f32) for t in (dt, Bm, Cm, x, A))
    h = torch.zeros((Bsz, Dss, N), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * A[None])
        h = da * h + (dt_t * xf[:, t])[..., None] * Bm[:, t][:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, Dss))
    return y.to(x.dtype), h
