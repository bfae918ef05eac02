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


def _attn_mask(Sq, Skv, causal, window, device):
    """(Sq, Skv) bool: the unmasked (query, key) pairs."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


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
    mask = _attn_mask(Sq, Skv, causal, window, q.device)
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


def _attn_dead_rows(Sq, Skv, window, device):
    """(Sq,) bool: the query rows with no unmasked key (a window that ends
    before the first key: q >= Skv + window - 1), whose softmax is the
    uniform average of every key, so no score gets a gradient there."""
    q_pos = torch.arange(Sq, device=device)
    return (q_pos >= Skv + window - 1) if window else \
        torch.zeros(Sq, dtype=torch.bool, device=device)


def mha_lse_reference(q, k, *, causal=True, window=0, softcap=0.0):
    """Each query row's log-sum-exp of its masked scores, (B, H, Sq)
    float32, as the backward kernel recomputes it; a row with no unmasked
    key gets NEG_INF (its probabilities do not come from it)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqd,bksd->bkgqs",
                     q.reshape(B, KV, H // KV, Sq, hd).float(),
                     k.float()) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(_attn_mask(Sq, Skv, causal, window, q.device), s,
                    _const(NEG_INF, s))
    lse = torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    dead = _attn_dead_rows(Sq, Skv, window, q.device)
    return torch.where(dead, _const(NEG_INF, lse), lse)


def mha_backward_reference(q, k, v, out, lse, dout, *, causal=True,
                           window=0, softcap=0.0):
    """The gradient of ``mha_reference``: (dq, dk, dv) in the dtypes of q,
    k and v, from the forward's inputs, its output ``out`` and the output's
    gradient ``dout`` (both (B, H, Sq, hd)).  Dense, in float32, one batch
    row at a time (a (H, Sq, Skv) score block at a time bounds the memory
    at training shapes):

      P  = exp(s - lse) on unmasked scores, 0 on masked ones (s as the
           forward has it: scaled, softcapped); a row with no unmasked key
           averages every key uniformly, P = 1 / Skv, as the forward does
      D  = rowsum(dout * out)
      dS = P * (dout . v^T - D), times tanh' = 1 - (s / cap)^2 with a
           softcap; 0 where masked
      dq = dS . k * scale;  dk = sum over the G heads of a kv head of
           dS^T . q * scale;  dv = that sum of P^T . dout

    ``lse`` (B, H, Sq) float32 is each row's log-sum-exp; None recomputes
    it (``mha_lse_reference``), as the backward kernel does."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hd)
    if lse is None:
        lse = mha_lse_reference(q, k, causal=causal, window=window,
                                softcap=softcap)
    mask = _attn_mask(Sq, Skv, causal, window, q.device)
    dead = _attn_dead_rows(Sq, Skv, window, q.device)[:, None]
    dq, dk, dv = [], [], []
    for b in range(B):
        qb = q[b].reshape(KV, G, Sq, hd).to(f32)
        kb, vb = k[b].to(f32), v[b].to(f32)
        dob = dout[b].reshape(KV, G, Sq, hd).to(f32)
        ob = out[b].reshape(KV, G, Sq, hd).to(f32)
        s = torch.einsum("kgqd,ksd->kgqs", qb, kb) * scale
        if softcap:
            t = torch.tanh(s / softcap)
            s = t * softcap
        lb = lse[b].reshape(KV, G, Sq, 1).to(f32)
        p = torch.where(mask, torch.exp(s - lb),
                        torch.where(dead, _const(1.0 / Skv, s),
                                    _const(0.0, s)))
        dp = torch.einsum("kgqd,ksd->kgqs", dob, vb)
        dd = (dob * ob).sum(-1, keepdim=True)
        ds = torch.where(mask, p * (dp - dd), _const(0.0, s))
        if softcap:
            ds = ds * (1.0 - t * t)
        dq.append(torch.einsum("kgqs,ksd->kgqd", ds, kb) * scale)
        dk.append(torch.einsum("kgqs,kgqd->ksd", ds, qb) * scale)
        dv.append(torch.einsum("kgqs,kgqd->ksd", p, dob))
    return (torch.stack(dq).reshape(B, H, Sq, hd).to(q.dtype),
            torch.stack(dk).to(k.dtype), torch.stack(dv).to(v.dtype))


def ssm_scan_backward_reference(dt, Bm, Cm, x, A, dy, dh_final=None):
    """The gradient of ``ssm_scan_reference``: (ddt, dBm, dCm, dx, dA), all
    float32, from its inputs, the gradient of y (B, S, Dss) and that of
    the final state (B, Dss, N) (None: zero).  The states h_t are
    recomputed by the forward recurrence, then a reverse loop over time
    carries g_t, the gradient of h_t:

      g_t    = dy_t C_t + exp(dt_{t+1} A) g_{t+1}   (+ dh_final at S - 1)
      dC_t   = sum_d dy_t h_t            dB_t = sum_d g_t dt_t x_t
      dx_t   = dt_t sum_n g_t B_t
      ddt_t  = x_t sum_n g_t B_t + sum_n g_t h_{t-1} A exp(dt_t A)
      dA    += sum_b g_t h_{t-1} dt_t exp(dt_t A)"""
    Bsz, S, Dss = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    dt, Bm, Cm, xf, A, dy = (t.to(f32) for t in (dt, Bm, Cm, x, A, dy))
    h = torch.zeros((Bsz, Dss, N), dtype=f32, device=x.device)
    hs = [h]
    for t in range(S):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * A[None])
        h = da * h + (dt_t * xf[:, t])[..., None] * Bm[:, t][:, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh_final is None else dh_final.to(f32)
    ddt, dB, dC, dx = ([None] * S for _ in range(4))
    dA = torch.zeros_like(A)
    for t in reversed(range(S)):
        dt_t, x_t, dy_t = dt[:, t], xf[:, t], dy[:, t]
        g = g + dy_t[..., None] * Cm[:, t][:, None, :]
        dC[t] = torch.einsum("bdn,bd->bn", hs[t + 1], dy_t)
        da = torch.exp(dt_t[..., None] * A[None])
        gb = (g * Bm[:, t][:, None, :]).sum(-1)
        gh = g * hs[t] * da
        dx[t] = dt_t * gb
        ddt[t] = x_t * gb + (gh * A[None]).sum(-1)
        dB[t] = torch.einsum("bdn,bd->bn", g, dt_t * x_t)
        dA = dA + (gh * dt_t[..., None]).sum(0)
        g = g * da
    if S == 0:
        empty = xf.new_zeros((Bsz, 0, Dss))
        return empty, Bm.clone(), Cm.clone(), empty.clone(), dA
    return (torch.stack(ddt, 1), torch.stack(dB, 1), torch.stack(dC, 1),
            torch.stack(dx, 1), dA)
