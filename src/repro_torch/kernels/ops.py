"""Dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel (which raises on what it
cannot take -- nothing falls back); a CPU tensor goes to the plain PyTorch
version in ``ref``.  ``launch_counts`` reads each kernel's launch counter;
``reset_launch_counts`` zeroes them, flash attention's per-instance
counts and the advance's per-clock counts.
"""
from __future__ import annotations

from . import dcsim_step, flash_attention as _fa, ref, ssm_scan as _ssm, \
    telemetry_bin


def _route(x, name):
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {x.device}")


def dcsim_advance(core_busy, srv_state, energy, busy_seconds, t, t_next,
                  state_power, p_core_active, p_core_idle,
                  srv_wake_at=None, srv_idle_since=None, srv_tau=None,
                  throttled=None, *, throttle_power_scale=1.0):
    """Fused farm advance (see ``ref.dcsim_advance_reference``)."""
    fn = dcsim_step.dcsim_advance if _route(core_busy, "dcsim_advance") \
        else ref.dcsim_advance_reference
    return fn(core_busy, srv_state, energy, busy_seconds, t, t_next,
              state_power, p_core_active, p_core_idle, srv_wake_at,
              srv_idle_since, srv_tau, throttled,
              throttle_power_scale=throttle_power_scale)


def telemetry_accum(job_vals, job_wts, task_vals, task_wts,
                    job_hist, task_hist, win, widx, wvals, lo, hi):
    """Fused histogram binning (see ``ref.telemetry_accum_reference``)."""
    fn = telemetry_bin.telemetry_accum if _route(job_vals, "telemetry_accum") \
        else ref.telemetry_accum_reference
    return fn(job_vals, job_wts, task_vals, task_wts, job_hist, task_hist,
              win, widx, wvals, lo, hi)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Streaming-softmax attention, q (B, H, Sq, hd), k/v (B, KV, Skv, hd)
    (see ``ref.mha_reference``)."""
    fn = _fa.flash_attention if _route(q, "flash_attention") \
        else ref.mha_reference
    return fn(q, k, v, causal=causal, window=window, softcap=softcap)


def ssm_scan(dt, Bm, Cm, x, A):
    """Selective-SSM scan returning (y, h_final) (see
    ``ref.ssm_scan_reference``)."""
    fn = _ssm.ssm_scan if _route(x, "ssm_scan") else ref.ssm_scan_reference
    return fn(dt, Bm, Cm, x, A)


_KERNELS = {"dcsim_advance": dcsim_step, "telemetry_accum": telemetry_bin,
            "flash_attention": _fa, "ssm_scan": _ssm}


def launch_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.LAUNCHES = 0
    dcsim_step.CLOCK_LAUNCHES.update(dict.fromkeys(dcsim_step.CLOCK_LAUNCHES,
                                                   0))
    _fa.INSTANCE_LAUNCHES.update(dict.fromkeys(_fa.INSTANCE_LAUNCHES, 0))
