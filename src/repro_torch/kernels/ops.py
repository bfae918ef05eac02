"""Dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel (which raises on what it
cannot take -- nothing falls back); a CPU tensor goes to the plain PyTorch
version in ``ref``.  ``launch_counts`` reads each kernel's launch counter.
"""
from __future__ import annotations

from . import dcsim_step, ref, telemetry_bin


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


def launch_counts() -> dict:
    return {"dcsim_advance": dcsim_step.LAUNCHES,
            "telemetry_accum": telemetry_bin.LAUNCHES}


def reset_launch_counts() -> None:
    dcsim_step.LAUNCHES = 0
    telemetry_bin.LAUNCHES = 0
