"""Device-side telemetry: streaming latency histograms, windowed time series
and QoS/SLA counters inside the event loop, port of
``repro.core.telemetry`` (the thermal columns stay zero when the thermal
subsystem is off).

Latency binning runs once per macro-step through ``kernels.ops.
telemetry_accum`` (the CUDA kernel on the card, its plain version on the
CPU) over the full job and task streams with 0/1 weights; the window
series accrue per interval inside the engine's advance.  A replica batch
(a leading R on every leaf) bins every replica's streams into its own
histograms in the same single launch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import div_const
from . import power
from . import thermal as thermal_mod
from .types import (INF, SimConfig, SrvState, TaskStatus, Telemetry,
                    TelemetryConfig, lift, replace)

__all__ = ["init_telemetry", "window_values", "window_index", "window_spill",
           "accumulate_finishes", "summarize", "hist_percentile",
           "hist_mean", "bin_edges", "TelemetrySummary", "WIN_COLS"]

F32 = torch.float32
I32 = torch.int32

# ``Telemetry.win`` column layout (the reference's WIN_* constants)
WIN_OCC = 0
WIN_ACTIVE_JOBS = 1
WIN_AWAKE = 2
WIN_QDEPTH = 3
WIN_SRV_POWER = 4
WIN_SW_POWER = 5
WIN_STATE0 = 6
WIN_COOL_POWER = WIN_STATE0 + SrvState.NUM
WIN_MEAN_TEMP = WIN_COOL_POWER + 1
WIN_MAX_TEMP = WIN_MEAN_TEMP + 1
WIN_CI = WIN_MAX_TEMP + 1
WIN_PRICE = WIN_CI + 1
WIN_CARBON_G = WIN_PRICE + 1
WIN_COST = WIN_CARBON_G + 1
WIN_COLS = WIN_COST + 1
N_THERMAL_COLS = WIN_COLS - WIN_COOL_POWER


# ==========================================================================
# state init
# ==========================================================================

def init_telemetry(cfg: SimConfig, device) -> Telemetry:
    """Zeroed telemetry; 1-sized arrays when disabled."""
    tcfg = cfg.telemetry
    B = tcfg.n_bins if tcfg.enabled else 1
    W = tcfg.n_windows if tcfg.enabled else 1
    return Telemetry(
        job_hist=torch.zeros((B,), dtype=F32, device=device),
        task_hist=torch.zeros((B,), dtype=F32, device=device),
        win=torch.zeros((W, WIN_COLS), dtype=F32, device=device),
        sla_miss=torch.zeros((), dtype=I32, device=device),
        sla_total=torch.zeros((), dtype=I32, device=device),
        tail_viol=torch.zeros((), dtype=I32, device=device),
        win_overflow=torch.zeros((), dtype=F32, device=device),
    )


# ==========================================================================
# in-loop accumulation
# ==========================================================================

def window_values(state, cfg: SimConfig, dt, p_busy=None,
                  onehot=None, p_sw=None, thermal_ctx=None) -> torch.Tensor:
    """(*B, WIN_COLS) metric·dt vector for the piecewise-constant interval
    [t, t+dt), from the pre-advance state.  ``p_sw`` is the per-switch
    power ``power.switch_power(state.net, cfg)``, required in network
    mode and unused without one.  ``thermal_ctx`` optionally supplies the
    engine's (target, alpha, end temperatures, CRAC power) of the
    interval.  The carbon and price columns are closed-form interval
    integrals, so the windows sum to the accrued grams and dollars."""
    farm = state.farm
    tcfg = cfg.thermal
    dtf = dt.to(F32)
    s = state.jobs.status
    active = ((s == TaskStatus.READY) | (s == TaskStatus.QUEUED)
              | (s == TaskStatus.RUNNING)).sum(dim=-1, dtype=I32).to(F32)
    qdepth = (farm.q_len.sum(dim=-1, dtype=I32)
              + state.sched.gq_len).to(F32)
    if p_busy is None:
        throttled = state.thermal.throttled if tcfg.enabled else None
        p_busy = power.server_power(farm, cfg, throttled)
    if onehot is None:
        onehot = power.state_onehot(farm)
    p_srv = p_busy[0].sum(dim=-1)
    # padded filler rows are a suffix: keep them out of the state counts
    per_state = onehot[..., :cfg.present, :].sum(dim=-2) if cfg.has_padding \
        else onehot.sum(dim=-2)
    awake = per_state[..., SrvState.ACTIVE] + per_state[..., SrvState.IDLE]
    one = torch.ones(dtf.shape, dtype=F32, device=dtf.device)
    p_sw = p_sw.sum(dim=-1) if cfg.has_network else one * 0.0
    head = torch.stack([one, active, awake, qdepth, p_srv, p_sw], dim=-1)
    base = torch.cat([head, per_state], dim=-1) * lift(dtf)
    if not tcfg.enabled:
        return torch.cat([base, torch.zeros(dtf.shape + (N_THERMAL_COLS,),
                                            dtype=F32, device=dtf.device)],
                         dim=-1)
    t_srv = state.thermal.t_srv
    ici, ipr = thermal_mod.carbon_price_integrals(tcfg, state.t, dt)
    if thermal_ctx is None:
        target, alpha, t_end = thermal_mod.rc_step(
            state.thermal, tcfg, p_busy[0], state.t, dtf)
        p_cool = thermal_mod.cooling_power(p_busy[0], p_sw,
                                           state.thermal, tcfg)
    else:
        target, alpha, t_end, p_cool = thermal_ctx
    kw = (p_srv + p_sw + p_cool) * 1.0e-3
    if cfg.has_padding:
        # padded rows idle at the supply temperature: keep them out of
        # the farm mean and max (the padding is a suffix)
        n = cfg.present
        target, t_srv, t_end = (target[..., :n], t_srv[..., :n],
                                t_end[..., :n])
    # temperature moves exponentially within the interval: the mean column
    # integrates the closed form, the max column takes the endpoint max
    # (trajectories are monotone toward their targets)
    mean_int = target.mean(dim=-1) * dtf \
        + (t_srv - target).mean(dim=-1) * tcfg.tau_th * alpha
    max_interval = torch.maximum(t_srv, t_end).amax(dim=-1)
    therm_cols = torch.stack([
        p_cool * dtf, mean_int, max_interval * dtf, ici, ipr,
        div_const(kw * ici, 3600.0),
        div_const(kw * ipr, 3600.0)], dim=-1)
    return torch.cat([base, therm_cols], dim=-1)


def window_index(t, dt, tcfg: TelemetryConfig) -> torch.Tensor:
    """Window containing the interval midpoint, clamped into range
    (batch-shaped int32).  Clamping before the truncating cast is the
    reference's cast-then-clip for every finite midpoint and never
    overflows.  The
    midpoint is multiplied by the float32 reciprocal of ``window_dt``:
    the reference's compiled step rewrites its division by the constant
    that way, and the two differ where a midpoint sits at a window edge."""
    mid = t.to(F32) + 0.5 * dt.to(F32)
    w = div_const(mid, tcfg.window_dt)
    return w.clamp(0, tcfg.n_windows - 1).to(I32)


def window_spill(t, dt, tcfg: TelemetryConfig) -> torch.Tensor:
    """Seconds of this interval clamped into the last window because its
    midpoint lies past the n_windows·window_dt horizon."""
    mid = t.to(F32) + 0.5 * dt.to(F32)
    horizon = float(np.float32(tcfg.n_windows * tcfg.window_dt))
    dtf = dt.to(F32)
    return torch.where(mid >= horizon, dtf, torch.zeros_like(dtf))


def accumulate_finishes(telem: Telemetry, cfg: SimConfig, jobs,
                        old_job_finish, old_task_finish) -> Telemetry:
    """Bin the latencies of every job/task that finished since the finish
    arrays were captured (the INF -> finite transitions), and bump the QoS
    counters.  One kernel launch per call, whether or not anything
    finished: zero weights make a quiet step the identity, so no host
    check gates it."""
    tcfg = cfg.telemetry
    T = cfg.tasks_per_job
    new_job = (old_job_finish >= INF / 2) & (jobs.job_finish < INF / 2)
    new_task = (old_task_finish >= INF / 2) & (jobs.finish < INF / 2)
    job_lat = torch.clamp(jobs.job_finish - jobs.arrival, min=0.0)
    arr_t = torch.repeat_interleave(jobs.arrival, T, dim=-1)
    task_lat = torch.clamp(jobs.finish - arr_t, min=0.0)

    has_sla = jobs.sla < INF / 2
    miss = (new_job & has_sla & (job_lat > jobs.sla)).sum(dim=-1, dtype=I32)
    tot = (new_job & has_sla).sum(dim=-1, dtype=I32)
    tail = (new_job & (job_lat > tcfg.tail_thresh)).sum(dim=-1, dtype=I32)

    # the kernel's contract: a dummy one-row window with a zero add
    B = telem.sla_miss.shape
    K = telem.win.shape[-1]
    zwin = torch.zeros(B + (K,), dtype=F32, device=job_lat.device)
    widx = torch.zeros(B, dtype=I32, device=job_lat.device)
    jh, th, _ = ops.telemetry_accum(
        job_lat.to(F32).contiguous(), new_job.to(F32),
        task_lat.to(F32).contiguous(), new_task.to(F32),
        telem.job_hist, telem.task_hist, telem.win[..., :1, :].contiguous(),
        widx, zwin, tcfg.lat_lo, tcfg.lat_hi)
    return replace(telem, job_hist=jh, task_hist=th,
                   sla_miss=telem.sla_miss + miss,
                   sla_total=telem.sla_total + tot,
                   tail_viol=telem.tail_viol + tail)


# ==========================================================================
# host-side summarization
# ==========================================================================

def bin_edges(tcfg: TelemetryConfig) -> np.ndarray:
    """(B+1,) log-spaced histogram bin edges in seconds."""
    return tcfg.lat_lo * (tcfg.lat_hi / tcfg.lat_lo) ** (
        np.arange(tcfg.n_bins + 1) / tcfg.n_bins)


def _centers(lo: float, hi: float, n_bins: int) -> np.ndarray:
    return lo * (hi / lo) ** ((np.arange(n_bins) + 0.5) / n_bins)


def hist_percentile(hist, lo: float, hi: float, q: float) -> np.ndarray:
    """Percentile(s) from log-spaced histogram(s) (..., B): the geometric
    center of the first bin whose CDF reaches q%; NaN when empty."""
    h = np.asarray(hist, np.float64)
    B = h.shape[-1]
    total = h.sum(axis=-1)
    cdf = np.cumsum(h, axis=-1)
    target = (q / 100.0) * total[..., None]
    idx = np.clip((cdf < target).sum(axis=-1), 0, B - 1)
    vals = _centers(lo, hi, B)[idx]
    return np.where(total > 0, vals, np.nan)


def hist_mean(hist, lo: float, hi: float) -> np.ndarray:
    """Mean latency estimated from log-spaced histogram(s) (..., B)."""
    h = np.asarray(hist, np.float64)
    total = h.sum(axis=-1)
    est = (h * _centers(lo, hi, h.shape[-1])).sum(axis=-1)
    return np.where(total > 0, est / np.maximum(total, 1.0), np.nan)


@dataclasses.dataclass
class TelemetrySummary:
    """Host-side view of one run's Telemetry (numpy)."""

    job_p50: float
    job_p95: float
    job_p99: float
    task_p50: float
    task_p95: float
    task_p99: float
    mean_latency: float
    jobs_binned: int
    tasks_binned: int
    sla_miss: int
    sla_total: int
    tail_violations: int
    energy_delay_product: float
    times: np.ndarray
    occupancy: np.ndarray
    active_jobs: np.ndarray
    awake_servers: np.ndarray
    queue_depth: np.ndarray
    server_power: np.ndarray
    switch_power: np.ndarray
    state_residency: np.ndarray
    n_windows_used: int
    cooling_power: np.ndarray = None
    mean_temp: np.ndarray = None
    max_temp: np.ndarray = None
    carbon_intensity: np.ndarray = None
    price: np.ndarray = None
    carbon_per_window: np.ndarray = None
    cost_per_window: np.ndarray = None
    win_overflow: float = 0.0

    @property
    def last_window_contaminated(self) -> bool:
        return self.win_overflow > 0.0

    @property
    def sla_miss_rate(self) -> float:
        return self.sla_miss / max(self.sla_total, 1)


def _host(x, kind):
    """A batch-shaped host value: ``kind`` (float or int) of a 0-d array,
    else the array in that type (one value a replica)."""
    a = np.asarray(x)
    return kind(a) if a.ndim == 0 else a.astype(np.float64 if kind is float
                                                else np.int64)


def summarize(state, cfg: SimConfig) -> TelemetrySummary:
    """Summarize a finished SimState's telemetry on the host.  For a
    replica batch every field gains the leading R: scalars become (R,)
    arrays and series (R, W, ...)."""
    tcfg = cfg.telemetry
    if not tcfg.enabled:
        raise ValueError("telemetry was disabled for this run "
                         "(cfg.telemetry.enabled=False)")
    telem = state.telem
    jh = telem.job_hist.cpu().numpy()
    th = telem.task_hist.cpu().numpy()
    win = telem.win.cpu().numpy().astype(np.float64)
    lo, hi = tcfg.lat_lo, tcfg.lat_hi

    occ = win[..., WIN_OCC]
    norm = np.where(occ > 0, occ, np.nan)
    used = _host((occ > 0).sum(axis=-1), int)
    overflow = _host(telem.win_overflow.cpu().numpy(), float)
    # the last window absorbed the clamped tail: NaN its averages
    norm[..., -1] = np.where(np.asarray(overflow) > 0.0, np.nan,
                             norm[..., -1])
    energy = _host(state.farm.energy.cpu().numpy().sum(axis=-1), float)
    mean_lat = _host(hist_mean(jh, lo, hi), float)

    def col(k):
        return win[..., k] / norm

    def pct(h, q):
        return _host(hist_percentile(h, lo, hi, q), float)

    return TelemetrySummary(
        job_p50=pct(jh, 50), job_p95=pct(jh, 95), job_p99=pct(jh, 99),
        task_p50=pct(th, 50), task_p95=pct(th, 95), task_p99=pct(th, 99),
        mean_latency=mean_lat,
        jobs_binned=_host(jh.sum(axis=-1), int),
        tasks_binned=_host(th.sum(axis=-1), int),
        sla_miss=_host(telem.sla_miss.cpu(), int),
        sla_total=_host(telem.sla_total.cpu(), int),
        tail_violations=_host(telem.tail_viol.cpu(), int),
        # NaN where the mean is (no job binned)
        energy_delay_product=_host(np.asarray(energy) * mean_lat, float),
        times=(np.arange(tcfg.n_windows) + 0.5) * tcfg.window_dt,
        occupancy=occ,
        active_jobs=col(WIN_ACTIVE_JOBS),
        awake_servers=col(WIN_AWAKE),
        queue_depth=col(WIN_QDEPTH),
        server_power=col(WIN_SRV_POWER),
        switch_power=col(WIN_SW_POWER),
        state_residency=win[..., WIN_STATE0:WIN_STATE0 + SrvState.NUM],
        n_windows_used=used,
        cooling_power=col(WIN_COOL_POWER),
        mean_temp=col(WIN_MEAN_TEMP),
        max_temp=col(WIN_MAX_TEMP),
        carbon_intensity=col(WIN_CI),
        price=col(WIN_PRICE),
        carbon_per_window=win[..., WIN_CARBON_G],
        cost_per_window=win[..., WIN_COST],
        win_overflow=overflow,
    )
