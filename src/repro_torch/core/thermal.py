"""Thermal / cooling / carbon-cost subsystem, port of ``repro.core.thermal``.

The power accounted by ``power.py`` becomes heat, heat becomes cooling
load, and both become grams of CO2 and dollars, with two couplings back
into the simulation: temperature-triggered throttling and thermal-aware
placement.

Per-server RC dynamics ``T' = (P r_th - (T - T_inlet)) / tau_th`` with
power piecewise constant between events, so the closed form

    T += (P r_th + T_inlet - T) (1 - exp(-dt / tau_th))

integrates them exactly; the inlet (rack supply temperature plus the
rack-mean recirculated excess, plus the diurnal ambient) is held constant
over each interval.  Cooling power is IT power over the CRAC's quadratic
COP at its supply setpoint (per rack when the control plane is on);
carbon intensity and price are diurnal sinusoids integrated in closed
form over each interval.  Throttling is a hysteresis latch whose
threshold crossings are solved on the exponential and become events.

Every ``lax.cond`` of the reference is masked tensor work here: the
throttle stretch, the crossing solve and the controller tick run every
time and write only where their masks say, so nothing waits for the
device.  The closed-form series compute in float32 after casting the
clock, as the reference does, on any clock.

The card and the CPU take the same event sequence.  The crossing times
are solved from the temperatures, and a farm of identical servers has
crossings within an ulp of each other, so an ulp of difference anywhere
upstream can merge or split two events.  So every elementary function
(exp, log, sin, cos) is evaluated in float64 and rounded once to float32,
which is the correctly rounded result on both devices except where the
float64 value lies within about 2^-29 of a float32 rounding boundary, and
every per-rack sum adds the rack's servers one at a time in ascending
order (PyTorch's CUDA reductions add in another order than its CPU
ones).

A thermal state may carry a leading replica batch shape, on every leaf,
the rack tables included; sums and maxima run along the trailing axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.ref import _const, div_const
from . import power
from .types import (INF, SimConfig, TaskStatus, ThermalConfig, ThermalState,
                    lift, replace, take)

__all__ = ["init_thermal", "member_table", "ambient_host", "ambient",
           "inlet_temps", "cop_at", "cooling_power", "rate_integral",
           "carbon_price_integrals", "effective_freq", "rc_step", "advance",
           "apply_throttle", "next_crossing", "apply_setpoint_ctrl",
           "defer_signal_now", "carbon_intensity_now", "next_release_time",
           "TEMP_TOL"]

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32
I64 = torch.int64

# flip tolerance (C): crossings land within f32 rounding of the threshold,
# so the hysteresis predicate accepts T >= t_throttle - TEMP_TOL
TEMP_TOL = 1.0e-3
# relative overshoot applied to solved crossing times so the integrated
# temperature lands past the threshold
_CROSS_EPS = 1.0e-5


def init_thermal(cfg: SimConfig, device, racks=None) -> ThermalState:
    """The initial thermal state on ``device``.  ``racks`` is an optional
    (N,) host array of rack ids (``topology.rack_of_servers``); the
    default grouping is ``i // cfg.thermal.rack_size``.  Built on the host
    with numpy; 1-sized placeholders when the subsystem is off.  Irregular
    groupings get an (R, K) member table (each rack's servers ascending,
    -1 padded) in place of the reference's (R, N) membership matrix."""
    tcfg = cfg.thermal
    tdt = cfg.time_dtype

    def dev(a, dtype):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    def zeros(shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    if not tcfg.enabled:
        return ThermalState(
            t_srv=zeros((1,)), throttled=zeros((1,), torch.bool),
            rack_id=zeros((1,), I32), rack_onehot=zeros((1, 1)),
            rack_inv=zeros((1,)), t_set=zeros((1,)),
            ctrl_next=torch.full((), INF, dtype=tdt, device=device),
            t_peak=zeros((1,)), throttle_seconds=zeros((1,)),
            cool_energy=zeros(()), carbon_g=zeros(()), cost=zeros(()),
            defer_seconds=zeros(()), defer_count=zeros((), I32),
            grams_avoided=zeros(()))

    N = cfg.n_servers
    if racks is None:
        racks = np.arange(N) // max(tcfg.rack_size, 1)
    racks = np.asarray(racks, np.int64)
    if racks.shape != (N,):
        raise ValueError(f"racks must be ({N},), got {racks.shape}")
    _, dense = np.unique(racks, return_inverse=True)      # 0..R-1
    dense = dense.reshape(-1)
    R = int(dense.max()) + 1
    counts = np.bincount(dense, minlength=R)
    # contiguous equal-size blocks (the i // rack_size default and every
    # built-in topology grouping) reduce by reshape, marked by an empty
    # (0, 0) table as in the reference; anything else through the table
    contiguous = N % R == 0 and (counts == N // R).all() \
        and (dense == np.arange(N) // (N // R)).all()
    members = np.zeros((0, 0), np.int32)
    if not contiguous:
        members = member_table(dense, R)
    sp = tcfg.t_inlet if tcfg.t_setpoint is None else tcfg.t_setpoint
    try:
        t_set = np.broadcast_to(np.asarray(sp, np.float32), (R,))
    except ValueError:
        raise ValueError(
            f"t_setpoint must be a scalar or length-{R} (one per rack) "
            f"sequence, got {np.asarray(sp).shape}") from None
    # servers start at their own rack's supply temperature
    t0 = t_set[dense] + np.float32(ambient_host(tcfg, 0.0))
    ctrl_next = tcfg.ctrl_period if tcfg.has_ctrl else INF
    return ThermalState(
        t_srv=dev(t0, F32), throttled=zeros((N,), torch.bool),
        rack_id=dev(dense, I32),
        rack_onehot=dev(members, F32 if contiguous else I32),
        rack_inv=dev(1.0 / counts, F32), t_set=dev(t_set, F32),
        ctrl_next=torch.full((), ctrl_next, dtype=tdt, device=device),
        t_peak=dev(t0, F32), throttle_seconds=zeros((N,)),
        cool_energy=zeros(()), carbon_g=zeros(()), cost=zeros(()),
        defer_seconds=zeros(()), defer_count=zeros((), I32),
        grams_avoided=zeros(()))


def member_table(rack_id, R: int) -> np.ndarray:
    """(R, K) int32: each rack's server ids ascending, -1 padded to the
    largest rack's size K (host side)."""
    rack_id = np.asarray(rack_id)
    order = np.argsort(rack_id, kind="stable")
    counts = np.bincount(rack_id, minlength=R)
    table = np.full((R, max(int(counts.max()), 1)), -1, np.int32)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for r in range(R):
        table[r, :counts[r]] = order[start[r]:start[r] + counts[r]]
    return table


# ==========================================================================
# continuous models
# ==========================================================================

def _f64_once(fn, x) -> torch.Tensor:
    """``fn`` of a float32 tensor, evaluated in float64 and rounded once to
    float32 (the same on the CPU and the card)."""
    return fn(x.to(F64)).to(F32)


def _exp(x):
    return _f64_once(torch.exp, x)


def _log(x):
    return _f64_once(torch.log, x)


def _sin(x):
    return _f64_once(torch.sin, x)


def _cos(x):
    return _f64_once(torch.cos, x)


def ambient_host(tcfg: ThermalConfig, t: float) -> float:
    """Host-side diurnal ambient offset at time ``t`` (C)."""
    if tcfg.ambient_swing == 0.0:
        return 0.0
    w = 2.0 * math.pi / tcfg.ambient_period
    return tcfg.ambient_swing * math.sin(w * (t + tcfg.ambient_phase))


def _sin_at(t, period: float, phase: float):
    """sin(2 pi (t + phase) / period) in float32 after casting ``t``."""
    tf = t.to(F32)
    return _sin((tf + phase) * (2.0 * math.pi / period))


def ambient(tcfg: ThermalConfig, t) -> torch.Tensor:
    """Diurnal ambient offset at time ``t`` (0-d f32, C)."""
    s = _sin_at(t, tcfg.ambient_period, tcfg.ambient_phase)
    return _const(tcfg.ambient_swing, s) * s


def _contiguous(therm: ThermalState) -> bool:
    return therm.rack_onehot.shape[-1] == 0


def _rack_columns(therm: ThermalState, vals, fill: float):
    """(*B, R, K) view of a per-server vector by rack: a reshape for
    contiguous equal racks, else a gather through the member table with
    ``fill`` in the padding (never an (R, N) matrix)."""
    R = therm.rack_inv.shape[-1]
    if _contiguous(therm):
        return vals.unflatten(-1, (R, -1))
    table = therm.rack_onehot
    got = take(vals, table.clamp(min=0))
    return torch.where(table >= 0, got, torch.full((), fill,
                                                   dtype=vals.dtype,
                                                   device=vals.device))


# racks up to this many servers are summed one server at a time; a larger
# one (a star topology's single rack) in one reduction, in PyTorch's order
SEQ_RACK_MAX = 64


def _rack_sums(therm: ThermalState, vals) -> torch.Tensor:
    """(*B, R) per-rack sums of a per-server vector, each rack's servers
    added one at a time in ascending order (the reference's order; the
    padding adds exact zeros)."""
    cols = _rack_columns(therm, vals, 0.0)
    if cols.shape[-1] > SEQ_RACK_MAX:
        return cols.sum(dim=-1)
    acc = cols[..., 0]
    for j in range(1, cols.shape[-1]):
        acc = acc + cols[..., j]
    return acc


def _per_server(therm: ThermalState, rack_vals) -> torch.Tensor:
    """(*B, N) each server's entry of a (*B, R) per-rack vector."""
    return take(rack_vals, therm.rack_id)


def inlet_temps(therm: ThermalState, tcfg: ThermalConfig,
                t=None) -> torch.Tensor:
    """(N,) per-server inlet: rack supply temperature plus recirc times the
    rack-mean excess.  The supply temperature is ``t_inlet`` on the static
    path, or the per-rack ``t_set`` (plus the ambient at ``t``) when the
    control plane is on."""
    if not tcfg.per_rack and not tcfg.ambient_on:
        excess = therm.t_srv - tcfg.t_inlet
        mean = _rack_sums(therm, excess) * therm.rack_inv
        return _per_server(therm, mean) * tcfg.recirc + tcfg.t_inlet
    base_r = therm.t_set
    if tcfg.ambient_on:
        base_r = base_r + lift(ambient(tcfg, t))
    base = _per_server(therm, base_r)
    excess = therm.t_srv - base
    mean = _rack_sums(therm, excess) * therm.rack_inv
    return base + _per_server(therm, mean) * tcfg.recirc


def cop_at(tcfg: ThermalConfig, t_sup) -> torch.Tensor:
    """Quadratic COP at supply temperature(s) ``t_sup``."""
    return t_sup * tcfg.cop_a * t_sup + t_sup * tcfg.cop_b + tcfg.cop_c


def cooling_power(p_srv, p_sw, therm: ThermalState,
                  tcfg: ThermalConfig) -> torch.Tensor:
    """CRAC power (W) for the per-server IT load ``p_srv`` (N,) plus the
    switch load ``p_sw`` (0-d).  Uniform setpoints divide by the static
    COP; per-rack setpoints cool each rack's load at its own COP and the
    switches at the mean setpoint's."""
    if not tcfg.per_rack:
        tot = p_srv.sum(dim=-1) + p_sw
        return div_const(tot, tcfg.cop)
    rack_p = _rack_sums(therm, p_srv)
    return (rack_p / cop_at(tcfg, therm.t_set)).sum(dim=-1) \
        + p_sw / cop_at(tcfg, therm.t_set.mean(dim=-1))


def rate_integral(base: float, swing: float, period: float, phase: float,
                  t1, t2) -> torch.Tensor:
    """Closed-form integral of base (1 + swing sin(2 pi (t + phase) /
    period)) dt over [t1, t2), in float32 after casting the clock."""
    w = 2.0 * math.pi / period
    t1f, t2f = t1.to(F32), t2.to(F32)
    lin = t2f - t1f
    osc = div_const(_cos((t1f + phase) * w) - _cos((t2f + phase) * w), w)
    return (osc * swing + lin) * base


def carbon_price_integrals(tcfg: ThermalConfig, t, dt):
    """(integral of carbon intensity, integral of price) over [t, t+dt)."""
    t2 = t + dt
    ci = rate_integral(tcfg.carbon_base, tcfg.carbon_swing,
                       tcfg.carbon_period, tcfg.carbon_phase, t, t2)
    pr = rate_integral(tcfg.price_base, tcfg.price_swing,
                       tcfg.price_period, tcfg.price_phase, t, t2)
    return ci, pr


def effective_freq(therm: ThermalState, cfg: SimConfig) -> torch.Tensor:
    """(N,) effective core frequency under the throttle latch."""
    full = torch.full((), cfg.core_freq, dtype=F32,
                      device=therm.t_srv.device)
    slow = torch.full((), cfg.core_freq * cfg.thermal.throttle_freq,
                      dtype=F32, device=therm.t_srv.device)
    return torch.where(therm.throttled, slow, full)


def rc_step(therm: ThermalState, tcfg: ThermalConfig, p_srv, t, dtf):
    """(target, alpha, end temperatures) of the RC update over an interval
    of ``dtf`` seconds from ``t`` at per-server power ``p_srv``."""
    target = p_srv * tcfg.r_th + inlet_temps(therm, tcfg, t)
    alpha = 1.0 - _exp(div_const(-dtf, tcfg.tau_th))
    return target, alpha, therm.t_srv + (target - therm.t_srv) * lift(alpha)


# ==========================================================================
# in-loop updates
# ==========================================================================

def advance(therm: ThermalState, cfg: SimConfig, p_srv, p_sw, t, dt,
            t_new=None, p_cool=None) -> ThermalState:
    """Integrate temperatures, cooling energy, carbon and cost over
    [t, t+dt).  ``p_srv`` (N,) is the pre-advance (throttle-scaled)
    per-server power, ``p_sw`` the total switch power; ``t_new`` and
    ``p_cool`` optionally supply the end temperatures and CRAC power the
    engine already computed for the telemetry windows."""
    tcfg = cfg.thermal
    dtf = dt.to(F32)
    if t_new is None:
        t_new = rc_step(therm, tcfg, p_srv, t, dtf)[2]
    # temperature is monotone toward its target within the interval, so
    # the endpoint max is the running peak
    t_peak = torch.maximum(therm.t_peak, t_new)
    throttle_s = therm.throttle_seconds + therm.throttled.to(F32) * lift(dtf)
    p_it = p_srv.sum(dim=-1) + p_sw
    if p_cool is None:
        p_cool = cooling_power(p_srv, p_sw, therm, tcfg)
    ici, ipr = carbon_price_integrals(tcfg, t, dt)
    kw = (p_it + p_cool) * 1.0e-3
    return replace(
        therm, t_srv=t_new, t_peak=t_peak, throttle_seconds=throttle_s,
        cool_energy=therm.cool_energy + p_cool * dtf,
        carbon_g=therm.carbon_g + div_const(kw * ici, 3600.0),
        cost=therm.cost + div_const(kw * ipr, 3600.0))


def apply_throttle(farm, jobs, therm: ThermalState, cfg: SimConfig, now):
    """Hysteresis latch update and in-flight work stretch at ``now``.

    Servers crossing ``t_throttle`` upward engage, servers cooled to the
    release threshold disengage; the remaining service of in-flight work
    on a server that flipped rescales about ``now`` by the frequency
    ratio, in core space (``core_busy_until``) and in task space
    (``task_end``) with the same expression.  The reference gates the
    stretch on any flip; here it always runs, and every write is masked by
    the flip, so it is the identity when nothing flips.  Returns (farm,
    jobs, therm)."""
    tcfg = cfg.thermal
    thr = tcfg.t_throttle
    rel = min(tcfg.t_release, tcfg.t_throttle)
    t = therm.t_srv
    engage = ~therm.throttled & (t >= thr - TEMP_TOL)
    release = therm.throttled & (t <= rel + TEMP_TOL)
    new_throttled = (therm.throttled | engage) & ~release
    changed = new_throttled != therm.throttled

    tf = torch.full((), tcfg.throttle_freq, dtype=F32, device=t.device)
    one = torch.ones((), dtype=F32, device=t.device)
    ratio = torch.where(therm.throttled, tf, one) \
        / torch.where(new_throttled, tf, one)                    # (N,)
    bu = farm.core_busy_until
    now2 = lift(now, 2)
    in_flight = (bu < INF) & (bu > now2) & changed[..., None]
    bu = torch.where(in_flight, now2 + (bu - now2) * ratio[..., None], bu)

    srv = jobs.server.clamp(min=0).to(I64)
    te = jobs.task_end
    now1 = lift(now)
    run = (jobs.status == TaskStatus.RUNNING) & (te < INF) & (te > now1) \
        & take(changed, srv) & (jobs.server >= 0)
    te = torch.where(run, now1 + (te - now1) * take(ratio, srv), te)
    return (replace(farm, core_busy_until=bu), replace(jobs, task_end=te),
            replace(therm, throttled=new_throttled))


def next_crossing(state, cfg: SimConfig) -> torch.Tensor:
    """Earliest throttle engage/release threshold crossing (batch-shaped,
    in the clock's dtype; INF if none): the RC exponential solved for the
    time it reaches the pending threshold, for the servers within
    ``crossing_guard`` C of it.  The reference solves only when some
    server is in that band; here the solve always runs and is INF where
    no server is near, which is the same value.  The result is at least
    one representable tick past ``state.t``, so a sub-ulp solved interval
    at a large clock still makes progress."""
    tcfg = cfg.thermal
    therm = state.thermal
    tdt = cfg.time_dtype
    t = therm.t_srv
    thr = tcfg.t_throttle
    rel = min(tcfg.t_release, tcfg.t_throttle)
    guard = tcfg.crossing_guard
    near_up = ~therm.throttled & (t >= thr - guard)
    near_dn = therm.throttled & (t <= rel + guard)
    p_srv, _ = power.server_power(state.farm, cfg, throttled=therm.throttled)
    # the inlet is held at its value at state.t, the target the interval
    # integrator uses, so the solved crossing is exact for it
    target = p_srv * tcfg.r_th + inlet_temps(therm, tcfg, state.t)
    two = torch.full((), 2.0, dtype=F32, device=t.device)

    def solve(valid, num, den):
        arg = torch.where(valid, num / den, two)
        return torch.where(valid & (arg > 1.0), _log(arg) * tcfg.tau_th, INF)

    up = near_up & (t < thr - TEMP_TOL) & (target > thr)
    dn = near_dn & (t > rel + TEMP_TOL) & (target < rel)
    dt_min = torch.minimum(solve(up, target - t, target - thr),
                           solve(dn, t - target, rel - target)).amin(dim=-1)
    t_cross = (state.t + dt_min * (1.0 + _CROSS_EPS) + 1.0e-9).to(tdt)
    tick = torch.nextafter(state.t.to(tdt),
                           torch.full((), INF, dtype=tdt, device=t.device))
    t_cross = torch.maximum(t_cross, tick)
    return torch.where(dt_min < INF / 2, t_cross, INF).to(tdt)


# ==========================================================================
# control plane: setpoint controller and carbon-aware deferral
# ==========================================================================

def apply_setpoint_ctrl(therm: ThermalState, cfg: SimConfig,
                        now) -> ThermalState:
    """Per-rack setpoint controller tick at ``now``, masked by ``now >=
    ctrl_next`` (the reference's cond).  Each rack whose hottest server
    exceeds ``ctrl_target`` lowers its supply setpoint by ``ctrl_step``;
    racks below ``ctrl_target - ctrl_band`` raise it; clipped into
    [ctrl_min, ctrl_max]."""
    tcfg = cfg.thermal
    tdt = cfg.time_dtype
    rack_max = _rack_columns(therm, therm.t_srv, -INF).amax(dim=-1)
    down = rack_max > tcfg.ctrl_target
    up = ~down & (rack_max < tcfg.ctrl_target - tcfg.ctrl_band)
    step = torch.full((), tcfg.ctrl_step, dtype=F32, device=rack_max.device)
    t_set = (therm.t_set - torch.where(down, step, 0.0)
             + torch.where(up, step, 0.0)).clamp(tcfg.ctrl_min,
                                                 tcfg.ctrl_max)
    # at least one representable tick of progress
    nxt = torch.maximum(
        (therm.ctrl_next + tcfg.ctrl_period).to(tdt),
        torch.nextafter(now.to(tdt), torch.full((), INF, dtype=tdt,
                                                device=now.device)))
    tick = now >= therm.ctrl_next
    return replace(therm, t_set=torch.where(lift(tick), t_set, therm.t_set),
                   ctrl_next=torch.where(tick, nxt, therm.ctrl_next))


def _defer_params(tcfg: ThermalConfig):
    """(base, swing, period, phase) of the deferral signal's sinusoid."""
    if tcfg.defer_signal == "price":
        return (tcfg.price_base, tcfg.price_swing, tcfg.price_period,
                tcfg.price_phase)
    if tcfg.defer_signal != "carbon":
        raise ValueError(f"defer_signal must be 'carbon' or 'price', "
                         f"got {tcfg.defer_signal!r}")
    return (tcfg.carbon_base, tcfg.carbon_swing, tcfg.carbon_period,
            tcfg.carbon_phase)


def _sinusoid_now(base, swing, period, phase, t) -> torch.Tensor:
    s = _sin_at(t, period, phase)
    return _const(base, s) * (s * swing + 1.0)


def defer_signal_now(tcfg: ThermalConfig, t) -> torch.Tensor:
    """Instantaneous deferral signal (carbon gCO2/kWh or price $/kWh)."""
    return _sinusoid_now(*_defer_params(tcfg), t)


def carbon_intensity_now(tcfg: ThermalConfig, t) -> torch.Tensor:
    """Instantaneous grid carbon intensity (gCO2/kWh) at ``t``."""
    return _sinusoid_now(tcfg.carbon_base, tcfg.carbon_swing,
                         tcfg.carbon_period, tcfg.carbon_phase, t)


def next_release_time(tcfg: ThermalConfig, t) -> torch.Tensor:
    """Earliest t' >= t at which the deferral signal sits at or below
    ``defer_threshold``: the solved down-crossing of the sinusoid (INF
    when the signal never crosses down, when only deadlines admit).  The
    trigonometry is host constants; the traced shift runs in ``t``'s own
    dtype, so an f64 clock keeps f64 release times."""
    base, swing, period, phase = _defer_params(tcfg)
    thr = tcfg.defer_threshold
    inf32 = torch.full((), INF, dtype=F32, device=t.device)
    if base <= 0.0 or swing == 0.0 or thr >= INF / 2:
        return inf32
    s = (thr / base - 1.0) / swing
    if s >= 1.0 or s <= -1.0:
        return inf32
    w = 2.0 * math.pi / period
    theta_dn = math.pi - math.asin(s)    # sin decreasing through s
    k = torch.ceil(div_const((t + phase) * w - theta_dn, 2.0 * math.pi))
    return (div_const(k * (2.0 * math.pi) + theta_dn, w) - phase
            ).to(t.dtype)
