"""Each function of the port's ``core/thermal.py`` against
``repro.core.thermal`` on seeded numpy inputs: init (contiguous and
irregular racks, scalar and per-rack setpoints, the ambient, the
controller), the inlet (static, per-rack, ambient), COP and cooling
power, the closed-form carbon and price integrals, the RC advance, the
throttle latch and stretch, the crossing solve (its guard band,
``crossing_guard=INF`` and the large-t progress floor), the setpoint
controller and the deferral signals and release time; f32 and f64
clocks.  The reference's functions run jitted, as the engine runs them.

Tolerances: integer and boolean results, the setpoints, the stretched
clock values and the release times exact (no elementary function feeds
them); temperatures, powers and the crossing times rtol 1e-5 (exp, log,
sin and cos round differently in XLA:CPU and in the port by an ulp); the
closed-form integrals rtol 1e-5 plus one ulp of each cosine carried
through the integral, base * |swing| * 2^-23 / w: their cosine difference
cancels, so that ulp is the formula's own floor.  The gated reference and
the port's unconditional stretch, crossing solve, controller tick and
release pass are bit-identical where the gate is closed."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import thermal as jth
from repro.core import topology as jtopo
from repro.core import types as jtypes
from repro_torch.convert import _rack_marker
from repro_torch.core import engine as tengine
from repro_torch.core import thermal as tth
from repro_torch.core import topology as ttopo
from repro_torch.core.types import INF, ThermalState

from torch_port_util import (HOT, check_leaf, port_cfg, random_twin_states,
                             to_np)

F32 = np.float32


def _therm_from_jax(jt) -> ThermalState:
    kw = {}
    for f in dataclasses.fields(ThermalState):
        v = np.asarray(getattr(jt, f.name))
        kw[f.name] = _rack_marker(v, "cpu") if f.name == "rack_onehot" \
            else torch.from_numpy(np.array(v))
    return ThermalState(**kw)


def _twins(tkw, n=12, racks=None, seed=0, **cfg_kw):
    """(reference cfg, port cfg, reference ThermalState, port ThermalState)
    with random temperatures around 40-60 C, a random latch and random
    setpoints."""
    jcfg = jtypes.SimConfig(n_servers=n, n_cores=2,
                            thermal=jtypes.ThermalConfig(**tkw), **cfg_kw)
    pcfg = port_cfg(jcfg)
    jt = jth.init_thermal(jcfg, racks)
    rng = np.random.default_rng(seed)
    R = np.asarray(jt.rack_inv).shape[0]
    jt = dataclasses.replace(
        jt, t_srv=jnp.asarray(rng.uniform(40, 60, n), jnp.float32),
        throttled=jnp.asarray(rng.random(n) < 0.4),
        t_set=jnp.asarray(rng.uniform(15, 27, R).round(), jnp.float32))
    return jcfg, pcfg, jt, _therm_from_jax(jt)


def _check_clock(got, exp, clock, ctx):
    """A clock-typed leaf: the port keeps the configured clock's dtype; the
    reference without jax_enable_x64 computes an f64 clock in f32, so the
    values are compared, exactly."""
    assert got.dtype == clock, ctx
    exp = np.asarray(exp)
    np.testing.assert_array_equal(to_np(got).astype(exp.dtype), exp,
                                  err_msg=ctx)


def _close(got, exp, ctx, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(exp), rtol=rtol,
                               atol=atol, err_msg=ctx)


RACKS = {"contiguous": None, "irregular": np.array([0, 0, 0, 0, 1, 1, 2, 2,
                                                    2, 3, 3, 3])}


@pytest.mark.parametrize("clock", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("tkw", [
    dict(HOT), dict(HOT, t_setpoint=(16.0, 26.0, 20.0, 18.0)),
    dict(HOT, t_setpoint=18.0, ambient_swing=3.0, ambient_period=40.0,
         ambient_phase=7.0, ctrl_period=0.5)])
@pytest.mark.parametrize("racks", list(RACKS))
def test_init_thermal_matches(racks, tkw, clock):
    jcfg = jtypes.SimConfig(n_servers=12, n_cores=2, time_dtype=clock,
                            thermal=jtypes.ThermalConfig(**tkw))
    pcfg = port_cfg(jcfg)
    jt = jth.init_thermal(jcfg, RACKS[racks])
    pt = tth.init_thermal(pcfg, "cpu", RACKS[racks])
    for f in dataclasses.fields(ThermalState):
        exp = np.asarray(getattr(jt, f.name))
        if f.name == "rack_onehot":
            exp = _rack_marker(exp, "cpu").numpy()
        if f.name == "ctrl_next":
            _check_clock(pt.ctrl_next, exp, pcfg.time_dtype, f.name)
            continue
        check_leaf(getattr(pt, f.name), exp, f"{racks} {f.name}", 0.0)
    assert (pt.rack_onehot.numel() == 0) == (racks == "contiguous")


def test_init_thermal_disabled_and_topology_racks():
    jcfg = jtypes.SimConfig(n_servers=16)
    jt, pt = jth.init_thermal(jcfg), tth.init_thermal(port_cfg(jcfg), "cpu")
    for f in dataclasses.fields(ThermalState):
        check_leaf(getattr(pt, f.name), np.asarray(getattr(jt, f.name)),
                   f.name, 0.0)
    for name, args in (("fat_tree", (4,)), ("star", (6,)),
                       ("camcube", (2, 2, 2))):
        np.testing.assert_array_equal(
            ttopo.rack_of_servers(getattr(ttopo, name)(*args), 4),
            jtopo.rack_of_servers(getattr(jtopo, name)(*args), 4))
    with pytest.raises(ValueError, match="t_setpoint"):
        tth.init_thermal(port_cfg(jtypes.SimConfig(
            n_servers=12, thermal=jtypes.ThermalConfig(
                **HOT, t_setpoint=(1.0, 2.0)))), "cpu")


@pytest.mark.parametrize("racks", list(RACKS))
@pytest.mark.parametrize("tkw", [
    dict(HOT), dict(HOT, t_setpoint=(16.0, 26.0, 20.0, 18.0)),
    dict(HOT, ambient_swing=3.0, ambient_period=40.0, ambient_phase=2.0),
    dict(HOT, t_setpoint=20.0, ctrl_period=0.5, ambient_swing=1.5)])
def test_inlet_cop_and_cooling_match(tkw, racks):
    jcfg, pcfg, jt, pt = _twins(tkw, racks=RACKS[racks], seed=1)
    tcfg, pc = jcfg.thermal, pcfg.thermal
    for t in (0.0, 3.7, 86400.25):
        _close(tth.inlet_temps(pt, pc, torch.tensor(F32(t))),
               jax.jit(lambda th, x: jth.inlet_temps(th, tcfg, x))(
                   jt, jnp.float32(t)), f"inlet t={t}")
    sup = np.linspace(12, 27, 31).astype(F32)
    _close(tth.cop_at(pc, torch.from_numpy(sup)), jth.cop_at(tcfg, sup),
           "cop")
    p = np.random.default_rng(2).uniform(60, 120, 12).astype(F32)
    _close(tth.cooling_power(torch.from_numpy(p), torch.tensor(F32(37.5)),
                             pt, pc),
           jax.jit(lambda th: jth.cooling_power(
               jnp.asarray(p), jnp.float32(37.5), th, tcfg))(jt), "cooling")


@pytest.mark.parametrize("t,dt", [(0.0, 0.013), (5.3, 0.4), (61.0, 2.5),
                                  (86400.0, 0.01), (1234.5, 60.0)])
def test_carbon_price_integrals_match(t, dt):
    tcfg = jtypes.ThermalConfig(**HOT, carbon_period=120.0, carbon_swing=0.5,
                                carbon_phase=11.0, price_period=600.0)
    pc = port_cfg(jtypes.SimConfig(thermal=tcfg)).thermal
    got = tth.carbon_price_integrals(pc, torch.tensor(F32(t)),
                                     torch.tensor(F32(dt)))
    exp = jax.jit(lambda a, b: jth.carbon_price_integrals(tcfg, a, b))(
        jnp.float32(t), jnp.float32(dt))
    for g, e, (base, swing, period) in zip(got, exp, (
            (tcfg.carbon_base, tcfg.carbon_swing, tcfg.carbon_period),
            (tcfg.price_base, tcfg.price_swing, tcfg.price_period))):
        floor = base * abs(swing) * 2.0 ** -23 / (2 * math.pi / period)
        _close(g, e, f"integral t={t}", atol=floor)


@pytest.mark.parametrize("clock", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("tkw", [
    dict(HOT, t_throttle=50.0, t_release=45.0, throttle_power_scale=0.6),
    dict(HOT, t_setpoint=(16.0, 26.0, 20.0, 18.0), ambient_swing=3.0,
         ambient_period=40.0)])
def test_advance_matches(tkw, clock):
    jcfg, pcfg, jt, pt = _twins(tkw, seed=3)
    p = np.random.default_rng(4).uniform(60, 120, 12).astype(F32)
    t = np.asarray(2.75, clock)
    dt = np.asarray(0.031, clock)
    got = tth.advance(pt, pcfg, torch.from_numpy(p),
                      torch.tensor(F32(12.5)), torch.from_numpy(t),
                      torch.from_numpy(dt))
    exp = jth.advance(jt, jcfg, jnp.asarray(p), jnp.float32(12.5),
                      jnp.asarray(t, jnp.float32), jnp.asarray(dt,
                                                               jnp.float32))
    for f in ("t_srv", "t_peak", "throttle_seconds", "cool_energy",
              "carbon_g", "cost"):
        _close(getattr(got, f), getattr(exp, f), f)
    check_leaf(tth.effective_freq(pt, pcfg),
               jth.effective_freq(jt, jcfg), "effective_freq", 0.0)


def _state_twins(tkw, seed, t=1.0, near=None, spread=3.0, **cfg_kw):
    """A random mid-run state of both engines with the thermal subtree
    randomized; ``near`` puts the temperatures within ``spread`` C of
    it."""
    jcfg = jtypes.SimConfig(n_servers=8, n_cores=2, local_q=6, max_jobs=40,
                            thermal=jtypes.ThermalConfig(**tkw), **cfg_kw)
    js, _, tree = random_twin_states(jcfg, seed, t=t)
    rng = np.random.default_rng(seed + 100)
    lo, hi = (40.0, 60.0) if near is None else (near - spread,
                                                near + spread)
    tree["thermal.t_srv"] = rng.uniform(lo, hi, 8).astype(F32)
    tree["thermal.throttled"] = rng.random(8) < 0.5
    from repro_torch.convert import state_from_numpy
    from torch_port_util import jax_state_from_tree
    js = jax_state_from_tree(js, tree)
    return jcfg, port_cfg(jcfg), js, state_from_numpy(
        {k: np.asarray(v) for k, v in tree.items()}, port_cfg(jcfg),
        device="cpu")


THROTTLE = dict(HOT, t_throttle=50.0, t_release=45.0, throttle_freq=0.5,
                throttle_power_scale=0.6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_throttle_matches(seed):
    jcfg, pcfg, js, ps = _state_twins(THROTTLE, seed, near=47.5,
                                      spread=6.0)
    farm, jobs, therm = tth.apply_throttle(ps.farm, ps.jobs, ps.thermal,
                                           pcfg, ps.t)
    ef, ej, et = jax.jit(lambda s: jth.apply_throttle(
        s.farm, s.jobs, s.thermal, jcfg, s.t))(js)
    assert bool((therm.throttled != ps.thermal.throttled).any())
    check_leaf(therm.throttled, et.throttled, "throttled")
    check_leaf(farm.core_busy_until, ef.core_busy_until, "core_busy_until",
               0.0)
    check_leaf(jobs.task_end, ej.task_end, "task_end", 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_unconditional_throttle_is_identity_when_nothing_flips(seed):
    """Temperatures between the release and engage thresholds: nobody
    flips, so the reference skips its stretch; the port's always runs and
    returns every leaf bit for bit, as the reference does."""
    jcfg, pcfg, js, ps = _state_twins(THROTTLE, seed, near=47.5)
    t = np.random.default_rng(seed).uniform(45.5, 49.5, 8).astype(F32)
    ps.thermal.t_srv = torch.from_numpy(t)
    js = dataclasses.replace(js, thermal=dataclasses.replace(
        js.thermal, t_srv=jnp.asarray(t)))
    farm, jobs, therm = tth.apply_throttle(ps.farm, ps.jobs, ps.thermal,
                                           pcfg, ps.t)
    ef, ej, et = jax.jit(lambda s: jth.apply_throttle(
        s.farm, s.jobs, s.thermal, jcfg, s.t))(js)
    for got, was, exp in ((farm.core_busy_until, ps.farm.core_busy_until,
                           ef.core_busy_until),
                          (jobs.task_end, ps.jobs.task_end, ej.task_end),
                          (therm.throttled, ps.thermal.throttled,
                           et.throttled)):
        assert torch.equal(got, was)
        check_leaf(got, exp, "identity", 0.0)


@pytest.mark.parametrize("guard", [8.0, INF])
@pytest.mark.parametrize("near", [47.5, 20.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_next_crossing_matches(seed, near, guard):
    """Servers near the thresholds, or all far below them (the reference's
    band gate closed: INF, bit for bit, unless the guard is INF)."""
    tkw = dict(THROTTLE, crossing_guard=guard, recirc=0.0)
    jcfg, pcfg, js, ps = _state_twins(tkw, seed, near=near)
    got = tth.next_crossing(ps, pcfg)
    exp = jax.jit(lambda s: jth.next_crossing(s, jcfg))(js)
    assert (float(got) >= INF / 2) == (float(exp) >= INF / 2)
    if float(exp) >= INF / 2:
        check_leaf(got, exp, "no crossing", 0.0)
    else:
        _close(got, exp, "crossing time", rtol=1e-6)
    if near == 20.0 and guard == 8.0:
        assert float(got) >= INF / 2


@pytest.mark.parametrize("clock", [torch.float32, torch.float64])
def test_next_crossing_large_t_makes_a_tick(clock):
    """A crossing solved 0.1 ms ahead at t = 86,400 s: the f32 clock (ulp
    7.8 ms) lands one tick past t (jnp.nextafter in the reference), the
    f64 clock at the solved time."""
    jcfg, pcfg, js, ps = _state_twins(dict(THROTTLE, recirc=0.0, r_th=1.0,
                                           t_throttle=60.0), 0, t=86400.0)
    pcfg = dataclasses.replace(pcfg, time_dtype=clock)
    ps.t = torch.tensor(86400.0, dtype=clock)
    ps.thermal.throttled = torch.zeros(8, dtype=torch.bool)
    ps.thermal.t_srv = torch.full((8,), 60.0 - 2e-3)   # a hair below
    ps.farm.srv_state = torch.zeros(8, dtype=torch.int32)
    got = tth.next_crossing(ps, pcfg)
    assert got.dtype == clock
    tick = torch.nextafter(ps.t, torch.tensor(INF, dtype=clock))
    if clock == torch.float32:
        assert float(got) == float(tick)
    else:
        assert float(tick) < float(got) < 86400.0 + 1e-3


@pytest.mark.parametrize("clock", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("racks", list(RACKS))
@pytest.mark.parametrize("now", [0.25, 0.5, 86400.0])
def test_setpoint_ctrl_matches(now, racks, clock):
    tkw = dict(HOT, t_setpoint=20.0, ctrl_period=0.5, ctrl_target=50.0,
               ctrl_band=2.0, ctrl_min=14.0, ctrl_max=27.0)
    jcfg, pcfg, jt, pt = _twins(tkw, racks=RACKS[racks], seed=5,
                                time_dtype=clock)
    if now == 86400.0:
        jt = dataclasses.replace(jt, ctrl_next=jnp.asarray(86400.0, clock))
        pt.ctrl_next = torch.tensor(86400.0, dtype=pcfg.time_dtype)
    pt.ctrl_next = pt.ctrl_next.to(pcfg.time_dtype)
    nw = np.asarray(now, clock)
    got = tth.apply_setpoint_ctrl(pt, pcfg, torch.from_numpy(nw))
    exp = jth.apply_setpoint_ctrl(jt, jcfg, jnp.asarray(nw))
    check_leaf(got.t_set, exp.t_set, "t_set", 0.0)
    _check_clock(got.ctrl_next, exp.ctrl_next, pcfg.time_dtype, "ctrl_next")
    if now == 0.25:        # before the tick: unchanged, bit for bit
        assert torch.equal(got.t_set, pt.t_set)
        assert torch.equal(got.ctrl_next, pt.ctrl_next)


@pytest.mark.parametrize("signal", ["carbon", "price"])
@pytest.mark.parametrize("thr", [320.0, 100.0, 600.0, INF])
def test_deferral_signals_and_release_time_match(thr, signal):
    tcfg = jtypes.ThermalConfig(**HOT, carbon_base=300.0, carbon_swing=0.6,
                                carbon_period=120.0, carbon_phase=5.0,
                                price_base=0.2, price_swing=0.5,
                                price_period=90.0, defer_signal=signal,
                                defer_threshold=thr if signal == "carbon"
                                else (0.22 if thr < INF / 2 else INF))
    pc = port_cfg(jtypes.SimConfig(thermal=tcfg)).thermal
    ts = np.random.default_rng(6).uniform(0, 500, 64).astype(F32)
    for fn in ("defer_signal_now", "carbon_intensity_now"):
        _close(getattr(tth, fn)(pc, torch.from_numpy(ts)),
               jax.jit(lambda x: getattr(jth, fn)(tcfg, x))(ts), fn)
    check_leaf(tth.next_release_time(pc, torch.from_numpy(ts)),
               jax.jit(lambda x: jth.next_release_time(tcfg, x))(ts),
               "release", 0.0)


def test_release_time_keeps_an_f64_clock():
    """An f64 clock keeps f64 release times: the shift runs in float64,
    equal to the same closed form evaluated in numpy."""
    tcfg = jtypes.ThermalConfig(**HOT, carbon_base=300.0, carbon_swing=0.6,
                                carbon_period=120.0, defer_threshold=320.0)
    pc = port_cfg(jtypes.SimConfig(thermal=tcfg)).thermal
    t = np.array([86400.123456789, 3.5, 1e6 + 0.25])
    got = tth.next_release_time(pc, torch.from_numpy(t))
    assert got.dtype == torch.float64
    w = 2 * math.pi / 120.0
    s = (320.0 / 300.0 - 1.0) / 0.6
    th = math.pi - math.asin(s)
    k = np.ceil((t * w - th) / (2 * math.pi))
    np.testing.assert_array_equal(got.numpy(), (k * (2 * math.pi) + th) / w)
    assert (got.numpy() >= t).all()


def test_release_pass_is_identity_when_nothing_is_due():
    """The reference gates _apply_releases on a due job; the port's pass
    always runs and leaves the state bit for bit as it was when none is
    due, and releases like the reference when some are."""
    tkw = dict(HOT, carbon_base=300.0, carbon_swing=0.6, carbon_period=120.0,
               defer_threshold=320.0)
    jcfg, pcfg, js, ps = _state_twins(
        tkw, 3, sched_policy=jtypes.SchedPolicy.CARBON_AWARE)
    out = tengine._apply_releases(ps, pcfg)
    for a, b in zip(dataclasses.astuple(out.jobs),
                    dataclasses.astuple(ps.jobs)):
        assert torch.equal(a, b)
    for a, b in zip(dataclasses.astuple(out.thermal),
                    dataclasses.astuple(ps.thermal)):
        assert torch.equal(a, b)
    # park three arrived jobs' roots, due now: both engines release them
    J = ps.jobs.arrival.shape[0]
    n_arr = int(ps.jobs.arr_ptr)
    due = np.full(J, INF, F32)
    due[[0, 2, n_arr - 1]] = F32(float(ps.t))
    status = ps.jobs.status.numpy().copy()
    status[[0, 2, n_arr - 1]] = jtypes.TaskStatus.BLOCKED
    ps.jobs.admit_at = torch.from_numpy(due)
    ps.jobs.status = torch.from_numpy(status)
    js = dataclasses.replace(js, jobs=dataclasses.replace(
        js.jobs, admit_at=jnp.asarray(due), status=jnp.asarray(status)))
    got = tengine._apply_releases(ps, pcfg)
    exp = jax.jit(lambda s: jengine._apply_releases(s, jcfg))(js)
    for f in ("server", "status", "admit_at"):
        check_leaf(getattr(got.jobs, f), getattr(exp.jobs, f), f, 0.0)
    check_leaf(got.thermal.defer_count, exp.thermal.defer_count, "count")
    _close(got.thermal.defer_seconds, exp.thermal.defer_seconds, "seconds")
    _close(got.thermal.grams_avoided, exp.thermal.grams_avoided, "grams")
    assert int(got.thermal.defer_count) == 3
