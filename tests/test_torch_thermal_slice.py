"""The thermal slice end to end: every scenario of tests/test_thermal.py
(trace off here; tests/test_torch_trace_slice.py runs the traced ones,
and the replica sweep waits for ROADMAP Queue 1 item 9) through the
port's farm.simulate on the CPU against the JAX package's, and against
the heapq ``OracleSim`` where it models the case; network mode on case
D's k=4 fat-tree with topology racks; macro-stepping bit-identical
across ``events_per_step``; temperature tracking bit-identical to the
subsystem off; and the f64 clock, against the reference with
jax_enable_x64 (run in a subprocess: the flag is process-wide), the
oracle and the f32 run.

Tolerances.  Against JAX: discrete state exact (task status, server,
queue lengths, wake counts, the throttle latch, deferral counts, the
setpoints, event and step counts, the config digest, the latency
histograms); floats within rtol 1e-5 (``TOL_LEAVES`` and
``compare_thermal_results`` in tests/torch_port_util.py): temperatures,
energies, cooling, carbon, cost and the window series.  exp, log, sin and
cos round differently in XLA:CPU and in the port by an ulp, so with
throttling armed the solved crossing times, and with them the clock's
leaves, may sit a few ulps apart: those runs hold the clock's leaves at
rtol 1e-5 too (``CLOCK_LEAVES``), every other run exactly.  Against the
oracle, test_thermal.py's own tolerances: latencies rtol/atol 1e-3,
temperatures rtol 2e-3 atol 0.05 C, cooling, carbon and cost rel 2e-3,
throttle seconds rel 5e-3."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core.types import tree_leaves

from torch_port_util import (CLOCK_LEAVES, THERMAL_SCENARIOS,
                             assert_state_matches,
                             assert_windows_within_clock_tol, jax_x64_finals,
                             oracle_run, port_run, port_simulate,
                             thermal_scenario, thermal_three_way)


@pytest.mark.parametrize("name", list(THERMAL_SCENARIOS))
def test_thermal_scenario_matches_jax(name):
    tres, jres = thermal_three_way(name)
    if "throttle" in name or name in ("exact_crossing", "control_plane",
                                      "k_sweep"):
        assert tres.throttle_seconds > 0.0
    if name in ("deferral", "deadline", "release_train", "parked_dag",
                "k_sweep"):
        assert tres.deferred_jobs > 0
    if name in ("control_plane", "setpoint_controller"):
        assert tres.run_info.config["thermal"]["ctrl_period"] > 0
    assert np.isfinite(tres.peak_temp) and tres.cooling_energy > 0


def test_exact_crossing_is_analytic():
    """One busy server, recirc off: throttling engages at the solved RC
    crossing and the job finishes at the stretched completion time."""
    cfg, arr, specs, _, _ = thermal_scenario("exact_crossing", "port")
    res = port_simulate(cfg, arr, specs)[0]
    tcfg, sp = cfg.thermal, cfg.server_power
    target = tcfg.t_inlet + (sp.p_base + sp.p_core_active) * tcfg.r_th
    t_cross = tcfg.tau_th * math.log((target - tcfg.t_inlet)
                                     / (target - tcfg.t_throttle))
    expect = t_cross + (4.0 - t_cross) / tcfg.throttle_freq
    assert res.latencies[0] == pytest.approx(expect, rel=1e-3)
    assert res.throttle_seconds == pytest.approx(expect - t_cross, rel=1e-3)


def test_tiny_crossing_at_large_t_makes_progress():
    """At t = 86,400 s (f32 ulp about 8 ms) a sub-ulp solved crossing
    still advances the clock by at least one tick."""
    cfg, arr, specs, _, _ = thermal_scenario("tiny_crossing_large_t", "port")
    res = port_simulate(cfg, arr, specs)[0]
    assert res.n_finished == 1 and res.events < 200
    assert 0.0 < res.throttle_seconds < 10.0


def test_tracking_only_is_bit_identical_to_disabled():
    """Temperature tracking without throttling or thermal placement leaves
    every non-thermal leaf bit-identical to the subsystem off."""
    cfg, arr, specs, tau, _ = thermal_scenario("oracle_timer", "port")
    off = port_run(dataclasses.replace(cfg, thermal=dataclasses.replace(
        cfg.thermal, enabled=False)), arr, specs, tau)
    on = port_run(cfg, arr, specs, tau)
    ref = dict(tree_leaves(off))
    for path, v in tree_leaves(on):
        if path == "telem.win":
            n = v.shape[1] - 7                       # the thermal columns
            assert torch.equal(v[:, :n], ref[path][:, :n])
        elif not path.startswith("thermal."):
            assert torch.equal(v, ref[path]), path
    assert float(on.thermal.t_peak.max()) > cfg.thermal.t_inlet


@pytest.mark.parametrize("name", ["k_sweep", "control_plane"])
def test_events_per_step_bit_identical(name):
    """K in {1, 4, 8}: throttle crossings, controller ticks and releases
    stop the cheap passes where the reference's gate does, so only the
    step count differs."""
    cfg, arr, specs, tau, _ = thermal_scenario(name, "port")
    outs = {k: port_run(dataclasses.replace(cfg, events_per_step=k), arr,
                        specs, tau) for k in (1, 4, 8)}
    ref = dict(tree_leaves(outs[1]))
    for k in (4, 8):
        for path, v in tree_leaves(outs[k]):
            if path != "steps":
                assert torch.equal(v, ref[path]), f"K={k}: {path}"
        assert int(outs[k].steps) < int(outs[1].steps)


X64_SCENARIOS = ["control_plane", "deferral", "thermal_aware",
                 "release_train", "oracle_timer_throttle"]


@pytest.fixture(scope="module")
def x64_finals(tmp_path_factory):
    return jax_x64_finals(X64_SCENARIOS, tmp_path_factory.mktemp("x64"))


@pytest.mark.parametrize("name", X64_SCENARIOS)
def test_f64_clock_matches_jax_x64(name, x64_finals):
    """The f64 clock against the reference with jax_enable_x64 (network
    mode excepted: the reference raises there, ROADMAP Queue 3), every
    leaf, with the same tolerances as the f32 runs."""
    cfg, arr, specs, tau, _ = thermal_scenario(name, "port",
                                               time_dtype=torch.float64)
    res, final = port_simulate(cfg, arr, specs, tau=tau)
    assert res.n_finished == len(arr) and final.t.dtype == torch.float64
    tree = x64_finals[name]
    if cfg.thermal.throttling:
        assert_state_matches(final, tree, name, skip=("telem.win",),
                             tol=CLOCK_LEAVES)
        assert_windows_within_clock_tol(final.telem.win.numpy(),
                                        tree["telem.win"], float(final.t),
                                        name)
    else:
        assert_state_matches(final, tree, name)


@pytest.mark.parametrize("name", ["control_plane", "deferral"])
def test_f64_clock_matches_oracle_and_f32_run(name):
    """The f64 clock widens only the clock's leaves; its run stays within
    the oracle's tolerances and agrees with the f32 run on every count.
    (The JAX side would need jax_enable_x64 for the whole process.)"""
    jcfg, arr, jspecs, tau, _ = thermal_scenario(name, "jax")
    cfg, _, specs, _, _ = thermal_scenario(name, "port")
    r32, f32 = port_simulate(cfg, arr, specs, tau=tau)
    r64, f64 = port_simulate(dataclasses.replace(cfg,
                                                 time_dtype=torch.float64),
                             arr, specs, tau=tau)
    assert f64.thermal.ctrl_next.dtype == torch.float64
    assert f64.jobs.admit_at.dtype == torch.float64
    assert f64.thermal.t_srv.dtype == torch.float32
    assert r64.n_finished == r32.n_finished == len(arr)
    assert r64.events == r32.events and r64.deferred_jobs == r32.deferred_jobs
    np.testing.assert_array_equal(r64.setpoints, r32.setpoints)
    # the f32 run's clock carries its ulp at the run's end
    np.testing.assert_allclose(r64.latencies, r32.latencies, rtol=1e-4,
                               atol=4 * np.spacing(np.float32(r32.sim_time)))
    orc = oracle_run(jcfg, arr, jspecs, tau)
    np.testing.assert_allclose(np.sort(r64.latencies),
                               np.sort(orc.latencies()), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(r64.temps, orc.temp, rtol=2e-3, atol=5e-2)
    assert r64.deferred_jobs == orc.defer_count
    np.testing.assert_allclose(r64.cooling_energy, orc.cool_energy,
                               rtol=2e-3)
