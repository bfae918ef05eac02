"""The port's engine step by step: one macro-step from the same mid-run
state in both engines (the reference's state carried across with
``convert.state_from_numpy``), every leaf compared -- the test that
localizes a fault; a run cut by ``max_events``; macro-stepping
bit-identical across ``events_per_step``; the f64 clock; telemetry off;
the configurations the port refuses (and the thermal policies' need for
the thermal subsystem), and network mode's scope (a topology required;
NETWORK_AWARE without a network); the device rule;
and the package's independence from JAX.

Tolerances as in test_torch_slice: discrete leaves exact, float
reductions (energy, residency, busy core-seconds, telemetry windows) rtol
1e-5."""
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import engine as jengine
from repro.core import farm as jfarm
from repro.core import jobs as jjobs
from repro.core import types as jtypes
from repro_torch.convert import state_from_numpy
from repro_torch.core import engine as tengine
from repro_torch.core import farm as tfarm
from repro_torch.core import jobs as tjobs
from repro_torch.core import shard_sim
from repro_torch.core import topology as ttopo
from repro_torch.core.types import (PartitionConfig, SchedPolicy, SimConfig,
                                    TelemetryConfig, ThermalConfig,
                                    TraceConfig, TraceKind, tree_leaves)

import torch_spmd
from torch_port_util import (assert_results_equal, assert_state_matches,
                             compare_results, jax_initial, jax_run, jax_tree,
                             oracle_run,
                             port_cfg, port_run, port_simulate,
                             random_twin_states, scenario)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_jstep = jax.jit(jengine.sim_step, static_argnames=("cfg",))


@pytest.mark.parametrize("name", ["single_timer_s3", "dag_fanout",
                                  "provisioned", "wasp_pools",
                                  "overflow_dag"])
def test_one_step_from_reference_state(name):
    """Run the reference k macro-steps, carry its state across, run one
    sim_step in both engines and compare every leaf -- for each k of the
    first 12 steps, or up to the step that finishes the run."""
    jcfg, arr, specs, tau, pools = scenario(name, jjobs)
    pcfg = port_cfg(jcfg)
    js = jax_initial(jcfg, arr, specs, tau, pools)
    k = 0
    while k < 12 and not bool(js.done):
        ps = state_from_numpy(jax_tree(js), pcfg, device="cpu")
        js = _jstep(js, jcfg)
        assert_state_matches(tengine.sim_step(ps, pcfg), jax_tree(js),
                             f"{name} step {k}")
        k += 1
    assert k >= 10


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("T,policy", [(1, SchedPolicy.LOAD_BALANCE),
                                      (3, SchedPolicy.ROUND_ROBIN)])
def test_one_step_from_random_state(seed, T, policy):
    """Jobs in every status and servers in every power state at once."""
    jcfg = jtypes.SimConfig(n_servers=8, n_cores=2, local_q=6, max_jobs=40,
                            tasks_per_job=T, sched_policy=policy,
                            sleep_policy=jtypes.SleepPolicy.SINGLE_TIMER)
    js, ps, _ = random_twin_states(jcfg, seed)
    assert_state_matches(tengine.sim_step(ps, port_cfg(jcfg)),
                         jax_tree(_jstep(js, jcfg)), f"random {seed}")


def test_truncated_run_matches_jax():
    """A run cut by max_events stops at the same macro-step in both."""
    jcfg, arr, specs, tau, pools = scenario("dag_chain", jjobs,
                                            max_events=61)
    tspecs = scenario("dag_chain", tjobs)[2]
    final = port_run(port_cfg(jcfg), arr, tspecs, tau, pools)
    assert not bool(final.done) and int(final.events) >= 61
    assert_state_matches(final, jax_tree(jax_run(jcfg, arr, specs, tau,
                                                 pools)), "truncated")


@pytest.mark.parametrize("name", ["overflow_dag", "dag_fanout",
                                  "rr_overflow"])
def test_events_per_step_bit_identical(name):
    """K in {1, 4, 16}: the masked cheap passes retire the same events as
    the reference's early-exit loop, so only the step count differs."""
    jcfg, arr, _, tau, pools = scenario(name, jjobs)
    specs = scenario(name, tjobs)[2]
    outs = {k: port_run(port_cfg(jcfg, events_per_step=k), arr, specs, tau,
                        pools) for k in (1, 4, 16)}
    ref = dict(tree_leaves(outs[1]))
    for k in (4, 16):
        for path, v in tree_leaves(outs[k]):
            if path != "steps":
                assert torch.equal(v, ref[path]), f"K={k}: {path}"
        assert int(outs[k].steps) < int(outs[1].steps)


def test_f64_clock_matches_oracle_and_f32_run():
    jcfg, arr, jspecs, tau, _ = scenario("single_timer_s3", jjobs)
    specs = scenario("single_timer_s3", tjobs)[2]
    pcfg = port_cfg(jcfg)
    r32 = tfarm.simulate(pcfg, arr, specs, tau=tau, device="cpu")
    r64 = tfarm.simulate(dataclasses.replace(pcfg,
                                             time_dtype=torch.float64),
                         arr, specs, tau=tau, device="cpu")
    assert r64.run_info.config["time_dtype"] == "float64"
    assert r64.n_finished == r32.n_finished == len(arr)
    orc = oracle_run(jcfg, arr, jspecs, tau)
    for res in (r64, r32):
        np.testing.assert_allclose(np.sort(res.latencies),
                                   np.sort(orc.latencies()), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(res.server_energy, orc.total_energy(),
                                   rtol=2e-3)
    np.testing.assert_array_equal(r64.wake_count, r32.wake_count)
    np.testing.assert_allclose(r64.latencies, r32.latencies, rtol=1e-4,
                               atol=1e-6)
    # the f64 run is the closer one to the oracle's float64 clock
    err64 = np.abs(np.sort(r64.latencies) - np.sort(orc.latencies())).max()
    err32 = np.abs(np.sort(r32.latencies) - np.sort(orc.latencies())).max()
    assert err64 <= err32


_SCOPE_CASES = [
    (dict(thermal=ThermalConfig(enabled=True),
          trace=TraceConfig(enabled=True)), "item 8"),
    (dict(trace=TraceConfig(enabled=True)), "item 8"),
    (dict(partition=dataclasses.replace(SimConfig().partition, n_shards=2)),
     "item 10"),
    (dict(use_vectorized_hot_loop=False), "item 12"),
    (dict(sched_policy=SchedPolicy.THERMAL_AWARE,
          thermal=ThermalConfig(enabled=True), use_vectorized_hot_loop=False),
     "item 12"),
    (dict(has_network=True, thermal=ThermalConfig(enabled=True),
          partition=dataclasses.replace(SimConfig().partition, n_shards=2)),
     "item 10"),
    (dict(sched_policy=SchedPolicy.CARBON_AWARE,
          thermal=ThermalConfig(enabled=True),
          trace=TraceConfig(enabled=True)), "item 8"),
]


# rack sharding's cases run on a star with two racks of two servers
_ITEM10_NET = dict(topo=ttopo.star(4), racks=[0, 0, 1, 1])


@pytest.fixture(scope="module")
def item10_on_two_ranks():
    """The "item 10" cases' farm.simulate on two CPU ranks (one spawn for
    both): [(by n_shards, by mesh)] per case, for every rank."""
    cases = [(SimConfig(n_servers=4, max_jobs=8, **kw), [0.1],
              [tjobs.dag_single(0.01)],
              _ITEM10_NET if kw.get("has_network") else {})
             for kw, item in _SCOPE_CASES if item == "item 10"]
    return cases, shard_sim.spawn(torch_spmd.plan, 2,
                                    ([("simulate_runs", (cases,))],))


@pytest.mark.parametrize("kw,item", _SCOPE_CASES)
def test_out_of_scope_configurations_are_refused(kw, item, request,
                                                 tmp_path):
    """The configurations once refused, each naming the Queue 1 item that
    brought it, now finish: the flight recorder (item 8) decodes its
    ring; rack sharding (item 10, network and thermal among them) equals
    the unsharded run on a mesh of 1 and on two ranks; the seed scalar
    paths (item 12, thermal on as well) equal the vectorized run."""
    cfg = SimConfig(n_servers=4, max_jobs=8, **kw)
    if item == "item 10":
        net = _ITEM10_NET if cfg.has_network else {}
        args = ([0.1], [tjobs.dag_single(0.01)])
        exp = tfarm.simulate(dataclasses.replace(
            cfg, partition=PartitionConfig()), *args, device="cpu", **net)
        assert exp.n_finished == 1
        dist.init_process_group("gloo",
                                init_method=f"file://{tmp_path}/store",
                                rank=0, world_size=1)
        try:
            got = tfarm.simulate(cfg, *args, device="cpu",
                                 mesh=shard_sim.make_mesh(1, device="cpu"),
                                 **net)
        finally:
            dist.destroy_process_group()
        assert got.run_info.mesh_shape == (1,)
        assert_results_equal(got, exp, f"{kw}: K=1")
        cases, ranks = request.getfixturevalue("item10_on_two_ranks")
        at = [c[0] for c in cases].index(cfg)
        for r, (results, mods) in enumerate(ranks):
            assert not mods, mods
            for got in results[0][at]:
                assert got.run_info.mesh_shape == (2,)
                assert_results_equal(got, exp, f"{kw}: K=2 rank {r}")
        return
    if item == "item 8":
        res = tfarm.simulate(cfg, [0.1], [tjobs.dag_single(0.01)],
                             device="cpu")
        assert res.n_finished == 1 and res.trace_dropped == 0
        kinds = res.trace_events["kind"].tolist()
        assert kinds == [TraceKind.ARRIVAL, TraceKind.ADMIT,
                         TraceKind.START, TraceKind.FINISH,
                         TraceKind.JOB_FINISH]
        assert res.trace_events["time"][-1] == pytest.approx(0.11)
        return
    assert item == "item 12" and not cfg.use_vectorized_hot_loop
    args = ([0.1, 0.1, 0.2], [tjobs.dag_single(0.01)] * 3)
    got = tfarm.simulate(cfg, *args, device="cpu")
    exp = tfarm.simulate(dataclasses.replace(
        cfg, use_vectorized_hot_loop=True), *args, device="cpu")
    assert got.n_finished == 3
    assert (got.run_info.events, got.run_info.steps) == \
        (exp.run_info.events, exp.run_info.steps)
    assert_results_equal(dataclasses.replace(got, run_info=None),
                         dataclasses.replace(exp, run_info=None),
                         f"{kw}: scalar vs vectorized")


@pytest.mark.parametrize("policy", [SchedPolicy.THERMAL_AWARE,
                                    SchedPolicy.CARBON_AWARE])
def test_thermal_policies_need_the_thermal_subsystem(policy):
    """As in the reference's init_state: a thermal policy with the
    subsystem off would silently ignore what it scores or defers by."""
    cfg = SimConfig(n_servers=4, max_jobs=8, sched_policy=policy)
    with pytest.raises(ValueError, match="thermal.enabled=True"):
        tfarm.simulate(cfg, [0.1], [tjobs.dag_single(0.01)], device="cpu")
    on = dataclasses.replace(cfg, thermal=ThermalConfig(enabled=True))
    assert tfarm.simulate(on, [0.1], [tjobs.dag_single(0.01)],
                          device="cpu").n_finished == 1


def test_network_without_topology_is_refused():
    """Network mode runs since the network slice; without a topology its
    flows could never route, so it raises, as the reference does."""
    cfg = SimConfig(n_servers=4, max_jobs=8, tasks_per_job=2,
                    has_network=True)
    args = (cfg, [0.1], [tjobs.dag_chain([0.01, 0.02], edge_bytes=1e6)])
    with pytest.raises(ValueError, match="topo="):
        tfarm.simulate(*args, device="cpu")
    jt = tjobs.build_jobs(cfg, np.asarray([0.1]), args[2], device="cpu")
    with pytest.raises(ValueError, match="topo="):
        tengine.init_state(cfg, jt)
    # a state and constants built without the topology cannot run it
    state, tc = tengine.init_state(
        dataclasses.replace(cfg, has_network=False), jt)
    for consts in (None, tc):
        with pytest.raises(ValueError, match="topology"):
            tengine.run(state, cfg, consts)


def test_network_aware_without_network_matches_jax():
    """NETWORK_AWARE with no network has no wake cost to add: the score is
    the load, with the dual timer's pool bias, as in the reference."""
    jcfg, arr, jspecs, tau, pools = scenario(
        "dual_timer_pools", jjobs, sched_policy=SchedPolicy.NETWORK_AWARE)
    tspecs = scenario("dual_timer_pools", tjobs)[2]
    jres = jfarm.simulate(jcfg, arr, jspecs, tau=tau, pools=pools)
    tres, final = port_simulate(port_cfg(jcfg), arr, tspecs, tau=tau,
                                pools=pools)
    assert tres.n_finished == len(arr)
    compare_results(tres, jres)
    assert_state_matches(final, jax_tree(jax_run(jcfg, arr, jspecs, tau,
                                                 pools)), "network aware")


def test_telemetry_off_runs_and_skips_binning():
    jcfg, arr, jspecs, tau, _ = scenario(
        "single_timer_c6", jjobs, telemetry=jtypes.TelemetryConfig(
            enabled=False))
    tspecs = scenario("single_timer_c6", tjobs)[2]
    pcfg = port_cfg(jcfg)
    assert pcfg.telemetry == TelemetryConfig(enabled=False)
    res, final = port_simulate(pcfg, arr, tspecs, tau=tau)
    assert res.telemetry is None and res.n_finished == len(arr)
    assert_state_matches(final, jax_tree(jax_run(jcfg, arr, jspecs, tau)),
                         "telemetry off")


def test_device_rule(monkeypatch):
    """CUDA by default; the CPU only when asked; never a quiet fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (SimConfig(n_servers=2, max_jobs=4), [0.1],
            [tjobs.dag_single(0.01)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfarm.simulate(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        tfarm.simulate(*args, device="meta")
    assert tfarm.simulate(*args, device="cpu").n_finished == 1


def test_device_rule_engine_entry(monkeypatch):
    """The engine's own entry (build_jobs -> init_state -> run) and the
    state converter follow the same rule as simulate."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(n_servers=2, max_jobs=4)
    arr, specs = np.asarray([0.1]), [tjobs.dag_single(0.01)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tjobs.build_jobs(cfg, arr, specs)
    with pytest.raises(ValueError, match="unsupported device"):
        tjobs.build_jobs(cfg, arr, specs, device="meta")
    jt = tjobs.build_jobs(cfg, arr, specs, device="cpu")
    state, tc = tengine.init_state(cfg, jt)
    assert state.t.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_numpy({p: v.numpy() for p, v in tree_leaves(state)}, cfg)
    final = tengine.run(state, cfg, tc)
    assert bool(final.done) and int(final.jobs.tasks_done.sum()) == 1


def _python(code, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "sys.argv = ['chip_smoke.py']\n"
        "import chip_smoke\n"
        "import repro_torch, repro_torch.convert\n"
        "import repro_torch.core.trace, repro_torch.core.traceio\n"
        "import repro_torch.core.shard_sim, repro_torch.sharding.partition\n"
        "import repro_torch.analysis.simlint, repro_torch.analysis.matrix\n"
        "from repro_torch.core import *\n"
        "from repro_torch.kernels import *\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = _python(code, ROOT, {"PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    """No result line and a non-zero exit without a card, and in a
    directory holding chip_smoke.py and nothing else of the repository."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs = [tmp_path]
    if not torch.cuda.is_available():
        runs.append(ROOT)
    for cwd in runs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={k: v for k, v in os.environ.items()
                                  if k != "PYTHONPATH"})
        assert out.returncode != 0, cwd
        assert '"ok": true' not in out.stdout, cwd
