"""Network mode end to end: flows over a topology through the port's
``farm.simulate(..., topo=...)`` on the CPU against the JAX package's, and
against the heapq ``OracleSim`` where it models the case (the fluid model
on a star: tests/test_network_flows.py's scenario without the trace, and
its ``max_flows=2`` slot exhaustion).  Case study D's configuration on a
k=4 fat-tree under LOAD_BALANCE, NETWORK_AWARE and ROUND_ROBIN, and the
packet model on the star, against JAX alone; one macro-step from a
reference mid-run network state; macro-stepping bit-identical across
``events_per_step``; and the f64 clock, held against the oracle and the
port's f32 run (the reference cannot run network mode on an f64 clock:
ROADMAP Queue 3).

Against JAX: discrete state (task status, server, queue lengths, wake
counts, drops, flows dropped, port and line-card states, awake switches,
link flow counts, event and step counts), the latency histograms and the
config digest exact; latencies, energies, switch energy and the window
series within rtol 1e-5.  Against the oracle: latency rtol/atol 1e-4,
server energy rel 2e-3."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import network as jnet
from repro_torch.convert import state_from_numpy
from repro_torch.core import engine as tengine
from repro_torch.core.types import tree_leaves

from torch_port_util import (NETWORK_JAX_SCENARIOS, NETWORK_ORACLE_SCENARIOS,
                             assert_state_matches, check_oracle, jax_initial,
                             jax_tree, net_scenario, network_three_way,
                             oracle_run, port_run, port_simulate)

_jstep = jax.jit(jengine.sim_step, static_argnames=("cfg",))


@pytest.mark.parametrize("name", list(NETWORK_ORACLE_SCENARIOS))
def test_network_matches_jax_and_oracle(name):
    res = network_three_way(name, oracle=True)
    if name == "star_exhaustion":
        assert res.flows_dropped > 0
    else:
        assert res.flows_dropped == 0


@pytest.mark.parametrize("name", list(NETWORK_JAX_SCENARIOS))
def test_network_matches_jax(name):
    res = network_three_way(name, oracle=False)
    assert res.flows_dropped == 0 and res.switch_energy > 0
    if name == "case_d_round_robin":
        # every chain crosses the tree: 100 MB at 1.25 GB/s at least
        assert res.latencies.min() >= 100e6 / 1.25e9


def test_one_step_from_reference_network_state():
    """Run the reference k macro-steps of the round-robin tree, carry its
    state across (flows and net included), run one sim_step in both
    engines and compare every leaf, for each k of the first 12 steps."""
    name = "case_d_round_robin"
    jcfg, arr, specs, tau, pools, jtopo = net_scenario(name, "jax")
    pcfg, *_, ttopo = net_scenario(name, "port")
    jtc = jnet.topo_consts(jtopo)
    ptc = tengine.consts(pcfg, "cpu", ttopo)
    js = jax_initial(jcfg, arr, specs, tau, pools, jtopo)
    spawned = False
    for k in range(12):
        ps = state_from_numpy(jax_tree(js), pcfg, device="cpu")
        js = _jstep(js, jcfg, jtc)
        assert_state_matches(tengine.sim_step(ps, pcfg, ptc), jax_tree(js),
                             f"{name} step {k}")
        spawned |= bool(np.asarray(js.flows.active).any())
    assert spawned


def test_events_per_step_bit_identical_on_star():
    """K in {1, 4, 16} on the round-robin star: the masked cheap passes
    retire the same events (flow completions and spawns stop them), so
    only the step count differs."""
    pcfg, arr, specs, tau, pools, topo = net_scenario("star_fluid", "port")
    outs = {k: port_run(dataclasses.replace(pcfg, events_per_step=k), arr,
                        specs, tau, pools, topo=topo) for k in (1, 4, 16)}
    ref = dict(tree_leaves(outs[1]))
    for k in (4, 16):
        for path, v in tree_leaves(outs[k]):
            if path != "steps":
                assert torch.equal(v, ref[path]), f"K={k}: {path}"
        assert int(outs[k].steps) < int(outs[1].steps)
    assert bool(outs[1].done)


def test_f64_clock_network_matches_oracle_and_f32_run():
    """The f64 clock keeps the network leaves' dtypes (rem, rate and
    switch energy f32, line-card states int32); only the clock leaves
    widen.  There is no JAX side: the reference raises on this case."""
    jcfg, arr, jspecs, tau, pools, jtopo = net_scenario("star_fluid", "jax")
    pcfg, _, specs, _, _, topo = net_scenario("star_fluid", "port")
    p64 = dataclasses.replace(pcfg, time_dtype=torch.float64)
    r32, f32 = port_simulate(pcfg, arr, specs, topo=topo)
    r64, f64 = port_simulate(p64, arr, specs, topo=topo)
    assert r64.run_info.config["time_dtype"] == "float64"
    clock = {"t", "farm.core_busy_until", "farm.srv_wake_at",
             "farm.srv_idle_since", "farm.srv_tau", "jobs.arrival",
             "jobs.task_end", "jobs.start_at", "jobs.finish",
             "jobs.job_finish", "jobs.deadline", "jobs.admit_at",
             "flows.extra", "flows.done_at", "net.port_idle_since",
             "thermal.ctrl_next",
             # the flight recorder's ring takes the clock's dtype, as in
             # the reference (its (1, 5) placeholder here)
             "trace.buf"}
    d32 = {p: v.dtype for p, v in tree_leaves(f32)}
    for path, v in tree_leaves(f64):
        want = torch.float64 if path in clock else d32[path]
        assert v.dtype == want, path
        if path in clock:
            assert d32[path] == torch.float32, path
    orc = oracle_run(jcfg, arr, jspecs, tau, pools, jtopo)
    for res in (r64, r32):
        assert res.n_finished == len(arr)
        check_oracle(res, orc, len(arr))
    np.testing.assert_array_equal(r64.wake_count, r32.wake_count)
    np.testing.assert_allclose(r64.latencies, r32.latencies, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(r64.switch_energy, r32.switch_energy,
                               rtol=1e-4)
    err64 = np.abs(np.sort(r64.latencies) - np.sort(orc.latencies())).max()
    err32 = np.abs(np.sort(r32.latencies) - np.sort(orc.latencies())).max()
    assert err64 <= err32
