"""The flight recorder through the port's farm.simulate, against the JAX
package and the heapq oracle: every traced scenario of the reference's
tests (tests/test_trace.py's oracle test at K=1 and K=8, its K=1 vs K=8
control-plane test, its trace-off identity test, its capacity-64
wrap-around test; tests/test_thermal.py::test_thermal_matches_numpy_oracle's
four cases and tests/test_network_flows.py::test_fluid_flows_match_oracle_star,
each traced), a traced mid-run state carried across with
``convert.state_from_numpy``; and the two division repairs that came with
this slice (``core_freq`` and ``log_bin``'s ``lo``).

The port's ring is held against JAX's record for record: exactly, or,
where throttling is armed, the kind, server and tid columns exactly and
the time and aux columns at rtol 1e-5 (``CLOCK_LEAVES``; XLA's exp and
log are not correctly rounded, ROADMAP Queue 3).  The decoded stream is
held against the oracle's with ``diff_traces(time_tol=5e-3)``, as the
reference's own tests hold it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import farm as jfarm
from repro.core import jobs as jjobs
from repro.core import workload
from repro.core.types import (SchedPolicy, SimConfig, SleepPolicy, SrvState,
                              ThermalConfig, TraceConfig, TraceKind)
from repro_torch.convert import state_from_numpy
from repro_torch.core import engine as tengine
from repro_torch.core import jobs as tjobs
from repro_torch.core import traceio as ttio
from repro_torch.core.types import tree_leaves

from oracle import OracleSim
from torch_port_util import (CLOCK_LEAVES, HOT, assert_ring_matches,
                             assert_state_matches,
                             assert_windows_within_clock_tol, jax_initial,
                             jax_tree, network_three_way, oracle_run,
                             port_cfg, port_initial, port_simulate,
                             thermal_scenario, thermal_three_way)

ON = TraceConfig(enabled=True)


def _rich_cfg(**kw):
    """tests/test_trace.py's rich configuration: sleep timers and thermal
    throttling, so one run records arrival, admit, start, finish,
    job_finish, wakeup, sleep and throttle_crossing."""
    tcfg = ThermalConfig(**HOT, t_throttle=50.0, t_release=45.0,
                         throttle_freq=0.5, throttle_power_scale=0.6,
                         carbon_period=600.0, price_period=600.0)
    return SimConfig(**{**dict(
        n_servers=6, n_cores=2, max_jobs=256, tasks_per_job=1,
        sched_policy=SchedPolicy.LOAD_BALANCE,
        sleep_policy=SleepPolicy.SINGLE_TIMER, sleep_state=SrvState.S3,
        max_events=60_000, thermal=tcfg, trace=ON), **kw})


def _workload(n_jobs=150):
    rng = np.random.default_rng(7)
    arr = workload.poisson_arrivals(60.0, n_jobs, seed=3)
    svc = rng.exponential(0.02, n_jobs)
    return arr, [jjobs.dag_single(s) for s in svc], \
        [tjobs.dag_single(s) for s in svc]


def _both(jcfg, arr, jspecs, tspecs, tau=None):
    """(port SimResult, port final state, reference SimResult, reference
    final state as a numpy tree) of one configuration."""
    jres = jfarm.simulate(jcfg, arr, jspecs, tau=tau)
    tres, final = port_simulate(port_cfg(jcfg), arr, tspecs, tau=tau)
    state = jax_initial(jcfg, arr, jspecs)
    if tau is not None:
        state = dataclasses.replace(state, farm=dataclasses.replace(
            state.farm, srv_tau=jnp.full((jcfg.n_servers,), tau,
                                         jcfg.time_dtype)))
    return tres, final, jres, jax_tree(jengine.run(state, jcfg, None))


def _check_clock_tol_state(final, tree, ctx):
    """Every leaf against JAX's under the throttling rule."""
    assert_state_matches(final, tree, ctx, skip=("telem.win",),
                         tol=CLOCK_LEAVES)
    assert_windows_within_clock_tol(final.telem.win.numpy(),
                                    tree["telem.win"], float(final.t), ctx)


@pytest.mark.parametrize("k", [1, 8])
def test_trace_matches_jax_and_oracle(k):
    """tests/test_trace.py's oracle test: the port's ring against JAX's
    (throttling armed), its decoded stream against the oracle's event for
    event, every kind of the configuration present."""
    jcfg = _rich_cfg(events_per_step=k)
    arr, jspecs, tspecs = _workload()
    tres, final, jres, tree = _both(jcfg, arr, jspecs, tspecs, tau=0.05)
    orc = OracleSim(jcfg, arr, jspecs, tau=0.05).run()
    assert tres.n_finished == len(arr)
    assert tres.trace_dropped == jres.trace_dropped == 0
    assert len(tres.trace_events) == len(jres.trace_events) == len(orc.trace)
    _check_clock_tol_state(final, tree, f"K={k}")
    msg = ttio.diff_traces(tres.trace_events, ttio.as_events(orc.trace),
                           time_tol=5e-3)
    assert msg is None, msg
    assert ttio.diff_traces(tres.trace_events, jres.trace_events,
                            time_tol=1e-5, check_aux=True,
                            names=("port", "jax")) is None
    kinds = set(tres.trace_events["kind"].tolist())
    for needed in (TraceKind.ARRIVAL, TraceKind.ADMIT, TraceKind.START,
                   TraceKind.FINISH, TraceKind.JOB_FINISH,
                   TraceKind.WAKEUP, TraceKind.SLEEP,
                   TraceKind.THROTTLE_CROSSING):
        assert needed in kinds, TraceKind.NAMES[needed]


def test_trace_k_sweep_leaf_exact_with_control_plane():
    """The port's ring is macro-step invariant under the full control
    plane (setpoints, controller, ambient, CARBON_AWARE deferral,
    throttling): K=1 and K=8 give leaf-exact states, ring included; K=8
    holds against JAX's under the throttling rule."""
    outs = {}
    for k in (1, 8):
        pcfg, arr, specs, tau, _ = thermal_scenario(
            "k_sweep", "port", trace=ON, events_per_step=k)
        state, tc = port_initial(pcfg, arr, specs, tau)
        outs[k] = tengine.run(state, pcfg, tc)
    leaves = {k: dict(tree_leaves(v)) for k, v in outs.items()}
    for path, a in leaves[1].items():
        if path != "steps":
            assert torch.equal(a, leaves[8][path]), f"K=8 vs K=1: {path}"
    ev, n_drop = ttio.decode(outs[1].trace, pcfg)
    kinds = set(ev["kind"].tolist())
    assert TraceKind.RELEASE in kinds and TraceKind.CTRL_TICK in kinds
    assert TraceKind.THROTTLE_CROSSING in kinds and n_drop == 0
    assert int(outs[1].thermal.defer_count) > 0
    jcfg, arr, jspecs, tau, _ = thermal_scenario("k_sweep", "jax", trace=ON)
    state = jax_initial(jcfg, arr, jspecs)
    state = dataclasses.replace(state, farm=dataclasses.replace(
        state.farm, srv_tau=jnp.full((jcfg.n_servers,), tau,
                                     jcfg.time_dtype)))
    _check_clock_tol_state(outs[8], jax_tree(jengine.run(state, jcfg)),
                           "k_sweep")


def test_trace_off_bit_identical_and_statically_absent():
    """Trace off leaves every other leaf bit-identical to the traced run,
    with a (1, 5) placeholder ring that never advances."""
    jcfg = _rich_cfg()
    arr, _, tspecs = _workload(n_jobs=100)
    finals = {}
    for on in (True, False):
        pcfg = port_cfg(jcfg, trace=TraceConfig(enabled=on))
        state, tc = port_initial(pcfg, arr, tspecs, tau=0.05)
        finals[on] = dict(tree_leaves(tengine.run(state, pcfg, tc)))
    for path, a in finals[True].items():
        if not path.startswith("trace."):
            assert torch.equal(a, finals[False][path]), f"on vs off: {path}"
    off = finals[False]
    assert off["trace.buf"].shape == (1, 5)
    assert (off["trace.buf"] == -1).all()
    assert int(off["trace.ptr"]) == 0 and int(off["trace.dropped"]) == 0
    assert int(finals[True]["trace.ptr"]) > 0


def test_trace_ring_wraparound_counts_drops_exactly():
    """A 64-slot ring keeps the most recent 64 records and counts every
    eviction: ring, pointer and drop count as JAX's, and dropped ==
    the oracle's total - 64."""
    cap = 64
    jcfg = dataclasses.replace(_rich_cfg(),
                               trace=TraceConfig(enabled=True, capacity=cap))
    arr, jspecs, tspecs = _workload()
    tres, final, jres, tree = _both(jcfg, arr, jspecs, tspecs, tau=0.05)
    orc = OracleSim(jcfg, arr, jspecs, tau=0.05).run()
    total = len(orc.trace)
    assert total > cap
    assert tres.trace_dropped == jres.trace_dropped == total - cap
    assert int(final.trace.ptr) == int(tree["trace.ptr"]) == total
    assert len(tres.trace_events) == cap
    assert_ring_matches(final.trace.buf.numpy(), tree["trace.buf"],
                        "capacity 64", clock_tol=True)
    t_floor = float(orc.trace[total - cap][0])
    assert (tres.trace_events["time"] >= t_floor - 5e-3).all()


@pytest.mark.parametrize("name", ["oracle_always_on", "oracle_timer",
                                  "oracle_always_on_throttle",
                                  "oracle_timer_throttle"])
def test_thermal_oracle_cases_traced(name):
    """tests/test_thermal.py::test_thermal_matches_numpy_oracle's four
    cases with the recorder on, as they run there: every leaf (ring
    included) against JAX's, the decoded stream against the oracle's."""
    tres, jres = thermal_three_way(name, trace=ON)
    jcfg, arr, jspecs, tau, _ = thermal_scenario(name, "jax", trace=ON)
    orc = OracleSim(jcfg, arr, jspecs, tau=tau).run()
    assert tres.trace_dropped == 0
    msg = ttio.diff_traces(tres.trace_events, ttio.as_events(orc.trace),
                           time_tol=5e-3)
    assert msg is None, msg
    if jcfg.thermal.throttling:
        assert TraceKind.THROTTLE_CROSSING in \
            set(tres.trace_events["kind"].tolist())
    else:
        np.testing.assert_array_equal(tres.trace_events, jres.trace_events)


def test_star_flows_traced():
    """tests/test_network_flows.py::test_fluid_flows_match_oracle_star with
    the recorder on: FLOW_SPAWN and FLOW_FINISH records in the ring,
    every leaf against JAX's, the stream against the oracle's."""
    tres = network_three_way("star_fluid", True, trace=ON)
    from torch_port_util import net_scenario
    jcfg, arr, jspecs, tau, _, jtopo = net_scenario("star_fluid", "jax",
                                                    trace=ON)
    orc = oracle_run(jcfg, arr, jspecs, tau, None, jtopo)
    msg = ttio.diff_traces(tres.trace_events, ttio.as_events(orc.trace),
                           time_tol=1e-3)
    assert msg is None, msg
    kinds = set(tres.trace_events["kind"].tolist())
    assert TraceKind.FLOW_SPAWN in kinds and TraceKind.FLOW_FINISH in kinds


def test_traced_mid_run_state_steps_in_both():
    """A traced reference state cut mid-run by max_events, carried across
    with convert.state_from_numpy (ring, pointer and drop count
    included), runs to the end in both engines with the same ring."""
    jcfg = _rich_cfg(max_events=300)
    arr, jspecs, _ = _workload()
    state = jax_initial(jcfg, arr, jspecs)
    state = dataclasses.replace(state, farm=dataclasses.replace(
        state.farm, srv_tau=jnp.full((6,), 0.05, jnp.float32)))
    mid = jengine.run(state, jcfg)
    assert int(mid.trace.ptr) > 0 and not bool(mid.done)
    full = dataclasses.replace(jcfg, max_events=60_000)
    tree = jax_tree(jengine.run(mid, full))
    pcfg = port_cfg(full)
    pmid = state_from_numpy(jax_tree(mid), pcfg, device="cpu")
    final = tengine.run(pmid, pcfg)
    assert bool(final.done)
    _check_clock_tol_state(final, tree, "mid-run")


# --------------------------------------------------------------------------
# the repairs of this slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["always_on", "dag_chain"])
def test_core_freq_division_matches_jax(name):
    """core_freq=1.7: the reference's compiled step divides the service
    time by the constant as a multiplication by its float32 reciprocal
    and fuses it with the start time into one FMA; the port's task_end,
    finish and job_finish equal JAX's exactly (and every other leaf)."""
    from torch_port_util import jax_run, port_run, scenario
    jcfg, arr, jspecs, tau, pools = scenario(name, jjobs, core_freq=1.7)
    tspecs = scenario(name, tjobs)[2]
    tree = jax_tree(jax_run(jcfg, arr, jspecs, tau, pools))
    final = port_run(port_cfg(jcfg), arr, tspecs, tau, pools)
    for leaf in ("task_end", "finish", "job_finish"):
        np.testing.assert_array_equal(getattr(final.jobs, leaf).numpy(),
                                      tree[f"jobs.{leaf}"], err_msg=leaf)
    assert_state_matches(final, tree, f"{name} core_freq=1.7")


def test_log_bin_near_edges_against_jitted_reference():
    """log_bin against the reference's jitted log_bin on 1.26 M values
    within +-3e-7 relative of the 63 inner bin edges: with the division by
    lo taken as a multiplication by fl(1/lo), as XLA compiles it, the bins
    that still differ come from XLA's log alone (ROADMAP Queue 3) --
    4,309 with this seed, against 18,502 with a true division; none on
    2 M log-uniform values."""
    import math
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    lo, hi, B = 1e-5, 1e3, 64
    rng = np.random.default_rng(0)
    edges = lo * (hi / lo) ** (np.arange(1, B) / B)
    rel = rng.uniform(-3e-7, 3e-7, (B - 1, 20_000))
    v = (edges[:, None] * (1 + rel)).astype(np.float32).ravel()
    jit = jax.jit(jref.log_bin, static_argnums=(1, 2, 3))
    exp = np.asarray(jit(jnp.asarray(v), lo, hi, B))
    got = ref.log_bin(torch.from_numpy(v), lo, hi, B).numpy()
    vt = torch.from_numpy(v)
    lo_t = torch.tensor(lo, dtype=torch.float32)
    divided = (torch.log(torch.maximum(vt, lo_t) / lo_t)
               * torch.tensor(B / math.log(hi / lo), dtype=torch.float32)
               ).clamp(0, B - 1).long().numpy()
    n_got, n_div = int((got != exp).sum()), int((divided != exp).sum())
    assert np.abs(got - exp).max() <= 1
    assert n_got <= 4_309 and n_got * 4 < n_div, (n_got, n_div)
    lu = np.exp(rng.uniform(np.log(lo), np.log(hi), 2_000_000)
                ).astype(np.float32)
    np.testing.assert_array_equal(
        ref.log_bin(torch.from_numpy(lu), lo, hi, B).numpy(),
        np.asarray(jit(jnp.asarray(lu), lo, hi, B)))
