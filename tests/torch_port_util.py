"""Helpers shared by the PyTorch port's tests (tests/test_torch_*.py): carry
scenarios and states between the JAX reference and the port, build random
mid-run states for both, and compare states leaf by leaf.

Inputs are made with numpy from seeds and handed to both packages as
numpy arrays."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import engine as jengine
from repro.core import farm as jfarm
from repro.core import jobs as jjobs
from repro.core import network as jnet
from repro.core import workload
from repro.core.types import (INF, SchedPolicy, SimConfig, SleepPolicy,
                              SrvState, TaskStatus, TelemetryConfig,
                              ThermalConfig)
from repro_torch.convert import config_from_dict, state_from_numpy
from repro_torch.core.types import tree_leaves

from torch_kernel_inputs import case_d_scenario, star_scenario

# The tests' tensors are tiny: PyTorch's intra-op threads would only spin
# beside the other test workers.
torch.set_num_threads(1)


# leaves whose values come from float reductions or products that XLA may
# fuse or reorder (window power sums, FMA-contracted accruals): rtol 1e-5.
# Every other leaf -- discrete state, clocks, histograms of integer
# counts -- must match exactly.
TOL_LEAVES = {"farm.energy", "farm.residency", "farm.busy_core_seconds",
              "telem.win", "telem.win_overflow", "net.sw_energy",
              "net.port_residency",
              # thermal floats: exp, log, sin and cos round differently in
              # XLA:CPU and in the port (an ulp), and the accruals sum in
              # another order
              "thermal.t_srv", "thermal.t_peak", "thermal.throttle_seconds",
              "thermal.cool_energy", "thermal.carbon_g", "thermal.cost",
              "thermal.defer_seconds", "thermal.grams_avoided"}
# the clock's leaves.  With throttling armed, the crossing times are solved
# from those temperatures, so these too may sit an ulp or a few apart (the
# discrete state stays equal): thermal tests with throttling hold them at
# rtol 1e-5, every other test exactly
CLOCK_LEAVES = {"t", "farm.core_busy_until", "farm.srv_wake_at",
                "farm.srv_idle_since", "jobs.task_end", "jobs.start_at",
                "jobs.finish", "jobs.job_finish", "jobs.admit_at",
                "flows.extra", "flows.done_at", "net.port_idle_since",
                "thermal.ctrl_next",
                # the flight recorder's time and aux columns (its kind,
                # server and tid columns are compared exactly regardless)
                "trace.buf"}


def port_cfg(jcfg, **kw):
    """The port's SimConfig for a reference SimConfig (via its dump), with
    ``kw`` overriding fields: a torch dtype after the conversion, any
    other value (the reference's nested configs) before it."""
    late = {k: v for k, v in kw.items() if isinstance(v, torch.dtype)}
    early = {k: v for k, v in kw.items() if k not in late}
    if early:
        jcfg = dataclasses.replace(jcfg, **early)
    cfg = config_from_dict(jfarm._config_dict(jcfg))
    return dataclasses.replace(cfg, **late) if late else cfg


def jax_tree(state) -> dict:
    """{dotted field path: numpy array} of a reference state."""
    return {jax.tree_util.keystr(kp).lstrip("."): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(state)}


def jax_state_from_tree(template, tree: dict):
    """The reference state ``template`` with every leaf named in ``tree``
    replaced (dtypes kept)."""
    def pick(kp, v):
        key = jax.tree_util.keystr(kp).lstrip(".")
        return jnp.asarray(tree[key], v.dtype) if key in tree else v
    return jax.tree_util.tree_map_with_path(pick, template)


def assert_state_matches(port_state, ref_tree: dict, context: str,
                         skip=(), tol=()) -> None:
    """Every leaf of a port state against the reference's numpy tree:
    TOL_LEAVES and the leaves in ``tol`` at rtol 1e-5, the rest exactly.
    The reference's (R, N) rack matrix is compared as the port's member
    table (``convert``); the flight recorder's ring with
    ``assert_ring_matches``."""
    from repro_torch.convert import _rack_marker
    for path, v in tree_leaves(port_state):
        if path in skip:
            continue
        got = v.detach().cpu().numpy()
        exp = ref_tree[path]
        if path == "thermal.rack_onehot":
            exp = _rack_marker(exp, "cpu").numpy()
        assert got.shape == exp.shape, f"{context}: {path} shape"
        if path == "trace.buf":
            assert_ring_matches(got, exp, context, clock_tol=path in tol)
            continue
        if path in TOL_LEAVES or path in tol:
            np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{context}: {path}")
        else:
            np.testing.assert_array_equal(got, exp,
                                          err_msg=f"{context}: {path}")


def assert_ring_matches(got, exp, context: str,
                        clock_tol: bool = False) -> None:
    """Two flight-recorder rings (cap, 5), or two batches of them (R, cap,
    5), record for record: the kind, server and tid columns exactly; the
    time and aux columns exactly, or (``clock_tol``, throttling armed) at
    rtol 1e-5, since the clock and the temperatures may then sit an ulp or
    a few from the reference's."""
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape and got.dtype == exp.dtype, \
        f"{context}: ring {got.shape} {got.dtype} vs {exp.shape} {exp.dtype}"
    np.testing.assert_array_equal(got[..., [0, 2, 3]], exp[..., [0, 2, 3]],
                                  err_msg=f"{context}: ring kind/server/tid")
    if clock_tol:
        np.testing.assert_allclose(got[..., [1, 4]], exp[..., [1, 4]],
                                   rtol=RTOL, atol=1e-6,
                                   err_msg=f"{context}: ring time/aux")
    else:
        np.testing.assert_array_equal(got[..., [1, 4]], exp[..., [1, 4]],
                                      err_msg=f"{context}: ring time/aux")


def random_twin_states(jcfg, seed: int, n_jobs: int = 40, t: float = 1.0):
    """A random mid-run state, as (reference SimState, port SimState, numpy
    tree): jobs in every status, servers in every power state, queued tasks
    with unique FIFO stamps, running tasks whose cores are busy."""
    rng = np.random.default_rng(seed)
    N, C, T = jcfg.n_servers, jcfg.n_cores, jcfg.tasks_per_job
    arr = np.sort(rng.uniform(0.0, 2 * t, n_jobs))
    specs = [jjobs.dag_chain(rng.exponential(0.05, size=T)) if T > 1
             else jjobs.dag_single(rng.exponential(0.05),
                                   sla=float(rng.uniform(0.01, 0.2)))
             for _ in range(n_jobs)]
    jt = jjobs.build_jobs(jcfg, arr, specs)
    st0, _ = jengine.init_state(jcfg, jt)
    tree = jax_tree(st0)
    f32 = np.float32
    tree["t"] = np.asarray(t, f32)

    # farm
    state = rng.integers(0, 6, N).astype(np.int32)
    busy = np.where(rng.random((N, C)) < 0.4,
                    rng.uniform(t, t + 1, (N, C)), INF).astype(f32)
    busy[(state != 0)] = INF
    tree["farm.core_busy_until"] = busy
    tree["farm.srv_state"] = state
    tree["farm.srv_wake_at"] = np.where(state == 5, rng.uniform(t, t + 1, N),
                                        INF).astype(f32)
    tree["farm.srv_idle_since"] = rng.uniform(0, t, N).astype(f32)
    tree["farm.srv_tau"] = np.where(rng.random(N) < 0.7,
                                    rng.uniform(0.01, 1.5, N), INF
                                    ).astype(f32)
    tree["farm.srv_pool"] = (rng.random(N) < 0.5).astype(np.int32)
    tree["farm.srv_enabled"] = rng.random(N) < 0.8
    tree["farm.energy"] = rng.uniform(0, 50, N).astype(f32)
    tree["farm.residency"] = rng.uniform(0, 1, (N, 6)).astype(f32)
    tree["farm.busy_core_seconds"] = rng.uniform(0, 2, N).astype(f32)
    tree["farm.wake_count"] = rng.integers(0, 3, N).astype(np.int32)
    tree["farm.dropped"] = np.asarray(rng.integers(0, 3), np.int32)

    # jobs: arrived prefix with random statuses
    JT = jcfg.n_tasks
    n_arr = int(rng.integers(n_jobs // 2, n_jobs))
    valid = tree["jobs.valid"]
    arrived = (np.arange(JT) // T) < n_arr
    status = np.where(valid, TaskStatus.BLOCKED, TaskStatus.INVALID)
    pick = rng.choice([TaskStatus.READY, TaskStatus.QUEUED,
                       TaskStatus.RUNNING, TaskStatus.DONE,
                       TaskStatus.BLOCKED], JT)
    status = np.where(valid & arrived, pick, status).astype(np.int32)
    server = np.where(arrived & valid, rng.integers(0, N, JT), -1)
    # running tasks sit on busy cores of ACTIVE servers
    running = status == TaskStatus.RUNNING
    task_end = np.full(JT, INF, f32)
    task_end[running] = rng.uniform(t, t + 1, running.sum())
    queued = np.flatnonzero(status == TaskStatus.QUEUED)
    q_seq = 500
    seq = np.zeros(JT, np.int32)
    seq[queued] = q_seq - 1 - rng.permutation(len(queued))
    q_len = np.bincount(server[queued], minlength=N).astype(np.int32)
    finish = np.where(status == TaskStatus.DONE,
                      rng.uniform(0, t, JT), INF).astype(f32)
    jf = np.full(tree["jobs.job_finish"].shape, INF, f32)
    done_jobs = (status.reshape(-1, T) == TaskStatus.DONE).all(axis=1)
    jf[done_jobs] = rng.uniform(0, t, done_jobs.sum())
    tree["jobs.arr_ptr"] = np.asarray(n_arr, np.int32)
    tree["jobs.status"] = status
    tree["jobs.server"] = server.astype(np.int32)
    tree["jobs.task_end"] = task_end
    tree["jobs.start_at"] = np.where(running, t - 0.01, INF).astype(f32)
    tree["jobs.enqueue_seq"] = seq
    tree["jobs.finish"] = finish
    tree["jobs.job_finish"] = jf
    tree["farm.q_len"] = q_len
    tree["farm.q_seq"] = np.asarray(q_seq, np.int32)
    tree["sched.rr_ptr"] = np.asarray(rng.integers(0, N), np.int32)
    tree["sched.n_enabled"] = np.asarray(rng.integers(1, N + 1), np.int32)

    jstate = jax_state_from_tree(st0, tree)
    tree = jax_tree(jstate)
    pstate = state_from_numpy(tree, port_cfg(jcfg), device="cpu")
    return jstate, pstate, tree


# --------------------------------------------------------------------------
# scenarios: tests/test_engine_oracle.py's, plus the in-scope policies the
# heapq oracle does not model.  Each function takes a jobs module (the
# reference's or the port's) and returns (SimConfig kwargs, arrivals, specs,
# tau, pools).
# --------------------------------------------------------------------------

def _single(mod, n_jobs, lam, arr_seed, svc_seed, mean):
    arr = workload.poisson_arrivals(lam, n_jobs, seed=arr_seed)
    rng = np.random.default_rng(svc_seed)
    return arr, [mod.dag_single(rng.exponential(mean))
                 for _ in range(n_jobs)]


def _oracle_single(policy, tau, sleep_state):
    def make(mod):
        arr, specs = _single(mod, 200, 120.0, 3, 7, 0.02)
        kw = dict(n_servers=6, n_cores=2, max_jobs=256, tasks_per_job=1,
                  sched_policy=SchedPolicy.LOAD_BALANCE, sleep_policy=policy,
                  sleep_state=sleep_state, max_events=50_000)
        return kw, arr, specs, tau, None
    return make


def _round_robin(mod):
    arr, specs = _single(mod, 150, 60.0, 5, 11, 0.03)
    kw = dict(n_servers=5, n_cores=1, max_jobs=256, tasks_per_job=1,
              sched_policy=SchedPolicy.ROUND_ROBIN,
              sleep_policy=SleepPolicy.ALWAYS_ON, max_events=50_000)
    return kw, arr, specs, None, None


def _dag_chain(mod):
    rng = np.random.default_rng(13)
    arr = workload.poisson_arrivals(40.0, 80, seed=6)
    specs = [mod.dag_chain(rng.exponential(0.01, size=3)) for _ in range(80)]
    kw = dict(n_servers=4, n_cores=2, max_jobs=128, tasks_per_job=3,
              sched_policy=SchedPolicy.LOAD_BALANCE,
              sleep_policy=SleepPolicy.ALWAYS_ON, max_events=50_000)
    return kw, arr, specs, None, None


def _dag_fanout(mod):
    rng = np.random.default_rng(17)
    arr = workload.poisson_arrivals(30.0, 60, seed=8)
    specs = [mod.dag_fanout(rng.exponential(0.005),
                            rng.exponential(0.01, size=2),
                            rng.exponential(0.005)) for _ in range(60)]
    kw = dict(n_servers=4, n_cores=2, max_jobs=64, tasks_per_job=4,
              sched_policy=SchedPolicy.LOAD_BALANCE,
              sleep_policy=SleepPolicy.ALWAYS_ON, max_events=50_000)
    return kw, arr, specs, None, None


def _dual_timer(mod):
    N = 6
    arr, specs = _single(mod, 150, 80.0, 9, 23, 0.02)
    kw = dict(n_servers=N, n_cores=2, max_jobs=256, tasks_per_job=1,
              sched_policy=SchedPolicy.LOAD_BALANCE,
              sleep_policy=SleepPolicy.DUAL_TIMER, sleep_state=SrvState.S3,
              max_events=50_000)
    tau = np.where(np.arange(N) < N // 2, 1.0, 0.01)   # high-tau pool first
    pools = (np.arange(N) >= N // 2).astype(np.int32)
    return kw, arr, specs, tau, pools


def _provisioned(mod):
    arr, specs = _single(mod, 150, 150.0, 12, 31, 0.02)
    kw = dict(n_servers=8, n_cores=2, max_jobs=160, tasks_per_job=1,
              sched_policy=SchedPolicy.PROVISIONED,
              sleep_policy=SleepPolicy.SINGLE_TIMER,
              sleep_state=SrvState.PKG_C6, prov_lo=0.3, prov_hi=0.7,
              max_events=50_000)
    return kw, arr, specs, 0.02, None


def _wasp(mod):
    N = 6
    arr, specs = _single(mod, 150, 100.0, 14, 37, 0.02)
    kw = dict(n_servers=N, n_cores=2, max_jobs=160, tasks_per_job=1,
              sched_policy=SchedPolicy.WASP_POOLS,
              sleep_policy=SleepPolicy.WASP, wasp_t_wakeup=1.0,
              wasp_t_sleep=0.3, max_events=50_000)
    pools = (np.arange(N) >= 2).astype(np.int32)
    return kw, arr, specs, 0.05, pools


def _overflow_dag(mod):
    """Queue-full drops of DAG tasks (drop resolution frees the children)
    under delay timers."""
    rng = np.random.default_rng(3)
    arr = np.sort(rng.uniform(0, 0.2, 25))
    specs = [mod.dag_chain(rng.uniform(0.2, 0.6, size=3)) for _ in range(25)]
    kw = dict(n_servers=2, n_cores=1, local_q=2, max_jobs=32,
              tasks_per_job=3, sched_policy=SchedPolicy.LOAD_BALANCE,
              sleep_policy=SleepPolicy.SINGLE_TIMER, sleep_state=SrvState.S3,
              max_events=50_000)
    return kw, arr, specs, 0.05, None


def _rr_overflow(mod):
    """ROUND_ROBIN with one-slot queues: drops and the least-loaded
    fallback when every enabled queue is full."""
    rng = np.random.default_rng(5)
    arr = np.sort(rng.uniform(0, 0.5, 40))
    specs = [mod.dag_single(rng.uniform(0.3, 0.8)) for _ in range(40)]
    kw = dict(n_servers=3, n_cores=1, local_q=1, max_jobs=64,
              tasks_per_job=1, sched_policy=SchedPolicy.ROUND_ROBIN,
              sleep_policy=SleepPolicy.ALWAYS_ON, max_events=50_000)
    return kw, arr, specs, None, None


ORACLE_SCENARIOS = {
    "always_on": _oracle_single(SleepPolicy.ALWAYS_ON, None, SrvState.S3),
    "single_timer_s3": _oracle_single(SleepPolicy.SINGLE_TIMER, 0.05,
                                      SrvState.S3),
    "single_timer_c6": _oracle_single(SleepPolicy.SINGLE_TIMER, 0.02,
                                      SrvState.PKG_C6),
    "round_robin": _round_robin,
    "dag_chain": _dag_chain,
    "dag_fanout": _dag_fanout,
    "dual_timer_pools": _dual_timer,
}
JAX_ONLY_SCENARIOS = {"provisioned": _provisioned, "wasp_pools": _wasp,
                      "overflow_dag": _overflow_dag,
                      "rr_overflow": _rr_overflow}


def scenario(name, mod, **cfg_kw):
    """(reference SimConfig, arrivals, specs built with ``mod``, tau,
    pools) of a named scenario, with ``cfg_kw`` overriding its config."""
    make = {**ORACLE_SCENARIOS, **JAX_ONLY_SCENARIOS}[name]
    kw, arr, specs, tau, pools = make(mod)
    kw.update(cfg_kw)
    return SimConfig(**kw), arr, specs, tau, pools


def jax_initial(jcfg, arr, specs, tau=None, pools=None, topo=None):
    """The reference's initial state as farm.simulate builds it."""
    jt = jjobs.build_jobs(jcfg, np.asarray(arr), specs)
    state, _ = jengine.init_state(jcfg, jt, topo)
    farm = state.farm
    if tau is not None:
        farm = dataclasses.replace(farm, srv_tau=jnp.broadcast_to(
            jnp.asarray(tau, jcfg.time_dtype), (jcfg.n_servers,)))
    if pools is not None:
        farm = dataclasses.replace(farm,
                                   srv_pool=jnp.asarray(pools, jnp.int32))
    return dataclasses.replace(state, farm=farm)


def jax_run(jcfg, arr, specs, tau=None, pools=None, topo=None):
    tc = jnet.topo_consts(topo) if topo is not None else None
    return jengine.run(jax_initial(jcfg, arr, specs, tau, pools, topo), jcfg,
                       tc)


def port_initial(pcfg, arr, specs, tau=None, pools=None, device="cpu",
                 topo=None):
    """The port's initial state as its farm.simulate builds it, and the
    run's constants."""
    from repro_torch.core import engine as tengine
    from repro_torch.core import jobs as tjobs
    jt = tjobs.build_jobs(pcfg, np.asarray(arr), specs, device=device)
    state, tc = tengine.init_state(pcfg, jt, topo)
    farm = state.farm
    if tau is not None:
        farm = dataclasses.replace(farm, srv_tau=torch.as_tensor(
            np.broadcast_to(np.asarray(tau, np.float64),
                            (pcfg.n_servers,)).copy()).to(
            device=device, dtype=pcfg.time_dtype))
    if pools is not None:
        farm = dataclasses.replace(farm, srv_pool=torch.as_tensor(
            np.asarray(pools)).to(device=device, dtype=torch.int32))
    return dataclasses.replace(state, farm=farm), tc


def port_run(pcfg, arr, specs, tau=None, pools=None, device="cpu",
             topo=None):
    from repro_torch.core import engine as tengine
    state, tc = port_initial(pcfg, arr, specs, tau, pools, device, topo)
    return tengine.run(state, pcfg, tc)


def port_simulate(pcfg, arr, specs, **kw):
    """The port's farm.simulate on the CPU, and the final engine state it
    summarized (caught on its way out of ``engine.run``)."""
    from repro_torch.core import engine as tengine
    from repro_torch.core import farm as tfarm
    caught = []
    run = tengine.run

    def spy(*a, **k):
        caught.append(run(*a, **k))
        return caught[-1]

    tengine.run = spy
    try:
        res = tfarm.simulate(pcfg, arr, specs, device="cpu", **kw)
    finally:
        tengine.run = run
    return res, caught[0]


def oracle_run(jcfg, arr, specs, tau=None, pools=None, topo=None):
    from oracle import OracleSim
    orc = OracleSim(jcfg, arr, specs, tau=tau, topo=topo)
    if pools is not None:
        for s, p in zip(orc.servers, pools):
            s.pool = int(p)
    return orc.run()


RTOL = 1e-5


def compare_results(tres, jres, windows: bool = True) -> None:
    """The port's SimResult against the reference's: counts, wake counts,
    the digest and the histogram percentiles exact; floats rtol 1e-5
    (the window series only with ``windows``)."""
    assert tres.run_info.config_digest == jres.run_info.config_digest
    for f in ("events", "n_jobs", "n_finished", "dropped"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.run_info.steps == jres.run_info.steps
    np.testing.assert_array_equal(tres.wake_count, jres.wake_count)
    for f in ("latencies", "energy_per_server", "residency"):
        np.testing.assert_allclose(getattr(tres, f), getattr(jres, f),
                                   rtol=RTOL, atol=0, err_msg=f)
    for f in ("sim_time", "server_energy", "busy_core_seconds",
              "mean_latency", "p99_latency"):
        np.testing.assert_allclose(getattr(tres, f), getattr(jres, f),
                                   rtol=RTOL, err_msg=f)
    ts, js = tres.telemetry, jres.telemetry
    for f in ("job_p50", "job_p95", "job_p99", "task_p50", "task_p99",
              "jobs_binned", "tasks_binned", "sla_miss", "sla_total",
              "tail_violations", "n_windows_used"):
        assert getattr(ts, f) == getattr(js, f), f
    if not windows:
        return
    for f in ("occupancy", "active_jobs", "awake_servers", "queue_depth",
              "server_power", "state_residency"):
        np.testing.assert_allclose(getattr(ts, f), getattr(js, f),
                                   rtol=RTOL, atol=1e-6, err_msg=f)


def assert_bitwise(got, exp, context):
    """Two port states (or replica batches) leaf for leaf, bit for
    bit."""
    lg, le = tree_leaves(got), tree_leaves(exp)
    assert [p for p, _ in lg] == [p for p, _ in le], context
    bad = [p for (p, a), (_, b) in zip(lg, le)
           if a.dtype != b.dtype or not torch.equal(a, b)]
    assert not bad, f"{context}: leaves differ: {bad}"


def assert_results_equal(got, exp, context):
    """Two SimResults of the port field for field, exactly (of run
    provenance, the events, steps and digest)."""
    for f in dataclasses.fields(exp):
        if f.name == "run_info":
            continue
        a, b = getattr(got, f.name), getattr(exp, f.name)
        if dataclasses.is_dataclass(b):
            assert_results_equal(a, b, f"{context}: {f.name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{context}: "
                                                        f"{f.name}")
    ga, gb = getattr(got, "run_info", None), getattr(exp, "run_info", None)
    if gb is not None:
        assert (ga.events, ga.steps, ga.config_digest) == \
            (gb.events, gb.steps, gb.config_digest), context


def three_way(name: str, oracle: bool) -> None:
    """A named scenario through the reference's farm.simulate, the port's
    on the CPU and (``oracle``) the heapq oracle; then every leaf of both
    engines' final states."""
    from repro_torch.core import jobs as tjobs
    jcfg, arr, jspecs, tau, pools = scenario(name, jjobs)
    tspecs = scenario(name, tjobs)[2]
    pcfg = port_cfg(jcfg)
    jres = jfarm.simulate(jcfg, arr, jspecs, tau=tau, pools=pools)
    tres, final = port_simulate(pcfg, arr, tspecs, tau=tau, pools=pools)
    assert tres.run_info.backend == "cpu"
    assert tres.n_finished == len(arr)
    compare_results(tres, jres)
    # the reference's engine.run with the same config and shapes is a
    # compile-cache hit
    assert_state_matches(final, jax_tree(jax_run(jcfg, arr, jspecs, tau,
                                                 pools)), name)
    if oracle:
        orc = oracle_run(jcfg, arr, jspecs, tau, pools)
        lat_o = orc.latencies()
        assert len(lat_o) == len(arr)
        np.testing.assert_allclose(np.sort(tres.latencies), np.sort(lat_o),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tres.server_energy, orc.total_energy(),
                                   rtol=2e-3)
        if jcfg.tasks_per_job == 1:
            np.testing.assert_array_equal(
                tres.wake_count, [s.wake_count for s in orc.servers])


# --------------------------------------------------------------------------
# network scenarios (tests/torch_kernel_inputs.py builds them).  Each maker
# takes a jobs module and a topology module (the reference's or the
# port's) and returns (SimConfig kwargs, arrivals, specs, tau, topology).
# --------------------------------------------------------------------------

def _star(max_flows, comm_model=0):
    def make(mod, topo_mod):
        return star_scenario(mod, topo_mod, max_flows, comm_model)
    return make


def _case_d(policy, n_jobs=48):
    """Case study D on a k=4 fat-tree, cut to ``n_jobs`` jobs."""
    def make(mod, topo_mod):
        return case_d_scenario(mod, topo_mod, policy, n_jobs=n_jobs,
                               max_jobs=64)
    return make


NETWORK_ORACLE_SCENARIOS = {"star_fluid": _star(64),
                            "star_exhaustion": _star(2)}
NETWORK_JAX_SCENARIOS = {
    "case_d_load_balance": _case_d(SchedPolicy.LOAD_BALANCE),
    "case_d_network_aware": _case_d(SchedPolicy.NETWORK_AWARE),
    "case_d_round_robin": _case_d(SchedPolicy.ROUND_ROBIN),
    "star_packet": _star(64, comm_model=1),
}


def net_scenario(name, side: str, **cfg_kw):
    """(SimConfig, arrivals, specs, tau, pools, topology) of a named network
    scenario for ``side`` "jax" (the reference's SimConfig, jobs and
    topology) or "port" (the port's)."""
    make = {**NETWORK_ORACLE_SCENARIOS, **NETWORK_JAX_SCENARIOS}[name]
    if side == "jax":
        from repro.core import topology as topo_mod
        kw, arr, specs, tau, topo = make(jjobs, topo_mod)
        kw.update(cfg_kw)
        return SimConfig(**kw), arr, specs, tau, None, topo
    from repro_torch.core import jobs as tjobs
    from repro_torch.core import topology as topo_mod
    kw, arr, specs, tau, topo = make(tjobs, topo_mod)
    kw.update(cfg_kw)
    return port_cfg(SimConfig(**kw)), arr, specs, tau, None, topo


def compare_network_results(tres, jres) -> None:
    """compare_results, plus the network's outcome: flows dropped exact,
    switch energy and the switch-power windows rtol 1e-5."""
    compare_results(tres, jres)
    assert tres.flows_dropped == jres.flows_dropped
    np.testing.assert_allclose(tres.switch_energy, jres.switch_energy,
                               rtol=RTOL)
    np.testing.assert_allclose(tres.telemetry.switch_power,
                               jres.telemetry.switch_power, rtol=RTOL,
                               atol=1e-6)


def network_three_way(name: str, oracle: bool, **cfg_kw):
    """A named network scenario through the reference's farm.simulate, the
    port's on the CPU and (``oracle``) the heapq oracle; then every leaf of
    both engines' final states.  Returns the port's SimResult."""
    jcfg, arr, jspecs, tau, pools, jtopo = net_scenario(name, "jax",
                                                        **cfg_kw)
    pcfg, _, tspecs, _, _, ttopo = net_scenario(name, "port", **cfg_kw)
    jres = jfarm.simulate(jcfg, arr, jspecs, topo=jtopo, tau=tau,
                          pools=pools)
    tres, final = port_simulate(pcfg, arr, tspecs, topo=ttopo, tau=tau,
                                pools=pools)
    assert tres.run_info.backend == "cpu"
    assert tres.n_finished == len(arr)
    compare_network_results(tres, jres)
    assert_state_matches(final, jax_tree(jax_run(jcfg, arr, jspecs, tau,
                                                 pools, jtopo)), name)
    if oracle:
        check_oracle(tres, oracle_run(jcfg, arr, jspecs, tau, pools, jtopo),
                     len(arr))
    return tres


def check_oracle(res, orc, n_jobs: int) -> None:
    """The reference's own tolerances against the oracle: latency
    rtol/atol 1e-4, server energy rel 2e-3, flows dropped exact."""
    lat_o = orc.latencies()
    assert len(lat_o) == n_jobs
    np.testing.assert_allclose(np.sort(res.latencies), np.sort(lat_o),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.server_energy, orc.total_energy(),
                               rtol=2e-3)
    assert res.flows_dropped == orc.flows_dropped


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_ulps(got, exp) -> float:
    """Largest |got - exp| in units of the last place of exp's dtype."""
    got, exp = np.asarray(got), np.asarray(exp)
    if exp.size == 0:
        return 0.0
    up = np.spacing(np.abs(exp).astype(exp.dtype))
    return float(np.max(np.abs(got.astype(np.float64) - exp) / up))


def check_leaf(got, exp, ctx: str, max_ulp: float = 1.0) -> None:
    """Discrete values exactly; floats within ``max_ulp`` ulps (XLA may
    contract a multiply-add into an FMA, which rounds once instead of
    twice: one ulp)."""
    g, e = to_np(got), np.asarray(exp)
    assert g.shape == e.shape, f"{ctx}: shape {g.shape} vs {e.shape}"
    if e.dtype.kind == "f":
        assert g.dtype == e.dtype, f"{ctx}: dtype {g.dtype} vs {e.dtype}"
        u = max_ulps(g, e)
        assert u <= max_ulp, f"{ctx}: {u} ulps apart"
    else:
        np.testing.assert_array_equal(g, e, err_msg=ctx)


def check_obj(port_obj, jax_obj, ctx: str, max_ulp: float = 1.0) -> None:
    """Every field of a port state dataclass against the reference's."""
    for f in dataclasses.fields(port_obj):
        check_leaf(getattr(port_obj, f.name), getattr(jax_obj, f.name),
                   f"{ctx}.{f.name}", max_ulp)


# --------------------------------------------------------------------------
# thermal scenarios: tests/test_thermal.py's, trace off (a caller turns
# it on with trace=TraceConfig(enabled=True)).  Each maker takes a jobs
# module (the reference's or the port's) and returns (reference
# SimConfig, arrivals, specs, tau, topology module name or None).
# --------------------------------------------------------------------------

HOT = dict(enabled=True, r_th=0.5, tau_th=2.0, t_inlet=22.0, recirc=0.2,
           rack_size=3)


def _thermal_workload(mod, n_jobs=150, lam=60.0, seed=3, svc_seed=7,
                      mean=0.02):
    rng = np.random.default_rng(svc_seed)
    arr = workload.poisson_arrivals(lam, n_jobs, seed=seed)
    return arr, [mod.dag_single(rng.exponential(mean))
                 for _ in range(n_jobs)]


def _oracle_sweep(policy, tau, throttle):
    def make(mod):
        tcfg = ThermalConfig(**HOT, t_throttle=50.0 if throttle else INF,
                             t_release=45.0 if throttle else INF,
                             throttle_freq=0.5, throttle_power_scale=0.6,
                             carbon_period=600.0, price_period=600.0)
        cfg = SimConfig(n_servers=6, n_cores=2, max_jobs=256,
                        tasks_per_job=1,
                        sched_policy=SchedPolicy.LOAD_BALANCE,
                        sleep_policy=policy, sleep_state=SrvState.S3,
                        max_events=60_000, thermal=tcfg)
        return (cfg, *_thermal_workload(mod), tau, None)
    return make


def _steady_state(mod):
    tcfg = ThermalConfig(enabled=True, r_th=0.5, tau_th=0.05, recirc=0.0)
    cfg = SimConfig(n_servers=2, n_cores=1, max_jobs=16, tasks_per_job=1,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=10_000,
                    thermal=tcfg)
    return cfg, np.asarray([0.0]), [mod.dag_single(5.0)], None, None


def _exact_crossing(mod):
    tcfg = ThermalConfig(enabled=True, r_th=0.5, tau_th=1.0, recirc=0.0,
                         t_throttle=50.0, t_release=40.0, crossing_guard=INF,
                         throttle_freq=0.5, throttle_power_scale=1.0)
    cfg = SimConfig(n_servers=1, n_cores=1, max_jobs=16, tasks_per_job=1,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=5_000,
                    thermal=tcfg)
    return cfg, np.asarray([0.0]), [mod.dag_single(4.0)], None, None


def _tiny_crossing(mod):
    tcfg = ThermalConfig(enabled=True, r_th=0.5, tau_th=1.0, recirc=0.0,
                         t_throttle=55.503, t_release=55.0,
                         throttle_freq=0.5)
    cfg = SimConfig(n_servers=1, n_cores=1, max_jobs=16, tasks_per_job=1,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=2_000,
                    thermal=tcfg)
    return cfg, np.asarray([86400.0]), [mod.dag_single(2.0)], None, None


def _thermal_aware(mod, policy=SchedPolicy.THERMAL_AWARE):
    tcfg = ThermalConfig(**{**HOT, "recirc": 0.6, "rack_size": 4})
    cfg = SimConfig(n_servers=6, n_cores=1, max_jobs=256, tasks_per_job=1,
                    sched_policy=policy,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=60_000,
                    thermal=tcfg)
    return (cfg, *_thermal_workload(mod, n_jobs=120, lam=25.0, mean=0.08),
            None, None)


def _windows(mod):
    tcfg = ThermalConfig(**HOT, carbon_period=120.0, carbon_swing=0.5,
                         price_period=120.0, price_swing=0.5)
    cfg = SimConfig(n_servers=4, n_cores=2, max_jobs=256, tasks_per_job=1,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=40_000,
                    thermal=tcfg,
                    telemetry=TelemetryConfig(n_windows=64, window_dt=0.2))
    return (cfg, *_thermal_workload(mod, n_jobs=150, lam=50.0), None,
            None)


def _per_rack(mod):
    tcfg = ThermalConfig(enabled=True, r_th=0.5, tau_th=0.05, recirc=0.0,
                         rack_size=1, t_setpoint=(16.0, 26.0))
    cfg = SimConfig(n_servers=2, n_cores=1, max_jobs=16, tasks_per_job=1,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=10_000,
                    thermal=tcfg)
    return (cfg, np.asarray([0.0, 0.0]),
            [mod.dag_single(5.0), mod.dag_single(5.0)], None, None)


def _control_plane(mod):
    tcfg = ThermalConfig(**HOT, t_setpoint=(16.0, 26.0),
                         ambient_swing=3.0, ambient_period=40.0,
                         ctrl_period=0.5, ctrl_target=55.0, ctrl_band=2.0,
                         ctrl_step=1.0, ctrl_min=14.0, ctrl_max=27.0,
                         t_throttle=58.0, t_release=52.0,
                         throttle_freq=0.5, throttle_power_scale=0.6,
                         carbon_period=60.0, price_period=60.0)
    cfg = SimConfig(n_servers=6, n_cores=2, max_jobs=256, tasks_per_job=1,
                    sched_policy=SchedPolicy.LOAD_BALANCE,
                    sleep_policy=SleepPolicy.SINGLE_TIMER,
                    sleep_state=SrvState.S3, max_events=80_000,
                    thermal=tcfg)
    return (cfg, *_thermal_workload(mod, n_jobs=150, lam=40.0, mean=0.04),
            0.05, None)


def _setpoint_ctrl(mod):
    tcfg = ThermalConfig(enabled=True, r_th=0.5, tau_th=0.2, recirc=0.0,
                         rack_size=1, t_setpoint=22.0,
                         ctrl_period=0.5, ctrl_target=58.0, ctrl_band=2.0,
                         ctrl_step=1.0, ctrl_min=12.0, ctrl_max=26.0)
    cfg = SimConfig(n_servers=2, n_cores=1, max_jobs=16, tasks_per_job=1,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=10_000,
                    thermal=tcfg)
    return cfg, np.asarray([0.0]), [mod.dag_single(6.0)], None, None


def _deferral(mod):
    tcfg = ThermalConfig(**HOT, carbon_base=300.0, carbon_swing=0.6,
                         carbon_period=120.0, defer_threshold=320.0)
    cfg = SimConfig(n_servers=6, n_cores=2, max_jobs=256, tasks_per_job=1,
                    sched_policy=SchedPolicy.CARBON_AWARE,
                    sleep_policy=SleepPolicy.SINGLE_TIMER,
                    sleep_state=SrvState.PKG_C6, max_events=60_000,
                    thermal=tcfg)
    rng = np.random.default_rng(7)
    n = 150
    arr = workload.wiki_like_trace(n, 4.0, period=120.0, swing=0.5, seed=3)
    specs = [mod.dag_single(rng.exponential(0.05), deferrable=(j % 2 == 0),
                            defer_slack=60.0) for j in range(n)]
    return cfg, arr, specs, 0.5, None


_DEADLINE_THERMAL = dict(carbon_base=300.0, carbon_swing=0.2,
                         carbon_period=600.0, defer_threshold=100.0)


def _deadline(mod):
    tcfg = ThermalConfig(**HOT, **_DEADLINE_THERMAL)
    cfg = SimConfig(n_servers=2, n_cores=1, max_jobs=16, tasks_per_job=1,
                    sched_policy=SchedPolicy.CARBON_AWARE,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=5_000,
                    thermal=tcfg)
    specs = [mod.dag_single(0.25, deferrable=True, defer_slack=3.0),
             mod.dag_single(0.25, deferrable=True)]
    return cfg, np.asarray([0.0, 0.0]), specs, None, None


def _release_train(mod):
    tcfg = ThermalConfig(**HOT, **_DEADLINE_THERMAL)
    cfg = SimConfig(n_servers=2, n_cores=1, max_jobs=32, tasks_per_job=1,
                    sched_policy=SchedPolicy.CARBON_AWARE,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=10_000,
                    thermal=tcfg)
    n_def = cfg.arrivals_per_step + 3
    arr = np.concatenate([np.zeros(n_def), [3.0]])
    specs = [mod.dag_single(0.5, deferrable=True, defer_slack=3.0)
             for _ in range(n_def)] + [mod.dag_single(0.5)]
    return cfg, arr, specs, None, None


def _parked_dag(mod):
    tcfg = ThermalConfig(**HOT, **_DEADLINE_THERMAL)
    cfg = SimConfig(n_servers=3, n_cores=1, max_jobs=16, tasks_per_job=2,
                    max_children=2, sched_policy=SchedPolicy.CARBON_AWARE,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=10_000,
                    thermal=tcfg)
    parked = mod.dag_chain([0.4, 0.4])
    parked.deferrable, parked.defer_slack = True, 5.0
    return (cfg, np.asarray([0.0, 0.1]), [mod.dag_chain([0.4, 0.4]), parked],
            None, None)


def _k_sweep(mod):
    tcfg = ThermalConfig(**HOT, t_setpoint=(16.0, 24.0),
                         ambient_swing=3.0, ambient_period=40.0,
                         ctrl_period=0.5, ctrl_target=55.0,
                         t_throttle=58.0, t_release=52.0,
                         throttle_freq=0.5, throttle_power_scale=0.6,
                         carbon_base=300.0, carbon_swing=0.6,
                         carbon_period=60.0, defer_threshold=330.0)
    cfg = SimConfig(n_servers=6, n_cores=2, max_jobs=256, tasks_per_job=1,
                    sched_policy=SchedPolicy.CARBON_AWARE,
                    sleep_policy=SleepPolicy.SINGLE_TIMER,
                    sleep_state=SrvState.PKG_C6, max_events=80_000,
                    thermal=tcfg)
    rng = np.random.default_rng(7)
    n = 120
    arr = workload.wiki_like_trace(n, 4.0, period=60.0, swing=0.5, seed=3)
    specs = [mod.dag_single(rng.exponential(0.05), deferrable=(j % 2 == 0),
                            defer_slack=30.0) for j in range(n)]
    return cfg, arr, specs, 0.5, None


def _fat_tree(mod):
    """Network mode on case D's k=4 fat-tree with the thermal subsystem and
    throttling: racks come from the topology (first-hop switches)."""
    tcfg = ThermalConfig(**{**HOT, "t_throttle": 60.0, "t_release": 55.0})
    cfg = SimConfig(n_servers=16, n_cores=2, max_jobs=64, tasks_per_job=2,
                    max_flows=64, has_network=True,
                    sched_policy=SchedPolicy.ROUND_ROBIN,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=50_000,
                    thermal=tcfg)
    rng = np.random.default_rng(3)
    arr = workload.poisson_arrivals(30.0, 48, seed=4)
    specs = [mod.dag_chain(rng.exponential(0.05, size=2), edge_bytes=50e6)
             for _ in range(48)]
    return cfg, arr, specs, None, "fat_tree"


def assert_windows_within_clock_tol(got, exp, t_end: float, ctx: str):
    """The window columns when the clock's leaves are held at rtol 1e-5: a
    window's column integrates its rate over the intervals that land in
    it, so a clock shifted within that tolerance (1e-5 * t_end seconds at
    most) moves it by that much time at the column's largest rate.  Each
    column is held at rtol 1e-5 plus that absolute amount."""
    occ = exp[:, 0:1]
    rate = np.abs(exp) / np.where(occ > 0, occ, np.inf)
    atol = RTOL * t_end * rate.max(axis=0)
    bad = np.abs(got.astype(np.float64) - exp) > RTOL * np.abs(exp) + atol
    assert not bad.any(), (f"{ctx}: telem.win beyond the clock's tolerance "
                           f"at {np.argwhere(bad)[:5].tolist()}")


# name -> (maker, whether tests/oracle.py models it)
THERMAL_SCENARIOS = {
    "oracle_always_on": (_oracle_sweep(SleepPolicy.ALWAYS_ON, None, False),
                         True),
    "oracle_timer": (_oracle_sweep(SleepPolicy.SINGLE_TIMER, 0.05, False),
                     True),
    "oracle_always_on_throttle": (
        _oracle_sweep(SleepPolicy.ALWAYS_ON, None, True), True),
    "oracle_timer_throttle": (
        _oracle_sweep(SleepPolicy.SINGLE_TIMER, 0.05, True), True),
    "steady_state": (_steady_state, False),
    "exact_crossing": (_exact_crossing, False),
    "tiny_crossing_large_t": (_tiny_crossing, False),
    "thermal_aware": (_thermal_aware, True),
    "window_conservation": (_windows, False),
    "per_rack_setpoints": (_per_rack, True),
    "control_plane": (_control_plane, True),
    "setpoint_controller": (_setpoint_ctrl, False),
    "deferral": (_deferral, True),
    "deadline": (_deadline, True),
    "release_train": (_release_train, True),
    "parked_dag": (_parked_dag, True),
    "k_sweep": (_k_sweep, False),
    "fat_tree_k4": (_fat_tree, False),
}


def thermal_scenario(name, side: str, **cfg_kw):
    """(SimConfig, arrivals, specs, tau, topology) of a named thermal
    scenario for ``side`` "jax" or "port"."""
    make = THERMAL_SCENARIOS[name][0]
    if side == "jax":
        from repro.core import topology as topo_mod
        cfg, arr, specs, tau, topo = make(jjobs)
        cfg = dataclasses.replace(cfg, **cfg_kw) if cfg_kw else cfg
    else:
        from repro_torch.core import jobs as tjobs
        from repro_torch.core import topology as topo_mod
        cfg, arr, specs, tau, topo = make(tjobs)
        cfg = port_cfg(cfg, **cfg_kw)
    if topo is not None:
        topo = getattr(topo_mod, topo)(4, 1.25e9)
    return cfg, arr, specs, tau, topo


def compare_thermal_results(tres, jres, windows: bool = True) -> None:
    """compare_results, plus the thermal outcome: deferred jobs and the
    final setpoints exact; temperatures, cooling, carbon, cost, throttle
    and deferral seconds, the grams-avoided estimate and (``windows``)
    the seven thermal window series rtol 1e-5."""
    compare_results(tres, jres, windows)
    assert tres.deferred_jobs == jres.deferred_jobs
    np.testing.assert_array_equal(tres.setpoints, jres.setpoints)
    for f in ("cooling_energy", "carbon_g", "energy_cost", "peak_temp",
              "mean_temp", "throttle_seconds", "deferred_seconds",
              "carbon_g_avoided_est", "temps", "peak_temps"):
        np.testing.assert_allclose(getattr(tres, f), getattr(jres, f),
                                   rtol=RTOL, atol=1e-6, err_msg=f)
    if not windows:
        return
    for f in ("cooling_power", "mean_temp", "max_temp", "carbon_intensity",
              "price", "carbon_per_window", "cost_per_window"):
        np.testing.assert_allclose(getattr(tres.telemetry, f),
                                   getattr(jres.telemetry, f), rtol=RTOL,
                                   atol=1e-6, err_msg=f)


def thermal_three_way(name: str, **cfg_kw):
    """A named thermal scenario through the reference's farm.simulate, the
    port's on the CPU and, where it models the case, the heapq oracle
    (with test_thermal.py's tolerances); then every leaf of both engines'
    final states.  Returns (port SimResult, reference SimResult)."""
    from oracle import OracleSim
    jcfg, arr, jspecs, tau, jtopo = thermal_scenario(name, "jax", **cfg_kw)
    pcfg, _, tspecs, _, ttopo = thermal_scenario(name, "port", **cfg_kw)
    jres = jfarm.simulate(jcfg, arr, jspecs, topo=jtopo, tau=tau)
    tres, final = port_simulate(pcfg, arr, tspecs, topo=ttopo, tau=tau)
    assert tres.run_info.backend == "cpu"
    assert tres.n_finished == len(arr)
    exact_clock = not jcfg.thermal.throttling
    compare_thermal_results(tres, jres, windows=exact_clock)
    if jtopo is not None:
        assert tres.flows_dropped == jres.flows_dropped
        np.testing.assert_allclose(tres.switch_energy, jres.switch_energy,
                                   rtol=RTOL)
    tree = jax_tree(jax_run(jcfg, arr, jspecs, tau, None, jtopo))
    if exact_clock:
        assert_state_matches(final, tree, name)
    else:
        assert_state_matches(final, tree, name, skip=("telem.win",),
                             tol=CLOCK_LEAVES)
        assert_windows_within_clock_tol(final.telem.win.numpy(),
                                        tree["telem.win"], float(final.t),
                                        name)
    if THERMAL_SCENARIOS[name][1]:
        orc = OracleSim(jcfg, arr, jspecs, tau=tau).run()
        assert len(orc.job_finish) == len(arr)
        np.testing.assert_allclose(np.sort(tres.latencies),
                                   np.sort(orc.latencies()), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(tres.temps, orc.temp, rtol=2e-3,
                                   atol=5e-2)
        for got, exp in ((tres.cooling_energy, orc.cool_energy),
                         (tres.carbon_g, orc.carbon_g),
                         (tres.energy_cost, orc.cost)):
            np.testing.assert_allclose(got, exp, rtol=2e-3)
        np.testing.assert_allclose(tres.throttle_seconds,
                                   orc.throttle_seconds.sum(), rtol=5e-3,
                                   atol=1e-3)
        assert tres.deferred_jobs == orc.defer_count
        np.testing.assert_array_equal(tres.setpoints, orc.t_set)
    return tres, jres


def jax_x64_finals(names, tmp_dir) -> dict:
    """{scenario: {leaf path: array}}: the named thermal scenarios through
    the reference's engine on an f64 clock.  ``jax_enable_x64`` is a
    process-wide flag, so the reference runs in a subprocess and hands
    its final states back as .npz files in ``tmp_dir``."""
    import os
    import pathlib
    import subprocess
    import sys
    here = pathlib.Path(__file__).resolve().parent
    code = (
        "import sys, numpy as np, jax\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import jax.numpy as jnp\n"
        "from torch_port_util import thermal_scenario, jax_run, jax_tree\n"
        "for name in sys.argv[2:]:\n"
        "    cfg, arr, specs, tau, topo = thermal_scenario(\n"
        "        name, 'jax', time_dtype=jnp.float64)\n"
        "    tree = jax_tree(jax_run(cfg, arr, specs, tau, None, topo))\n"
        "    np.savez(f'{sys.argv[1]}/{name}.npz', **tree)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(here.parent / "src"),
                                           str(here)]))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_dir), *names],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    finals = {}
    for name in names:
        with np.load(f"{tmp_dir}/{name}.npz") as z:
            finals[name] = {k: z[k] for k in z.files}
    return finals


# --------------------------------------------------------------------------
# the seed scalar hot loops (SimConfig(use_vectorized_hot_loop=False)):
# the scenarios of tests/test_engine_vectorized.py and
# tests/test_network_flows.py that hold vectorized == scalar.  Each maker
# takes a jobs module (and, for the network ones, a topology module) of
# either package and returns (SimConfig kwargs, arrivals, specs, tau[,
# topology]).
# --------------------------------------------------------------------------

SCALAR = dict(use_vectorized_hot_loop=False)


def close_leaves(got, exp, context):
    """The reference's ``_final_states_equal``: every leaf of two port
    states within rtol/atol 1e-6, as float64."""
    for (path, a), (_, b) in zip(tree_leaves(got), tree_leaves(exp)):
        np.testing.assert_allclose(to_np(a).astype(np.float64),
                                   to_np(b).astype(np.float64), rtol=1e-6,
                                   atol=1e-6,
                                   err_msg=f"{context}: leaf {path}")


def scalar_three(jcfg, arr, jspecs, tspecs, tau=None, jtopo=None,
                 ttopo=None, ctx=""):
    """A scenario through the reference's engine and the port's in scalar
    mode, and the port's in vectorized mode: port scalar == JAX scalar
    leaf for leaf (``assert_state_matches``), == port vectorized within
    ``close_leaves``.  Returns the port's scalar final state."""
    jcfg = dataclasses.replace(jcfg, **SCALAR)
    tree = jax_tree(jax_run(jcfg, arr, jspecs, tau, None, jtopo))
    pcfg = port_cfg(jcfg)
    fin = port_run(pcfg, arr, tspecs, tau, topo=ttopo)
    assert bool(fin.done), ctx
    assert_state_matches(fin, tree, f"{ctx}: port scalar vs JAX scalar")
    vec = port_run(dataclasses.replace(pcfg, use_vectorized_hot_loop=True),
                   arr, tspecs, tau, topo=ttopo)
    close_leaves(fin, vec, f"{ctx}: scalar vs vectorized")
    return fin


def _s_overflow_dag(mod):
    rng = np.random.default_rng(3)
    arr = np.sort(rng.uniform(0, 0.2, 25))
    specs = [mod.dag_chain(rng.uniform(0.2, 0.6, size=3)) for _ in range(25)]
    return dict(n_servers=2, n_cores=1, local_q=2, max_jobs=32,
                tasks_per_job=3, sleep_policy=SleepPolicy.SINGLE_TIMER,
                sleep_state=SrvState.S3), arr, specs, 0.05


def _s_rr_overflow(mod):
    rng = np.random.default_rng(5)
    arr = np.sort(rng.uniform(0, 0.5, 40))
    specs = [mod.dag_single(rng.uniform(0.3, 0.8)) for _ in range(40)]
    return dict(n_servers=3, n_cores=1, local_q=1, max_jobs=64,
                sched_policy=SchedPolicy.ROUND_ROBIN,
                sleep_policy=SleepPolicy.ALWAYS_ON), arr, specs, None


def _s_single_server_overflow(mod):
    arr = 0.1 * (1 + np.arange(30))
    specs = [mod.dag_chain([100.0, 100.0]) for _ in range(30)]
    return dict(n_servers=1, n_cores=1, local_q=1, max_jobs=32,
                tasks_per_job=2, sleep_policy=SleepPolicy.ALWAYS_ON), \
        arr, specs, None


def _s_overflow_burst(mod):
    arr = np.linspace(0.0, 0.029, 30)
    rng = np.random.default_rng(0)
    specs = [mod.dag_chain(rng.uniform(0.5, 1.0, size=3)) for _ in range(30)]
    return dict(n_servers=2, n_cores=1, local_q=2, max_jobs=32,
                tasks_per_job=3, sleep_policy=SleepPolicy.ALWAYS_ON), \
        arr, specs, None


def _s_burst(policy):
    def make(mod):
        rng = np.random.default_rng(13)
        arr = np.repeat(np.arange(1, 6) * 0.3, 7)
        specs = [mod.dag_single(rng.exponential(0.03)) for _ in range(35)]
        return dict(n_servers=5, n_cores=1, max_jobs=64, sched_policy=policy,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=40_000,
                    arrivals_per_step=8), arr, specs, None
    return make


SCALAR_FARM_SCENARIOS = {
    # tests/test_engine_vectorized.py
    "overflow_dag": _s_overflow_dag,
    "rr_overflow": _s_rr_overflow,
    "single_server_overflow": _s_single_server_overflow,
    "overflow_burst": _s_overflow_burst,
    # tests/test_network_flows.py's burst admission
    "burst_load_balance": _s_burst(SchedPolicy.LOAD_BALANCE),
    "burst_round_robin": _s_burst(SchedPolicy.ROUND_ROBIN),
}


def _s_fat_tree(sched):
    def make(mod, topo_mod):
        rng = np.random.default_rng(7)
        arr = np.sort(rng.uniform(0, 2.0, 40))
        specs = [mod.dag_chain(rng.uniform(0.01, 0.05, size=2),
                               edge_bytes=100e6) for _ in range(40)]
        kw = dict(n_servers=16, n_cores=2, max_jobs=64, tasks_per_job=2,
                  max_children=2, max_flows=128, local_q=8,
                  sched_policy=sched, sleep_policy=SleepPolicy.SINGLE_TIMER,
                  sleep_state=SrvState.S3, has_network=True,
                  max_events=60_000)
        return kw, arr, specs, 0.1, topo_mod.fat_tree(4, link_cap=1.25e9)
    return make


def _s_star(max_flows, n_jobs, seed, comm_model=0):
    """tests/test_network_flows.py's _star_cfg and _star_workload."""
    def make(mod, topo_mod):
        rng = np.random.default_rng(seed)
        arr = workload.poisson_arrivals(25.0, n_jobs, seed=seed)
        specs = [mod.dag_chain(rng.uniform(0.01, 0.04, size=2),
                               edge_bytes=float(rng.uniform(4e6, 8e6)))
                 for _ in range(n_jobs)]
        kw = dict(n_servers=6, n_cores=2, max_jobs=64, tasks_per_job=2,
                  max_children=2, max_flows=max_flows, local_q=32,
                  sched_policy=SchedPolicy.ROUND_ROBIN,
                  sleep_policy=SleepPolicy.ALWAYS_ON, has_network=True,
                  comm_model=comm_model, max_events=60_000)
        return kw, arr, specs, None, topo_mod.star(6, link_cap=1.0e8)
    return make


SCALAR_NET_SCENARIOS = {
    # tests/test_engine_vectorized.py's network property
    "fat_tree_round_robin": _s_fat_tree(SchedPolicy.ROUND_ROBIN),
    "fat_tree_network_aware": _s_fat_tree(SchedPolicy.NETWORK_AWARE),
    # tests/test_network_flows.py's flow exhaustion, and its star under
    # the packet model
    "star_exhaustion": _s_star(3, 25, 5),
    "star_packet": _s_star(64, 30, 2, comm_model=1),
}
