"""Seeded numpy inputs for the port's kernels and network functions, the
edge cases of the LM kernels, and the network scenarios: made once here
for the CPU tests, the card tests (tests/test_torch_cuda.py) and
chip_smoke.py; and ``graph_ops``, which counts the device operations of
one call on the card from a CUDA graph of it (the profiler loses
records, most often a window's first ones).
Imports neither JAX nor pytest, so it loads on a machine with a card and
PyTorch alone."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

INF = 1.0e30


def dcsim_inputs(n, c, seed, throttled=True, clock=np.float32):
    """A random farm slab: every server state, half the cores busy, some
    slots finishing exactly at t_next, timers armed on half the servers,
    ~30% throttled.  ``clock=np.float64`` makes the time-typed inputs
    float64 around t = 86,400 s, where a float32 clock would have lost
    them to its 8 ms ulp, with slots a few microseconds either side of
    t_next."""
    rng = np.random.default_rng(seed)
    t0 = 86400.0 if clock == np.float64 else 0.0
    t = clock(t0 + rng.uniform(0, 10))
    t_next = clock(t + rng.uniform(0, 1))
    busy = np.where(rng.random((n, c)) < 0.5,
                    rng.uniform(t, t + 2, (n, c)), INF).astype(clock)
    busy[rng.random((n, c)) < 0.05] = t_next
    if clock == np.float64:
        near = rng.random((n, c)) < 0.05
        busy[near] = t_next + rng.uniform(-5e-6, 5e-6, near.sum())
    state = rng.integers(0, 6, n).astype(np.int32)
    energy = rng.uniform(0, 100, n).astype(np.float32)
    bsec = rng.uniform(0, 10, n).astype(np.float32)
    wake = np.where(state == 5, rng.uniform(t, t + 3, n), INF
                    ).astype(clock)
    isince = rng.uniform(t0, t, n).astype(clock)
    tau = np.where(rng.random(n) < 0.5, rng.uniform(0.1, 2.0, n), INF
                   ).astype(clock)
    thr = (rng.random(n) < 0.3).astype(np.int32) if throttled else None
    table = np.asarray([65.0, 65.0, 15.0, 9.0, 0.0, 145.0], np.float32)
    return (busy, state, energy, bsec, t, t_next, table, 13.0, 2.0, wake,
            isince, tau, thr)


def dcsim_inputs_batched(R, n, c, seed, throttled=True, clock=np.float32,
                         inf_replica=None):
    """R farms of ``dcsim_inputs`` (replica r from seed 1000 * seed + r),
    stacked along a leading axis for the batched advance; the power table
    and coefficients are shared.  ``inf_replica`` r has every slot, wake
    and timer at INF, so its candidate is INF."""
    reps = [dcsim_inputs(n, c, 1000 * seed + r, throttled, clock)
            for r in range(R)]
    out = list(reps[0])
    for i in (0, 1, 2, 3, 4, 5, 9, 10, 11, 12):
        if reps[0][i] is not None:
            out[i] = np.stack([rep[i] for rep in reps])
    if inf_replica is not None:
        for i in (0, 9, 11):
            out[i][inf_replica] = INF
    return tuple(out)


def edge_free_vals(rng, n, lo=1e-5, hi=1e3, B=64):
    """Log-uniform latencies over [lo/10, 10 hi] (both clamps hit), moved
    off the bin edges: a 1-ulp difference between two ``log``
    implementations can move an edge value by one bin."""
    scale = B / math.log(hi / lo)
    v = np.exp(rng.uniform(math.log(lo / 10), math.log(hi * 10), n))
    raw = np.log(np.maximum(v, lo) / lo) * scale
    near = (np.abs(raw - np.round(raw)) < 1e-3) & (v > lo) & (v < hi)
    v[near] *= 1.0 + 2e-3 / scale
    return v.astype(np.float32)


def tb_inputs(J, M, B, W, K, seed, unit=True):
    """telemetry_accum inputs: 0/1 weights (``unit``; otherwise weights
    from {0, 0.5, 1, 2}, whose sums are exact in any order too),
    integer-valued histograms."""
    rng = np.random.default_rng(seed)

    def wts(n, p):
        w = (rng.random(n) < p).astype(np.float32)
        return w if unit else w * rng.choice(
            np.float32([0.5, 1.0, 2.0]), n)
    return (edge_free_vals(rng, J, B=B), wts(J, 0.4),
            edge_free_vals(rng, M, B=B), wts(M, 0.6),
            rng.integers(0, 9, B).astype(np.float32),
            rng.integers(0, 9, B).astype(np.float32),
            rng.uniform(0, 1, (W, K)).astype(np.float32),
            np.int32(rng.integers(0, W)),
            rng.uniform(0, 1, K).astype(np.float32), 1e-5, 1e3)


def tb_inputs_batched(R, J, M, B, W, K, seed, unit=True):
    """R sets of ``tb_inputs`` (replica r from seed 1000 * seed + r),
    stacked along a leading axis for the batched binning."""
    reps = [tb_inputs(J, M, B, W, K, 1000 * seed + r, unit)
            for r in range(R)]
    return tuple(np.stack([rep[i] for rep in reps]) for i in range(9)) \
        + reps[0][9:]


def torch_args(np_args, device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device)
                 if isinstance(a, (np.ndarray, np.generic)) else a
                 for a in np_args)


def flash_inputs(B, H, KV, Sq, Skv, hd, seed):
    """Standard-normal q (B, H, Sq, hd) and k/v (B, KV, Skv, hd), float32;
    cast them to bfloat16 on each side for the bf16 cases."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in
                 ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd)))


def ssm_inputs(B, S, Dss, N, seed):
    """(dt, Bm, Cm, x, A) as the Mamba mixer makes them: dt = softplus of a
    pre-activation around the init's -4.6 bias (0.001..0.2), A = -(1..N)
    per channel times a random factor, standard-normal B, C and x; all
    float32."""
    rng = np.random.default_rng(seed)
    pre = rng.normal(-4.6, 1.5, (B, S, Dss))
    dt = np.log1p(np.exp(pre)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    x = rng.standard_normal((B, S, Dss), dtype=np.float32)
    A = -(np.arange(1, N + 1, dtype=np.float32)[None, :]
          * rng.uniform(0.5, 1.5, (Dss, 1)).astype(np.float32))
    return dt, Bm, Cm, x, A


# Edges of the tensor-core (bf16) flash-attention instance, held against
# the plain version by tests/test_torch_cuda.py and chip_smoke.py:
# B, H, KV, Sq, Skv, hd, causal, window, softcap
FLASH_TC_EDGES = [
    (1, 4, 2, 100, 170, 64, True, 0, 0.0),      # Sq, Skv ragged, Sq < Skv
    (2, 4, 4, 77, 45, 64, False, 0, 0.0),       # non-causal, Sq > Skv, G=1
    (1, 10, 2, 200, 200, 128, True, 0, 0.0),    # hd 128, G=5
    (1, 5, 1, 150, 150, 256, True, 100, 0.0),   # hd 256 (32-key tiles)
    (1, 2, 2, 130, 130, 64, True, 20, 0.0),     # window < one tile
    (2, 4, 2, 300, 300, 64, True, 100, 0.0),    # window edge inside a tile
    (1, 2, 1, 300, 90, 64, True, 40, 0.0),      # rows with no unmasked key
    (1, 4, 2, 190, 190, 64, True, 0, 30.0),     # softcap
    (1, 2, 1, 65, 200, 16, False, 33, 0.0),     # hd 16, non-causal window
    (1, 4, 4, 129, 129, 32, True, 0, 0.0),      # hd 32
]

# Edges of the lane-split SSM scan: B, S, Dss, N (N of every lane split
# and a ragged last lane; S = 1 and S off the 16-step chunk; Dss off the
# channel tile)
SSM_EDGES = [
    (2, 40, 50, 1), (2, 9, 11, 2), (1, 17, 13, 3), (2, 21, 30, 7),
    (1, 33, 100, 16), (2, 1, 20, 16), (1, 20, 37, 17), (1, 50, 70, 33),
    (2, 19, 9, 64),
]


# port and line-card states (core/types.py PortState, LinecardState)
PORT_ACTIVE, PORT_LPI, PORT_OFF = 0, 1, 2


def net_inputs(topo, F, n_tasks, seed, t=1.0, n_active=None):
    """A random flow table of F slots (``n_active``, default F // 2, in
    flight; rates, latency budgets and projected completions around t)
    and switch state (ports ACTIVE, LPI and OFF, line cards either way,
    about 40% of the switches asleep, some links carrying flows) for a
    ``core.topology.Topology``, as two dicts of numpy leaves named like
    FlowTable's and NetState's fields."""
    rng = np.random.default_rng(seed)
    N = topo.n_servers
    W, P = max(topo.n_switches, 1), max(topo.n_ports, 1)
    LC, L = max(topo.n_linecards, 1), topo.n_links
    k = F // 2 if n_active is None else n_active
    active = np.zeros(F, bool)
    active[rng.choice(F, k, replace=False)] = True
    src = rng.integers(0, N, F)
    dst = (src + rng.integers(1, N, F)) % N
    rate = np.where(rng.random(F) < 0.8, rng.uniform(1e6, 1e8, F), 0.0)
    f32, i32 = np.float32, np.int32
    flows = dict(
        src=np.where(active | (rng.random(F) < 0.5), src, -1).astype(i32),
        dst=np.where(active | (rng.random(F) < 0.5), dst, -1).astype(i32),
        rem=rng.uniform(0, 1e7, F).astype(f32),
        rate=(rate * active).astype(f32),
        extra=np.where(rng.random(F) < 0.5, rng.uniform(0, 2e-2, F),
                       0.0).astype(f32),
        done_at=np.where(active, rng.uniform(t - 0.1, t + 0.5, F),
                         INF).astype(f32),
        child=np.where(active, rng.integers(0, n_tasks, F), -1).astype(i32),
        active=active,
        flows_dropped=np.asarray(rng.integers(0, 3), i32))
    net = dict(
        port_state=rng.choice([PORT_ACTIVE, PORT_LPI, PORT_OFF], (W, P),
                              p=[0.4, 0.5, 0.1]).astype(i32),
        port_idle_since=rng.uniform(t - 3e-3, t, (W, P)).astype(f32),
        lc_state=rng.integers(0, 2, (W, LC)).astype(i32),
        sw_awake=rng.random(W) < 0.6,
        link_flows=np.where(rng.random(L) < 0.5, rng.integers(1, 4, L),
                            0).astype(i32),
        sw_energy=rng.uniform(0, 50, W).astype(f32),
        port_residency=rng.uniform(0, 1, (W, P, 3)).astype(f32))
    return flows, net


def edge_inputs(N, n_tasks, seed, E=24):
    """A batch of E DAG edges for ``spawn_flows_many`` among N servers:
    about 70% needing a flow, most drawn from four source/destination
    pairs so that edges repeat routes."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, N, (4, 2))
    pairs[:, 1] = (pairs[:, 0] + 1 + pairs[:, 1] % (N - 1)) % N
    pick = rng.integers(0, 4, E)
    src, dst = pairs[pick, 0], pairs[pick, 1]
    lone = rng.random(E) < 0.4
    src = np.where(lone, rng.integers(0, N, E), src)
    dst = np.where(lone, (src + rng.integers(1, N, E)) % N, dst)
    need = rng.random(E) < 0.7
    keep = need | (rng.random(E) < 0.5)
    return dict(need=need, src=np.where(keep, src, -1).astype(np.int32),
                dst=np.where(keep, dst, -1).astype(np.int32),
                nbytes=rng.uniform(1e5, 1e8, E).astype(np.float32),
                child=rng.integers(0, n_tasks, E).astype(np.int32))


# --------------------------------------------------------------------------
# network scenarios: (SimConfig kwargs, arrivals, specs, tau, topology),
# with the jobs and topology modules of either package
# --------------------------------------------------------------------------

def star_scenario(jobs_mod, topo_mod, max_flows, comm_model=0):
    """tests/test_network_flows.py's star: ROUND_ROBIN splits every
    two-task chain across servers, so each of the 30 jobs routes one flow
    over one switch, and the link caps make the transfers overlap."""
    from repro_torch.core import workload
    from repro_torch.core.types import SchedPolicy, SleepPolicy
    rng = np.random.default_rng(2)
    arr = workload.poisson_arrivals(25.0, 30, seed=2)
    specs = [jobs_mod.dag_chain(rng.uniform(0.01, 0.04, size=2),
                                edge_bytes=float(rng.uniform(4e6, 8e6)))
             for _ in range(30)]
    kw = dict(n_servers=6, n_cores=2, max_jobs=64, tasks_per_job=2,
              max_children=2, max_flows=max_flows, local_q=32,
              sched_policy=SchedPolicy.ROUND_ROBIN,
              sleep_policy=SleepPolicy.ALWAYS_ON, has_network=True,
              comm_model=comm_model, max_events=60_000)
    return kw, arr, specs, None, topo_mod.star(6, link_cap=1.0e8)


def case_d_scenario(jobs_mod, topo_mod, policy, k=4, n_jobs=300,
                    lam=30.0, max_jobs=512):
    """benchmarks/case_d_network.py's configuration with bench_engine
    network_farm's max_flows=1024 headroom: two-task chains with 100 MB
    edges, U(0.01, 0.05) s service, Poisson arrivals at ``lam``, delay
    timers of 0.2 s into S3 (SINGLE_TIMER), fluid flows, on a fat-tree of
    arity k (k=4 is case D's 16 servers)."""
    from repro_torch.core import workload
    from repro_torch.core.types import SleepPolicy, SrvState
    rng = np.random.default_rng(0)
    specs = [jobs_mod.dag_chain(rng.uniform(0.01, 0.05, size=2),
                                edge_bytes=100e6) for _ in range(n_jobs)]
    arr = workload.poisson_arrivals(lam, n_jobs, seed=4)
    topo = topo_mod.fat_tree(k, link_cap=1.25e9)
    kw = dict(n_servers=topo.n_servers, n_cores=4, max_jobs=max_jobs,
              tasks_per_job=2, max_children=2, max_flows=1024, local_q=64,
              sched_policy=policy, sleep_policy=SleepPolicy.SINGLE_TIMER,
              sleep_state=SrvState.S3,
              has_network=True, comm_model=0, max_events=60_000)
    return kw, arr, specs, 0.2, topo


def thermal_main_scenario(jobs, workload, n_servers, n_jobs=600):
    """The thermal slice's main configuration: benchmarks/bench_engine.py
    control_plane_farm (per-rack setpoints at 18 C and their controller,
    diurnal ambient, CARBON_AWARE deferral of every second job with 30 s of
    slack) with throttling armed at 44.5 / 43.5 C, as thermal_overhead
    arms it, 5 s mean service and Poisson arrivals at 20 jobs/s, so every
    branch of the subsystem fires in a run whose event count does not grow
    with the farm's width.  ``jobs``/``workload`` are the package's
    modules.  Returns (SimConfig kwargs, ThermalConfig kwargs, arrivals,
    specs)."""
    thermal = dict(enabled=True, r_th=0.25, tau_th=30.0, t_setpoint=18.0,
                   ctrl_period=0.5, ctrl_target=45.0, ambient_swing=3.0,
                   ambient_period=120.0, carbon_base=350.0,
                   carbon_swing=0.5, carbon_period=120.0,
                   defer_threshold=350.0, t_throttle=44.5, t_release=43.5)
    kw = dict(n_servers=n_servers, n_cores=4, local_q=64,
              max_jobs=max(n_jobs, 16), tasks_per_job=1,
              sched_policy=6,                 # SchedPolicy.CARBON_AWARE
              sleep_policy=0,                 # SleepPolicy.ALWAYS_ON
              max_events=20_000, events_per_step=8)
    rng = np.random.default_rng(0)
    arr = workload.poisson_arrivals(20.0, n_jobs, seed=0)
    specs = [jobs.dag_single(rng.exponential(5.0), deferrable=(j % 2 == 0),
                             defer_slack=30.0) for j in range(n_jobs)]
    return kw, thermal, arr, specs


def thermal_case_scenario(jobs, workload, n_jobs=500):
    """examples/thermal_case.py's thermal-aware scenario, trace off: 12
    servers x 2 cores in 3 racks of 4 with 30% recirculation, THERMAL_AWARE
    placement behind a throttle guard (engage 60 C, release 54 C), a PkgC6
    delay timer of 0.5 s, a diurnal wiki-like workload on a 120 s "day".
    Returns (SimConfig kwargs, ThermalConfig kwargs, TelemetryConfig
    kwargs, arrivals, specs, tau)."""
    thermal = dict(enabled=True, r_th=0.35, tau_th=3.0, t_inlet=22.0,
                   recirc=0.3, rack_size=4, throttle_freq=0.5,
                   throttle_power_scale=0.6, carbon_base=350.0,
                   carbon_swing=0.5, carbon_period=120.0, price_base=0.12,
                   price_swing=0.6, price_period=120.0, t_throttle=60.0,
                   t_release=54.0)
    kw = dict(n_servers=12, n_cores=2, max_jobs=max(n_jobs, 16),
              tasks_per_job=1,
              sched_policy=5,                 # SchedPolicy.THERMAL_AWARE
              sleep_policy=1,                 # SleepPolicy.SINGLE_TIMER
              sleep_state=2,                  # SrvState.PKG_C6
              max_events=200_000)
    rng = np.random.default_rng(0)
    arr = workload.wiki_like_trace(n_jobs, mean_rate=20.0, period=120.0,
                                   swing=0.6, seed=1)
    specs = [jobs.dag_single(rng.exponential(0.35)) for _ in range(n_jobs)]
    return kw, thermal, dict(n_windows=128, window_dt=1.0), arr, specs, 0.5


# --------------------------------------------------------------------------
# replica scenarios: the reference's own replica batches
# (tests/test_montecarlo.py, tests/test_telemetry.py, tests/test_thermal.py,
# and tests/test_trace.py's rich scenario at R = 2)
# --------------------------------------------------------------------------

# tests/test_telemetry.py's TEL and tests/test_thermal.py's HOT
MC_TEL = dict(n_bins=128, lat_lo=1e-4, lat_hi=10.0, n_windows=128,
              window_dt=0.05, tail_thresh=0.04)
MC_HOT = dict(enabled=True, r_th=0.5, tau_th=2.0, t_inlet=22.0, recirc=0.2,
              rack_size=3, t_throttle=50.0, t_release=45.0)
MC_SCENARIOS = ("replicas_r3", "tau_sweep_r", "tau_sweep_rn", "fat_tree_rr",
                "telemetry_hist", "telemetry_empty", "thermal_sweep",
                "traced_rich_cap64")


def mc_scenario(name, jobs_mod):
    """(SimConfig kwargs, {"telemetry"/"thermal"/"trace": kwargs of the
    nested config}, arrivals (R, J), specs built with ``jobs_mod``, taus
    (None, (R,) or (R, N)), network: a k=4 fat-tree at 1.25 GB/s) of a
    named replica scenario, for either package."""
    from repro_torch.core import workload

    def singles(n, seed, mean):
        rng = np.random.default_rng(seed)
        return [jobs_mod.dag_single(rng.exponential(mean)) for _ in range(n)]

    def arrs(lam, n, seeds):
        return np.stack([workload.poisson_arrivals(lam, n, seed=s)
                         for s in seeds])

    base = dict(n_servers=4, n_cores=2, local_q=64, max_jobs=128,
                tasks_per_job=1, sleep_policy=0, max_events=10_000)
    if name in ("replicas_r3", "telemetry_hist"):
        nested = {"telemetry": MC_TEL} if name == "telemetry_hist" else {}
        return (base, nested, arrs(150.0, 80, range(3)),
                singles(80, 0, 0.01), None, False)
    if name in ("tau_sweep_r", "tau_sweep_rn"):
        taus = np.asarray([0.01, 0.1, 1.0])
        if name == "tau_sweep_rn":
            taus = taus[:, None] * (1.0 + 0.25 * np.arange(4))
        return (dict(base, sleep_policy=1), {},     # SINGLE_TIMER
                np.stack([workload.poisson_arrivals(30.0, 60, seed=7)] * 3),
                singles(60, 1, 0.02), taus, False)
    if name == "fat_tree_rr":
        rng = np.random.default_rng(2)
        specs = [jobs_mod.dag_chain(rng.uniform(0.01, 0.04, size=2),
                                    edge_bytes=50e6) for _ in range(40)]
        kw = dict(n_servers=16, n_cores=2, local_q=16, max_jobs=64,
                  tasks_per_job=2, max_children=2, max_flows=128,
                  sched_policy=0, sleep_policy=0,     # ROUND_ROBIN
                  has_network=True, max_events=20_000)
        return kw, {}, arrs(25.0, 40, range(2)), specs, None, True
    if name == "telemetry_empty":
        kw = dict(n_servers=2, n_cores=1, local_q=8, max_jobs=16,
                  tasks_per_job=1, sleep_policy=0, max_events=1,
                  events_per_step=1)
        return (kw, {"telemetry": MC_TEL}, arrs(50.0, 8, range(2)),
                singles(8, 0, 0.01), None, False)
    if name == "thermal_sweep":
        kw = dict(n_servers=4, n_cores=2, max_jobs=64, tasks_per_job=1,
                  sleep_policy=0, max_events=20_000)
        return (kw, {"thermal": MC_HOT}, arrs(40.0, 60, range(3)),
                singles(60, 0, 0.02), None, False)
    if name == "traced_rich_cap64":
        th = dict(MC_HOT, throttle_freq=0.5, throttle_power_scale=0.6,
                  carbon_period=600.0, price_period=600.0)
        kw = dict(n_servers=6, n_cores=2, max_jobs=256, tasks_per_job=1,
                  sched_policy=1, sleep_policy=1,   # LOAD_BALANCE, timer
                  sleep_state=3, max_events=60_000)  # into S3
        rng = np.random.default_rng(7)
        specs = [jobs_mod.dag_single(s) for s in rng.exponential(0.02, 150)]
        return (kw, {"thermal": th, "trace": dict(enabled=True,
                                                   capacity=64)},
                arrs(60.0, 150, (3, 4)), specs, np.full(2, 0.05), False)
    raise ValueError(f"unknown replica scenario {name!r}")


def mc_config(types_mod, kw, nested):
    """The SimConfig of ``mc_scenario``'s parts, in either package."""
    made = {"telemetry": types_mod.TelemetryConfig,
            "thermal": types_mod.ThermalConfig,
            "trace": types_mod.TraceConfig}
    return types_mod.SimConfig(**kw, **{k: made[k](**v)
                                        for k, v in nested.items()})


# --------------------------------------------------------------------------
# the sharded engine's four pinned configurations (tests/test_sharding.py's
# 8-device test: sleep states, star flows, throttling, carbon deferral)
# --------------------------------------------------------------------------

SHARD_SCENARIOS = ("lb_sleep", "rr_star", "thermal_throttle", "carbon_aware")
SHARD_TH = dict(enabled=True, r_th=0.5, tau_th=2.0, t_inlet=22.0, recirc=0.2,
                rack_size=2)


def shard_scenario(name, jobs_mod, topo_mod, types_mod):
    """(SimConfig, arrivals, specs built with ``jobs_mod``, topology or
    None, tau or None (a scalar written to every ``farm.srv_tau`` after
    ``init_state``)) of a pinned sharding scenario, for either package."""
    from repro_torch.core import workload
    T = types_mod
    traced = T.TraceConfig(enabled=True)
    if name == "lb_sleep":
        cfg = T.SimConfig(n_servers=16, n_cores=2, max_jobs=256,
                          sched_policy=T.SchedPolicy.LOAD_BALANCE,
                          sleep_policy=T.SleepPolicy.SINGLE_TIMER,
                          max_events=60_000, trace=traced)
        rng = np.random.default_rng(7)
        arr = workload.poisson_arrivals(60.0, 150, seed=3)
        specs = [jobs_mod.dag_single(rng.exponential(0.02))
                 for _ in range(150)]
        return cfg, arr, specs, None, 0.05
    if name == "rr_star":
        cfg = T.SimConfig(n_servers=16, n_cores=2, max_jobs=64,
                          tasks_per_job=2, max_children=2, max_flows=64,
                          local_q=32, sched_policy=T.SchedPolicy.ROUND_ROBIN,
                          sleep_policy=T.SleepPolicy.ALWAYS_ON,
                          has_network=True, comm_model=0, max_events=60_000,
                          trace=traced)
        rng = np.random.default_rng(2)
        arr = workload.poisson_arrivals(25.0, 30, seed=2)
        specs = [jobs_mod.dag_chain(rng.uniform(0.01, 0.04, size=2),
                                    edge_bytes=float(rng.uniform(4e6, 8e6)))
                 for _ in range(30)]
        return cfg, arr, specs, topo_mod.star(16, link_cap=1.0e8), None
    if name == "thermal_throttle":
        th = T.ThermalConfig(**SHARD_TH, t_throttle=50.0, t_release=45.0,
                             throttle_freq=0.5, throttle_power_scale=0.6,
                             carbon_period=600.0, price_period=600.0)
        cfg = T.SimConfig(n_servers=16, n_cores=2, max_jobs=256,
                          sched_policy=T.SchedPolicy.THERMAL_AWARE,
                          max_events=60_000, thermal=th, trace=traced)
        rng = np.random.default_rng(11)
        arr = workload.poisson_arrivals(80.0, 150, seed=5)
        specs = [jobs_mod.dag_single(rng.exponential(0.02))
                 for _ in range(150)]
        return cfg, arr, specs, None, None
    if name == "carbon_aware":
        th = T.ThermalConfig(**SHARD_TH, defer_threshold=350.0,
                             carbon_period=600.0, carbon_swing=0.5)
        cfg = T.SimConfig(n_servers=16, n_cores=2, max_jobs=256,
                          sched_policy=T.SchedPolicy.CARBON_AWARE,
                          max_events=60_000, thermal=th, trace=traced)
        rng = np.random.default_rng(13)
        arr = workload.poisson_arrivals(40.0, 120, seed=9)
        specs = [jobs_mod.dag_single(rng.exponential(0.02),
                                     defer_slack=300.0) for _ in range(120)]
        return cfg, arr, specs, None, None
    raise ValueError(f"unknown sharding scenario {name!r}")


def graph_ops(fn) -> dict:
    """The device operations of one call of ``fn``, exactly: the call
    captured in a CUDA graph (after three eager calls) and the graph's
    nodes read through the driver API.  Returns {operation: count}:
    kernels by their (mangled) name, copies and fills as "memcpy" and
    "memset"; nodes that do no device work (empty, event) are left out."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUDA driver error {rc}")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    h = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(h, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
            params = (ctypes.c_uint64 * 16)()
            check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                   params),
                  "cuGraphKernelNodeGetParams_v2")
            name = ctypes.c_char_p()
            if params[0]:
                rc = cu.cuFuncGetName(ctypes.byref(name),
                                      ctypes.c_void_p(params[0]))
            else:
                rc = cu.cuKernelGetName(ctypes.byref(name),
                                        ctypes.c_void_p(params[7]))
            key = name.value.decode()[:60] if rc == 0 and name.value \
                else "kernel"
        elif kind.value in (1, 2):
            key = ("memcpy", "memset")[kind.value - 1]
        else:
            continue
        out[key] = out.get(key, 0) + 1
    del g
    return out


# --------------------------------------------------------------------------
# the MoE route-flip rule: two devices sum the router product in other
# orders, so a token whose top-k logits hold a near-tie may route to
# another expert on each (its row then differs by O(1)); a differing route
# is accepted only where the CPU's gap is under ROUTE_GAP
# --------------------------------------------------------------------------

ROUTE_GAP = 1e-5       # absolute, on float32 router logits of O(1)


def route_gaps(p, x, k) -> torch.Tensor:
    """(B, S): the smallest gap between neighbours among each token's k+1
    largest router logits (an order flip inside the top k or a swap of the
    k-th and (k+1)-th expert needs one of them to be a near-tie)."""
    top = torch.topk(x.float() @ p["router"].float(), k + 1, dim=-1).values
    return (top[..., :-1] - top[..., 1:]).min(dim=-1).values


@contextlib.contextmanager
def recorded_routes(moe_mod):
    """While inside, every ``moe_mod.route`` call (one per MoE layer of a
    forward) appends (topi, gaps) as CPU tensors to the yielded list."""
    calls, orig = [], moe_mod.route

    def route(p, x, cfg):
        out = orig(p, x, cfg)
        calls.append((out[0].cpu(), route_gaps(p, x, cfg.top_k).cpu()))
        return out

    moe_mod.route = route
    try:
        yield calls
    finally:
        moe_mod.route = orig


def route_flips(got, exp, bound=ROUTE_GAP) -> list:
    """Compare two runs' recorded routes call by call (``exp`` the CPU's).
    Returns the flips of the first call that has any, as (call, batch,
    token, CPU gap); later calls are not held, since their inputs already
    differ by the flip.  Raises AssertionError for a flip whose CPU gap is
    not under ``bound``, or for runs of a different number of calls."""
    if len(got) != len(exp):
        raise AssertionError(f"{len(got)} routed layers against {len(exp)}")
    for i, ((ti, _), (te, gap)) in enumerate(zip(got, exp)):
        diff = (ti != te).any(dim=-1).nonzero().tolist()
        if not diff:
            continue
        flips = [(i, b, s, float(gap[b, s])) for b, s in diff]
        wide = [f for f in flips if not f[3] < bound]
        if wide:
            raise AssertionError(
                f"routes differ at (call, batch, token, CPU gap) {wide}, "
                f"gaps not under {bound}: not a near-tie")
        return flips
    return []


def adamw_param_check(got, exp, prev, got_m, exp_m, got_v, exp_v, lr, c1,
                      c2, eps, carried):
    """One AdamW step's parameter leaf on two sides (``got`` against the
    reference ``exp``, float32): the difference may be 1e-5 relative to
    the larger of the element before (``prev``) and after the step, or lr
    (a zero-initialized element's first step is -lr u; a step may cancel
    an element to near zero), plus what the moments' own differences move
    the update lr m / (sqrt(v) + eps) by (c1, c2 the bias corrections),
    plus ``carried``, the difference before the step.  Returns (diff,
    elements beyond that bound, elements that needed the moments' part)."""
    diff = (got - exp).abs()
    strict = 1e-5 * torch.maximum(torch.maximum(exp.abs(), prev.abs()),
                                  torch.full_like(exp, lr))
    mh = exp_m / c1
    sv = torch.sqrt(exp_v / c2)
    dm = (got_m - exp_m).abs() / c1
    dv = (got_v - exp_v).abs() / c2
    du = (dm + mh.abs() / (sv + eps) * dv / (2 * sv + 1e-30)) / (sv + eps)
    base = strict + 1.01 * carried
    bad = int((diff > base + 2 * lr * du).sum())
    return diff, bad, int((diff > base).sum())
