"""The audited configuration matrix: the steps the port really runs, port
of ``repro.analysis.matrix`` (the same case names and configurations,
built through the port).

Each case records one macro-step (``engine._step``): for a (SchedPolicy x
thermal x trace) configuration, on a float64 clock for the ``f64_`` twins,
for a replica batch at R = 4 (``montecarlo_vmap``, named as the
reference's vmapped step so the two line up), or the sharded macro-step
(``shard_sim.sharded_step_graph``: the gathers, the step and the slice
back) on 1, 2 or 8 ranks (``sharded_d1`` in this process; the others on
spawned gloo ranks, ``sharded_d8`` only when asked for).  A case carries
what the rules need: a fresh-state factory and the step for the engine
cases, each rank's inventory and clock report for the sharded ones, the
sharded-leaf count and the static feature flags.

Cases are made lazily: :func:`build_case` makes one on demand, on ``device``
(``None``: the card, ``"cpu"``: the CPU).
"""
from __future__ import annotations

import dataclasses
import tempfile
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class AuditCase:
    """One recorded program and the facts the rules consume."""

    name: str
    cfg: object
    kind: str                       # engine | vmap | sharded
    thermal_on: bool
    trace_on: bool
    time_dtype: object
    fresh: Optional[Callable] = None    # () -> a state the step may write
    step: Optional[Callable] = None     # state -> state, one macro-step
    n_sharded: Optional[int] = None     # sharded: expected all_gathers
    ranks: list = dataclasses.field(default_factory=list)
                                        # sharded: [(Inventory, ClockReport)]


def _small(n_servers=8, **kw):
    from ..core.types import SimConfig

    base = dict(n_servers=n_servers, n_cores=2, max_jobs=64,
                max_events=20_000)
    base.update(kw)
    return SimConfig(**base)


def _workload(n_jobs=20, lam=40.0, seed=3, defer_slack=None):
    from ..core import workload
    from ..core.jobs import dag_single

    rng = np.random.default_rng(seed)
    arr = workload.poisson_arrivals(lam, n_jobs, seed=seed)
    kw = {} if defer_slack is None else {"defer_slack": defer_slack}
    specs = [dag_single(rng.exponential(0.02), **kw) for _ in range(n_jobs)]
    return arr, specs


def _thermal(**kw):
    from ..core.types import ThermalConfig

    base = dict(enabled=True, r_th=0.5, tau_th=2.0, t_inlet=22.0,
                recirc=0.2, rack_size=2)
    base.update(kw)
    return ThermalConfig(**base)


# --------------------------------------------------------------------------
# config factories: (cfg, topo, workload kwargs)
# --------------------------------------------------------------------------

def _cfg_round_robin():
    from ..core.types import SchedPolicy, SleepPolicy

    return _small(sched_policy=SchedPolicy.ROUND_ROBIN,
                  sleep_policy=SleepPolicy.ALWAYS_ON), None, {}


def _cfg_load_balance():
    from ..core.types import SchedPolicy, SleepPolicy

    return _small(sched_policy=SchedPolicy.LOAD_BALANCE,
                  sleep_policy=SleepPolicy.SINGLE_TIMER), None, {}


def _cfg_network_aware():
    from ..core import topology
    from ..core.types import SchedPolicy

    cfg = _small(sched_policy=SchedPolicy.NETWORK_AWARE, max_jobs=32,
                 tasks_per_job=2, max_children=2, max_flows=64,
                 local_q=32, has_network=True, comm_model=0)
    return cfg, topology.star(8, link_cap=1.0e8), {"chains": True}


def _cfg_provisioned():
    from ..core.types import SchedPolicy

    return _small(sched_policy=SchedPolicy.PROVISIONED), None, {}


def _cfg_wasp():
    from ..core.types import SchedPolicy, SleepPolicy

    return _small(sched_policy=SchedPolicy.WASP_POOLS,
                  sleep_policy=SleepPolicy.WASP), None, {}


def _cfg_thermal_aware():
    from ..core.types import SchedPolicy

    return _small(sched_policy=SchedPolicy.THERMAL_AWARE,
                  thermal=_thermal()), None, {}


def _cfg_carbon_aware():
    from ..core.types import SchedPolicy

    tcfg = _thermal(defer_threshold=350.0, carbon_period=600.0,
                    carbon_swing=0.5)
    return (_small(sched_policy=SchedPolicy.CARBON_AWARE, thermal=tcfg),
            None, {"defer_slack": 300.0})


def _cfg_thermal_tracking():
    from ..core.types import SchedPolicy

    return _small(sched_policy=SchedPolicy.LOAD_BALANCE,
                  thermal=_thermal()), None, {}


def _cfg_thermal_throttling():
    from ..core.types import SchedPolicy

    tcfg = _thermal(t_throttle=50.0, t_release=45.0, throttle_freq=0.5,
                    throttle_power_scale=0.6)
    return _small(sched_policy=SchedPolicy.LOAD_BALANCE,
                  thermal=tcfg), None, {}


def _cfg_trace_on():
    from ..core.types import SchedPolicy, TraceConfig

    return _small(sched_policy=SchedPolicy.LOAD_BALANCE,
                  trace=TraceConfig(enabled=True)), None, {}


def _cfg_f64(make):
    def build():
        cfg, topo, wkw = make()
        return dataclasses.replace(cfg, time_dtype=torch.float64), topo, wkw

    return build


ENGINE_CONFIGS = {
    "policy_round_robin": _cfg_round_robin,
    "policy_load_balance": _cfg_load_balance,
    "policy_network_aware": _cfg_network_aware,
    "policy_provisioned": _cfg_provisioned,
    "policy_wasp": _cfg_wasp,
    "policy_thermal_aware": _cfg_thermal_aware,
    "policy_carbon_aware": _cfg_carbon_aware,
    "thermal_tracking": _cfg_thermal_tracking,
    "thermal_throttling": _cfg_thermal_throttling,
    "trace_on": _cfg_trace_on,
}

F64_CONFIGS = {
    "f64_load_balance": _cfg_f64(_cfg_load_balance),
    "f64_thermal_throttling": _cfg_f64(_cfg_thermal_throttling),
}


def _built_state(cfg, topo, wkw, device):
    """(state, tc) of a case's workload on ``device``."""
    from ..core import engine, jobs as jobs_mod, workload

    if wkw.get("chains"):
        rng = np.random.default_rng(2)
        arr = workload.poisson_arrivals(25.0, 16, seed=2)
        specs = [jobs_mod.dag_chain(rng.uniform(0.01, 0.04, size=2),
                                    edge_bytes=float(rng.uniform(4e6, 8e6)))
                 for _ in range(16)]
    else:
        arr, specs = _workload(**{k: v for k, v in wkw.items()
                                  if k != "chains"})
    jt = jobs_mod.build_jobs(cfg, np.asarray(arr), specs, device=device)
    return engine.init_state(cfg, jt, topo)


def _fresh(state, cfg):
    """A factory of copies of ``state`` whose ring the step may write."""
    from ..core import trace
    from ..core.types import replace

    def fresh():
        if not cfg.trace.enabled:
            return state
        return replace(state, trace=trace.own(state.trace, cfg))
    return fresh


def _engine_case(name, make, device) -> AuditCase:
    from ..core import engine

    cfg, topo, wkw = make()
    state, tc = _built_state(cfg, topo, wkw, device)
    return AuditCase(
        name=name, cfg=cfg, kind="engine", thermal_on=cfg.thermal.enabled,
        trace_on=cfg.trace.enabled, time_dtype=cfg.time_dtype,
        fresh=_fresh(state, cfg),
        step=lambda s: engine._step(s, cfg, tc))


def _montecarlo_case(device) -> AuditCase:
    """The port's batched step at R = 4, every replica running (as
    ``engine.run`` passes ``active``)."""
    from ..core import engine, montecarlo, workload
    from ..core.jobs import dag_single

    cfg = _small(max_events=5_000)
    R = 4
    arrs = np.stack([workload.poisson_arrivals(40.0, 12, seed=s)
                     for s in range(R)])
    specs = [dag_single(0.02) for _ in range(12)]
    state_b, tc = montecarlo.batched_state(cfg, arrs, specs, device=device)
    active = torch.ones((R,), dtype=torch.bool, device=state_b.t.device)
    return AuditCase(
        name="montecarlo_vmap", cfg=cfg, kind="vmap", thermal_on=False,
        trace_on=False, time_dtype=cfg.time_dtype,
        fresh=_fresh(state_b, cfg),
        step=lambda s: engine._step(s, cfg, tc, active))


def _sharded_cfg(n_ranks: int):
    from ..core.types import PartitionConfig, TraceConfig

    return _small(n_servers=16, max_jobs=32, max_events=1_000,
                  thermal=_thermal(), trace=TraceConfig(enabled=True),
                  partition=PartitionConfig(n_shards=n_ranks))


def sharded_rank(rank: int, world: int, device: str = "cpu") -> tuple:
    """On one rank of a ``world``-rank default process group: the
    sharded macro-step's (Inventory without its result, ClockReport,
    sharded leaves), recorded as ``shard_sim.sharded_step_graph`` records
    it.  Every rank of the group calls it."""
    from ..core import engine, jobs as jobs_mod, shard_sim
    from . import graph_audit

    cfg = _sharded_cfg(world)
    arr, specs = _workload(n_jobs=5)
    jt = jobs_mod.build_jobs(cfg, np.asarray(arr), specs, device=device)
    state, tc = engine.init_state(cfg, jt)
    mesh = shard_sim.make_mesh(world, device=device)
    step, local = shard_sim.macro_step(state, cfg, tc, mesh)
    inv, clock = graph_audit.audit(step, local, cfg.time_dtype)
    n = shard_sim.n_sharded_leaves(state, cfg, mesh)
    return dataclasses.replace(inv, result=None), clock, n


def _sharded_case(n_ranks: int, device) -> AuditCase:
    """``sharded_d1`` in this process (in the default process group when
    there is one, else a one-rank group of its own); wider on spawned
    gloo ranks over the CPU."""
    import torch.distributed as dist

    from ..core import shard_sim

    if n_ranks == 1:
        dev = "cpu" if device == "cpu" else None
        if dist.is_initialized():
            ranks = [sharded_rank(0, 1, dev)]
        else:
            backend = "gloo" if device == "cpu" else "nccl"
            with tempfile.TemporaryDirectory() as tmp:
                kw = {} if device == "cpu" else {
                    "device_id": torch.device("cuda",
                                              torch.cuda.current_device())}
                dist.init_process_group(
                    backend, init_method=f"file://{tmp}/store", rank=0,
                    world_size=1, **kw)
                try:
                    ranks = [sharded_rank(0, 1, dev)]
                finally:
                    dist.destroy_process_group()
    else:
        ranks = shard_sim.spawn(sharded_rank, n_ranks, ("cpu",))
    cfg = _sharded_cfg(n_ranks)
    return AuditCase(
        name=f"sharded_d{n_ranks}", cfg=cfg, kind="sharded", thermal_on=True,
        trace_on=True, time_dtype=cfg.time_dtype, n_sharded=ranks[0][2],
        ranks=[(inv, clock) for inv, clock, _ in ranks])


def case_names(include_d8: bool = False) -> list:
    """All case names in build order; ``sharded_d8`` (eight spawned ranks)
    only when asked for."""
    names = list(ENGINE_CONFIGS) + ["montecarlo_vmap", "sharded_d1",
                                    "sharded_d2"]
    if include_d8:
        names.append("sharded_d8")
    return names + list(F64_CONFIGS)


SINGLE_DEVICE = [n for n in case_names() if not n.startswith("sharded_")]


def build_case(name: str, device=None) -> AuditCase:
    """The case ``name`` on ``device`` (``None``: the card; the spawned
    sharded ranks run on the CPU)."""
    if name in ENGINE_CONFIGS:
        return _engine_case(name, ENGINE_CONFIGS[name], device)
    if name in F64_CONFIGS:
        return _engine_case(name, F64_CONFIGS[name], device)
    if name == "montecarlo_vmap":
        return _montecarlo_case(device)
    if name.startswith("sharded_d"):
        return _sharded_case(int(name[len("sharded_d"):]), device)
    raise KeyError(f"unknown audit case '{name}'")


def state_footprint_cases() -> dict:
    """Configs for the HBM-budget table, including the 65,536-server farm
    (sized on fake tensors: nothing is allocated)."""
    from ..core.types import ThermalConfig, TraceConfig

    return {
        "farm_8": _small(),
        "farm_1024": _small(n_servers=1024, max_jobs=4096),
        "farm_65536": _small(
            n_servers=65536, n_cores=2, max_jobs=65536,
            thermal=ThermalConfig(enabled=True, rack_size=32),
            trace=TraceConfig(enabled=True)),
    }


def footprint_of(cfg) -> dict:
    """The state footprint of ``cfg``'s initial state, built on fake
    tensors over the meta device (no storage)."""
    from ..core import engine, jobs as jobs_mod
    from ..core.jobs import dag_single
    from . import costmodel

    def init():
        jt = jobs_mod.build_jobs(cfg, np.zeros(1), [dag_single(0.01)],
                                 device="cpu")
        state, _ = engine.init_state(cfg, jt)
        return state

    return costmodel.state_footprint(init)


__all__ = ["AuditCase", "ENGINE_CONFIGS", "F64_CONFIGS", "SINGLE_DEVICE",
           "case_names", "build_case", "sharded_rank",
           "state_footprint_cases", "footprint_of"]
