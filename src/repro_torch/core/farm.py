"""High-level simulation entry point + result summarization, port of
``repro.core.farm``."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import engine, jobs as jobs_mod, shard_sim
from . import telemetry as telemetry_mod, traceio
from .types import INF, SimConfig, SimState, resolve_device


@dataclasses.dataclass
class RunInfo:
    """Run provenance: host wall clock and the exact config that produced
    the result."""
    wall_s: float                   # wall time of the engine run
    steps: int                      # macro-steps
    events: int                     # events retired
    events_per_s: float             # events / wall_s
    backend: str                    # device type the run executed on
    config: dict                    # recursive SimConfig dump
    # execution-mesh provenance: how the state was laid out, not part of
    # the scenario -- config_digest excludes it, so the same scenario run
    # on 1 or K ranks compares equal
    devices: int = 1                # ranks of the mesh the run executed on
    mesh_shape: tuple = ()          # e.g. (8,)
    mesh_axes: tuple = ()           # e.g. ("racks",)
    sharding: str = ""              # the server axis' spec, "P('racks',)"
    config_digest: str = ""         # sha1 over the device-count-free config
    device_name: str = ""           # e.g. torch.cuda.get_device_name()
    # simulate(profile=True): the first run's extra wall over a warm rerun
    # (kernel builds and loads, allocator warm-up); NaN otherwise
    jit_compile_s: float = float("nan")


def _config_dict(obj):
    """Recursive dataclass -> plain-JSON dump; a torch dtype dumps as its
    numpy name ("float32"), as the reference dumps jnp dtypes."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _config_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_config_dict(v) for v in obj]
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    if isinstance(obj, torch.dtype):
        return str(obj).removeprefix("torch.")
    try:
        return np.dtype(obj).name
    except TypeError:
        return str(obj)


def config_digest(cfg: SimConfig) -> str:
    """Stable sha1 of the scenario config, excluding the partition block;
    equal to the reference's digest of the same scenario."""
    d = _config_dict(cfg)
    d.pop("partition", None)
    return hashlib.sha1(
        json.dumps(d, sort_keys=True).encode()).hexdigest()


def pad_to_racks(cfg: SimConfig, n_shards: Optional[int] = None) -> SimConfig:
    """Round the farm up to whole racks (and to a rack count divisible by
    ``n_shards``) with inert filler rows (``n_present`` keeps the real
    count)."""
    K = max(n_shards if n_shards is not None else cfg.partition.n_shards, 1)
    rs = max(cfg.thermal.rack_size, 1) if cfg.thermal.enabled else 1
    block = rs * K
    real = cfg.present
    n = -(-real // block) * block
    kw = {}
    if n_shards is not None and n_shards != cfg.partition.n_shards:
        kw["partition"] = dataclasses.replace(cfg.partition,
                                              n_shards=n_shards)
    if n == cfg.n_servers and not kw:
        return cfg
    return dataclasses.replace(cfg, n_servers=n,
                               n_present=real if n > real else 0, **kw)


@dataclasses.dataclass
class SimResult:
    """Host-side summary of one simulation run."""
    sim_time: float
    events: int
    n_jobs: int
    n_finished: int
    mean_latency: float
    p50_latency: float
    p90_latency: float
    p95_latency: float
    p99_latency: float
    server_energy: float
    switch_energy: float
    energy_per_server: np.ndarray
    residency: np.ndarray
    wake_count: np.ndarray
    busy_core_seconds: float
    utilization: float
    dropped: int
    latencies: np.ndarray
    telemetry: Optional[telemetry_mod.TelemetrySummary] = None
    flows_dropped: int = 0
    cooling_energy: float = 0.0
    carbon_g: float = 0.0
    energy_cost: float = 0.0
    peak_temp: float = float("nan")
    mean_temp: float = float("nan")
    throttle_seconds: float = 0.0
    temps: Optional[np.ndarray] = None
    peak_temps: Optional[np.ndarray] = None
    setpoints: Optional[np.ndarray] = None
    deferred_jobs: int = 0
    deferred_seconds: float = 0.0
    carbon_g_avoided_est: float = 0.0
    trace_events: Optional[np.ndarray] = None
    trace_dropped: int = 0
    run_info: Optional[RunInfo] = None

    @property
    def mean_power(self) -> float:
        return (self.server_energy + self.switch_energy
                + self.cooling_energy) / max(self.sim_time, 1e-12)

    @property
    def total_energy(self) -> float:
        return self.server_energy + self.switch_energy + self.cooling_energy


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def summarize(state: SimState, cfg: SimConfig) -> SimResult:
    arr = _np(state.jobs.arrival)
    fin = _np(state.jobs.job_finish)
    ok = (fin < INF / 2) & (arr < INF / 2)
    lat = (fin - arr)[ok]
    t = float(state.t)
    # utilization is over real servers (padded rows own no usable cores)
    N, C = cfg.present, cfg.n_cores
    pct = (lambda q: float(np.percentile(lat, q))) if lat.size else \
        (lambda q: float("nan"))
    energy = _np(state.farm.energy)
    bcs = _np(state.farm.busy_core_seconds)
    thermal_kw = {}
    if cfg.thermal.enabled:
        th = state.thermal
        temps, peaks = _np(th.t_srv), _np(th.t_peak)
        thermal_kw = dict(
            cooling_energy=float(th.cool_energy),
            carbon_g=float(th.carbon_g),
            energy_cost=float(th.cost),
            peak_temp=float(peaks.max()),
            mean_temp=float(temps.mean()),
            throttle_seconds=float(_np(th.throttle_seconds).sum()),
            temps=temps, peak_temps=peaks, setpoints=_np(th.t_set),
            deferred_jobs=int(th.defer_count),
            deferred_seconds=float(th.defer_seconds),
            carbon_g_avoided_est=float(th.grams_avoided))
    trace_kw = {}
    if cfg.trace.enabled:
        ev, n_drop = traceio.decode(state.trace, cfg)
        trace_kw = dict(trace_events=ev, trace_dropped=n_drop)
    return SimResult(
        sim_time=t,
        events=int(state.events),
        n_jobs=int((arr < INF / 2).sum()),
        n_finished=int(ok.sum()),
        mean_latency=float(lat.mean()) if lat.size else float("nan"),
        p50_latency=pct(50), p90_latency=pct(90),
        p95_latency=pct(95), p99_latency=pct(99),
        server_energy=float(energy.sum()),
        switch_energy=float(_np(state.net.sw_energy).sum()),
        energy_per_server=energy,
        residency=_np(state.farm.residency),
        wake_count=_np(state.farm.wake_count),
        busy_core_seconds=float(bcs.sum()),
        utilization=float(bcs.sum() / max(N * C * t, 1e-12)),
        dropped=int(state.farm.dropped),
        latencies=lat,
        telemetry=(telemetry_mod.summarize(state, cfg)
                   if cfg.telemetry.enabled else None),
        flows_dropped=int(state.flows.flows_dropped),
        **thermal_kw,
        **trace_kw,
    )


def simulate(cfg: SimConfig, arrivals, specs, topo=None, tau=None,
             pools=None, racks=None, device=None,
             profile: bool = False, mesh=None) -> SimResult:
    """Build the job table, run the engine to completion, summarize.

    topo   -- a ``core.topology.Topology``; required when cfg.has_network
    tau    -- scalar or (N,) delay-timer values (seconds; INF = never sleep)
    pools  -- (N,) 0/1 pool assignment (dual-timer low/high, WASP)
    racks  -- (N,) rack ids for the thermal recirculation grouping (the
              topology's first-hop switches by default when ``topo`` is
              given, else i // thermal.rack_size)
    device -- ``None`` (the default CUDA device) or ``"cpu"``
    profile -- rerun the (now warm) engine once more from the same initial
              state and report the first run's extra wall clock as
              ``run_info.jit_compile_s``; ``wall_s`` is then the warm run's
    mesh   -- run rack-sharded on this ``DeviceMesh`` (core/shard_sim.py),
              every rank of it calling ``simulate`` alike;
              ``cfg.partition.n_shards > 1`` with mesh=None builds one
              over the default process group.  Results are bit-identical
              either way, and ``wall_s`` is the slowest rank's.
    """
    engine.check_scope(cfg)
    dev = resolve_device(device)
    jt = jobs_mod.build_jobs(cfg, np.asarray(arrivals), specs, device=dev)
    state, tc = engine.init_state(cfg, jt, topo, racks)
    if tau is not None:
        tau_arr = torch.as_tensor(np.broadcast_to(
            np.asarray(tau, np.float64), (cfg.n_servers,)).copy())
        state = dataclasses.replace(state, farm=dataclasses.replace(
            state.farm, srv_tau=tau_arr.to(device=dev,
                                           dtype=cfg.time_dtype)))
    if pools is not None:
        state = dataclasses.replace(state, farm=dataclasses.replace(
            state.farm, srv_pool=torch.as_tensor(
                np.asarray(pools)).to(device=dev, dtype=torch.int32)))

    sharded = mesh is not None or cfg.partition.sharded
    if sharded:
        if mesh is None:
            mesh = shard_sim.make_mesh(cfg.partition.n_shards,
                                       cfg.partition.axis, dev)
        group = mesh.get_group(cfg.partition.axis)

        def runner():
            return shard_sim.run_sharded(state, cfg, tc, mesh)
    else:
        def runner():
            return engine.run(state, cfg, tc)

    def settle():
        # the device, then every rank: the window is the slowest rank's
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if sharded:
            dist.barrier(group=group)

    def timed_run():
        settle()
        t0 = time.perf_counter()
        final = runner()
        settle()
        return final, time.perf_counter() - t0

    final, wall = timed_run()
    compile_s = float("nan")
    if profile:
        # engine.run leaves its input state as it was, so the rerun starts
        # from the same point
        final, warm = timed_run()
        compile_s = max(wall - warm, 0.0)
        wall = warm
    res = summarize(final, cfg)
    n_ev = int(final.events)
    mesh_shape, mesh_axes, sharding = (), (), ""
    if sharded:
        mesh_shape = tuple(int(s) for s in mesh.shape)
        mesh_axes = tuple(mesh.mesh_dim_names)
        sharding = f"P('{cfg.partition.axis}',)"
    res.run_info = RunInfo(
        wall_s=wall, steps=int(final.steps), events=n_ev,
        events_per_s=n_ev / max(wall, 1e-12), backend=dev.type,
        config=_config_dict(cfg), devices=math.prod(mesh_shape),
        mesh_shape=mesh_shape, mesh_axes=mesh_axes, sharding=sharding,
        config_digest=config_digest(cfg),
        jit_compile_s=compile_s,
        device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"))
    return res
