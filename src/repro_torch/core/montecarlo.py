"""Replica sweeps: R independent simulations as one batch, port of
``repro.core.montecarlo``.

The paper runs each configuration "100 times" (Fig 5), and a policy study
is a grid of independent cells (seeds, delay-timer values, thresholds).
The reference runs such a sweep as one ``jax.vmap`` of its engine over a
leading replica axis; here the engine's own functions take that axis
(``core/engine.py``): every state leaf gains a leading R, the run's
constants (``engine.EngineConsts``, the topology's arrays) are shared, and
each macro-step advances all R farms in the launches of one.  Each replica
stops on its own ``~done & (events < max_events)`` and keeps its state
from then on, as under vmap.  ``run_replicas(mesh=)`` splits the batch
over the ranks of a ``torch.distributed`` mesh, as the reference's
``shard_map`` over its replica axes does.

The fault-model helpers (``poisson_failure_times``, ``young_daly_interval``)
are plain numpy, copied from the reference.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import engine, jobs as jobs_mod, shard_sim, telemetry
from .types import INF, SimConfig, SimState, resolve_device, tree_map

__all__ = ["batched_state", "run_replicas", "replica_stats", "replica_state",
           "poisson_failure_times", "young_daly_interval"]


def batched_state(cfg: SimConfig, arrivals_b, specs, taus=None, topo=None,
                  device=None):
    """R replica states and the run's shared constants, (state_b, tc).

    arrivals_b (R, J) host arrival times, one row a replica, with the same
    job ``specs``; ``taus`` (R,) or (R, N) delay-timer values overwrite
    ``farm.srv_tau``; ``topo`` (a ``core.topology.Topology``) is required
    in network mode, and thermal racks come from it (else ``i //
    rack_size``) as in ``engine.init_state``.  ``device``:
    ``None`` (the default CUDA device) or ``"cpu"``."""
    if cfg.has_network and topo is None:
        raise ValueError(
            "cfg.has_network=True requires a topology: pass topo= to "
            "batched_state (replica sweeps never route a flow without one)")
    dev = resolve_device(device)
    arrivals_b = np.asarray(arrivals_b)
    R = arrivals_b.shape[0]
    tables = [jobs_mod.build_jobs(cfg, arrivals_b[i], specs, device=dev)
              for i in range(R)]
    state0, tc = engine.init_state(cfg, tables[0], topo)
    # the R job tables stacked; every other leaf repeated along R, a
    # contiguous copy each
    others = {f.name: tree_map(lambda x: x.expand((R,) + x.shape).clone(),
                               getattr(state0, f.name))
              for f in dataclasses.fields(state0) if f.name != "jobs"}
    state_b = SimState(jobs=tree_map(lambda *xs: torch.stack(xs), *tables),
                       **others)
    if taus is not None:
        t = torch.as_tensor(np.asarray(taus, np.float64)).to(
            device=dev, dtype=cfg.time_dtype)
        if t.dim() == 1:
            t = t[:, None]
        state_b.farm.srv_tau = t.expand(R, cfg.n_servers).contiguous()
    return state_b, tc


def run_replicas(cfg: SimConfig, state_b: SimState, tc=None, mesh=None):
    """Run every replica of ``state_b`` to completion (or
    ``cfg.max_events``) in one batched loop; returns the final batch.

    ``mesh`` (a ``DeviceMesh``; every rank of it calls this with the same
    batch) splits the R replicas over every mesh axis except the rack
    axis ``cfg.partition.axis``, in row-major order of those axes: each
    rank runs its R/k replicas, and along the rack axis each replica's
    farm stays whole, the ranks running the same block.  The ranks then
    gather the results along the replica axis, so every rank returns the
    whole batch.  R must divide by k.

    On the card a batch holds at most ``kernels.build.MAX_REPLICAS``
    (65,535) replicas a rank, the engine kernels' grid extent, and a
    larger one raises ``ValueError`` at its first macro-step: split such
    a sweep, or spread it over a mesh."""
    if state_b.t.dim() != 1:
        raise ValueError(f"run_replicas takes a replica batch (state leaves "
                         f"with a leading R), got t of shape "
                         f"{tuple(state_b.t.shape)}")
    if mesh is None:
        return engine.run(state_b, cfg, tc)
    names = [a for a in mesh.mesh_dim_names if a != cfg.partition.axis]
    sizes = [int(mesh.size(mesh.mesh_dim_names.index(a))) for a in names]
    k, R = math.prod(sizes), int(state_b.t.shape[0])
    if R % k:
        raise ValueError(f"{R} replicas do not split over the {k} ranks of "
                         f"the mesh axes {tuple(names)}")
    idx = 0
    for a, n in zip(names, sizes):
        idx = idx * n + mesh.get_local_rank(a)
    blk = R // k
    out = engine.run(tree_map(lambda x: x[idx * blk:(idx + 1) * blk],
                              state_b), cfg, tc)
    # innermost axis first: each gather joins blocks adjacent in idx
    for a, n in zip(reversed(names), reversed(sizes)):
        group = mesh.get_group(a)
        out = tree_map(lambda x: shard_sim.all_gather(x, group, n), out)
    return out


def replica_state(state_b: SimState, r: int) -> SimState:
    """Replica ``r`` of a batch as a single-run state (views of its rows),
    for ``farm.summarize``, ``traceio.decode`` of its ring or a solo
    continuation with ``engine.run`` (which copies the ring first)."""
    return tree_map(lambda x: x[r], state_b)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def replica_stats(state_b: SimState, cfg: SimConfig) -> dict:
    """Host-side per-replica summaries -> dict of numpy arrays (the
    reference's keys).

    Replicas that finish zero jobs get NaN latency stats without tripping
    numpy's all-NaN RuntimeWarnings.  Percentiles come from the device-side
    telemetry histograms (one (R, B) array off the device instead of the
    (R, J) job tables) when telemetry is enabled; otherwise from the exact
    per-job latencies."""
    arr = _np(state_b.jobs.arrival)                            # (R, J)
    fin = _np(state_b.jobs.job_finish)
    ok = (fin < INF / 2) & (arr < INF / 2)
    finished = ok.sum(axis=1)
    lat_sum = np.where(ok, fin - arr, 0.0).sum(axis=1)
    mean_lat = np.where(finished > 0,
                        lat_sum / np.maximum(finished, 1), np.nan)
    energy = _np(state_b.farm.energy).sum(axis=1)              # (R,)
    sw_energy = _np(state_b.net.sw_energy).sum(axis=1)
    cool = _np(state_b.thermal.cool_energy) if cfg.thermal.enabled else 0.0
    t = _np(state_b.t)

    tcfg = cfg.telemetry
    if tcfg.enabled:
        hist = _np(state_b.telem.job_hist)                     # (R, B)
        pct = {q: telemetry.hist_percentile(hist, tcfg.lat_lo, tcfg.lat_hi,
                                            q)
               for q in (50, 95, 99)}
    else:
        def _exact(q):
            return np.asarray([
                np.percentile((fin[r] - arr[r])[ok[r]], q)
                if finished[r] else np.nan
                for r in range(arr.shape[0])])
        pct = {q: _exact(q) for q in (50, 95, 99)}
    out = {
        "mean_latency": mean_lat,
        "p50_latency": pct[50],
        "p95_latency": pct[95],
        "p99_latency": pct[99],
        "energy": energy,
        "sim_time": t,
        # same definition as SimResult.mean_power: IT + switch + cooling
        "mean_power": (energy + sw_energy + cool) / np.maximum(t, 1e-12),
        "events": _np(state_b.events),
        "finished": finished,
        "flows_dropped": _np(state_b.flows.flows_dropped),
    }
    if cfg.trace.enabled:
        # per-replica flight-recorder health: records evicted by wrap
        out["trace_dropped"] = _np(state_b.trace.dropped)
    if cfg.thermal.enabled:
        th = state_b.thermal
        out.update({
            "cooling_energy": _np(th.cool_energy),              # (R,)
            "carbon_g": _np(th.carbon_g),
            "energy_cost": _np(th.cost),
            "peak_temp": _np(th.t_peak).max(axis=1),
            "throttle_seconds": _np(th.throttle_seconds).sum(axis=1),
            "deferred_jobs": _np(th.defer_count),               # (R,)
            "deferred_seconds": _np(th.defer_seconds),
            "carbon_g_avoided_est": _np(th.grams_avoided),
        })
    return out


def poisson_failure_times(mtbf: float, horizon: float, n_nodes: int,
                          seed: int = 0) -> np.ndarray:
    """Fleet-level failure arrivals for checkpoint-cadence studies: a node
    fleet with per-node MTBF produces failures at rate n/mtbf."""
    rng = np.random.default_rng(seed)
    rate = n_nodes / mtbf
    out, t = [], 0.0
    while t < horizon:
        t += rng.exponential(1.0 / rate)
        if t < horizon:
            out.append(t)
    return np.asarray(out)


def young_daly_interval(mtbf_fleet: float, ckpt_cost: float) -> float:
    """Optimal checkpoint interval sqrt(2·δ·MTBF) (Young/Daly)."""
    return float(np.sqrt(2.0 * ckpt_cost * mtbf_fleet))
