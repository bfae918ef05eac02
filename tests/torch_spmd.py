"""SPMD helpers of the port's tests and chip_smoke.py: a counter of the
collectives a rank calls, and the functions the tests' ranks run
(spawned with ``repro_torch.core.shard_sim.spawn``: K processes, one
``torch.distributed`` rank each, over a ``file://`` store; ``fn`` must be
importable by module path, and a failure in any rank raises
``torch.multiprocessing.ProcessRaisedException`` in the caller,
uncaught).  Imports neither JAX nor pytest, so it loads on a machine with
a card and PyTorch alone.
"""
from __future__ import annotations

import collections
import contextlib
import sys

import torch
import torch.distributed as dist

# every collective and point-to-point call of torch.distributed that a
# program could issue
COLLECTIVES = ("all_gather_single", "all_gather_into_tensor", "all_gather",
               "all_gather_object", "all_reduce", "all_to_all",
               "all_to_all_single", "barrier", "broadcast",
               "broadcast_object_list", "gather", "irecv", "isend", "recv",
               "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
               "send")
GATHERS = ("all_gather_single", "all_gather_into_tensor", "all_gather")


@contextlib.contextmanager
def count_collectives():
    """Count every ``torch.distributed`` collective called by name inside
    the block: yields a ``Counter`` {name: calls}.  The port calls them
    through the module's attributes, so patching the attributes sees
    every call."""
    counts = collections.Counter()
    saved = {}
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        setattr(dist, name, wrapped)
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


# --------------------------------------------------------------------------
# the CPU tests' ranks (tests/test_torch_sharding.py, test_torch_engine.py)
# --------------------------------------------------------------------------

def shard_initial(name, device="cpu"):
    """(cfg, state, tc) of a pinned sharding scenario
    (torch_kernel_inputs.shard_scenario) in the port, as the reference's
    test builds it: tau written to every server after ``init_state``."""
    import numpy as np
    from repro_torch.core import engine, jobs, topology, types
    from torch_kernel_inputs import shard_scenario
    cfg, arr, specs, topo, tau = shard_scenario(name, jobs, topology, types)
    jt = jobs.build_jobs(cfg, np.asarray(arr), specs, device=device)
    state, tc = engine.init_state(cfg, jt, topo)
    if tau is not None:
        state.farm.srv_tau = torch.full_like(state.farm.srv_tau, tau)
    return cfg, state, tc


def sharded_runs(rank, world, names, device="cpu"):
    """Each named scenario through ``run_sharded`` on a ``world``-rank
    mesh on ``device``: {name: (final state, {collective: calls}, sharded
    leaves)}."""
    from repro_torch.core import shard_sim
    mesh = shard_sim.make_mesh(world, device=device)
    out = {}
    for name in names:
        cfg, state, tc = shard_initial(name, device)
        n = shard_sim.n_sharded_leaves(state, cfg, mesh)
        with count_collectives() as calls:
            final = shard_sim.run_sharded(state, cfg, tc, mesh)
        out[name] = (final, dict(calls), n)
    return out


def simulate_runs(rank, world, cases):
    """``farm.simulate`` of each (cfg, arrivals, specs, keyword arguments)
    on the CPU twice: with ``partition.n_shards = world`` and no mesh, and
    with a mesh from ``make_mesh``; [(result, result)]."""
    import dataclasses
    from repro_torch.core import farm, shard_sim
    mesh = shard_sim.make_mesh(world, device="cpu")
    out = []
    for cfg, arr, specs, kw in cases:
        by_cfg = dataclasses.replace(cfg, partition=dataclasses.replace(
            cfg.partition, n_shards=world))
        out.append((farm.simulate(by_cfg, arr, specs, device="cpu", **kw),
                    farm.simulate(cfg, arr, specs, device="cpu", mesh=mesh,
                                  **kw)))
    return out


def replica_runs(rank, world, cfg, arrs, specs, mesh_shape, axes):
    """``run_replicas`` of one batch on a CPU mesh of ``mesh_shape`` named
    ``axes``: the final batch."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import montecarlo
    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=axes)
    sb, tc = montecarlo.batched_state(cfg, arrs, specs, device="cpu")
    return montecarlo.run_replicas(cfg, sb, tc, mesh=mesh)


def plan(rank, world, steps):
    """Several of the functions above in one spawn, so each rank imports
    torch once: ``steps`` is [(function name, extra args)].  Returns their
    results in order, and the JAX or ``repro`` modules the rank had
    imported by then (none: the port stands alone)."""
    results = [globals()[fn](rank, world, *args) for fn, args in steps]
    return results, sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "repro"))
