"""Rack-sharded execution of the event engine over ``torch.distributed``,
port of ``repro.core.shard_sim``.

``SimState``'s per-server axes are stored rack-major (server ``i`` lives
in rack ``i // rack_size``), so a contiguous block partition along the
server axis cuts exactly on rack boundaries: rank ``j`` of a K-rank
"racks" axis holds servers ``[j N/K, (j + 1) N/K)`` of the farm and of the
thermal state (and racks ``[j R/K, (j + 1) R/K)`` of the per-rack
arrays) at rest.  The program is SPMD, one process a shard, as under
``torchrun``: every rank calls :func:`run_sharded` with the same full
initial state and keeps its rack block.

A macro-step splits into two phases:

  * **thin collective phase** -- at the top of each macro-step the rack
    blocks are gathered (one ``all_gather`` per sharded leaf along axis
    0, the only collectives of the run);
  * **collective-free event core** -- the unmodified ``engine._step``
    (the cheap-event chew included) runs on the gathered arrays, and the
    rank's block is sliced back out (a view, no communication).

Because the gathered arrays and the step's computation are identical to
the unsharded engine's, the sharded trajectory -- every state leaf, the
flight recorder's ring included -- is **bit-identical** to
``engine.run`` on one device, for any K.  Replicated state (jobs, flows,
net, sched, telemetry, the ring and every scalar) is updated identically
on every rank; the loop reads its flag from each rank's own replicated
``done`` and ``events``, with no collective, so every rank stops on the
same macro-step.  A last gather assembles the final state, so every rank
returns the whole of it.

Launch K ranks with ``torchrun --nproc-per-node K`` or
``torch.multiprocessing.spawn``, initialise the default process group
(gloo on the CPU, NCCL with one card a rank), then call
``farm.simulate`` with ``partition.n_shards=K`` or a mesh from
:func:`make_mesh`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..sharding import partition as mesh_lib
from . import engine
from . import trace as trace_mod
from .types import (SimConfig, replace, resolve_device, tree_leaves,
                    tree_map)

__all__ = ["all_gather", "make_mesh", "n_sharded_leaves", "run_sharded",
           "sharded_step_jaxpr", "validate_sharding"]


def make_mesh(n_shards: int, axis: str = mesh_lib.SIM_AXIS, device=None):
    """A 1-D ``DeviceMesh`` named ``axis`` over the first ``n_shards``
    ranks of the default process group, which the caller has initialised
    (every rank of the group calls this; ranks beyond ``n_shards`` are not
    in the mesh).  ``device``: ``None`` (CUDA) or ``"cpu"``."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n_shards:
        raise ValueError(
            f"partition.n_shards={n_shards} but the default process group "
            f"has {world} rank(s); launch {n_shards} processes (torchrun "
            f"--nproc-per-node {n_shards}, or torch.multiprocessing.spawn) "
            f"and call torch.distributed.init_process_group in each "
            f"(gloo on the CPU, nccl with one card a rank) first")
    return DeviceMesh(resolve_device(device).type, torch.arange(n_shards),
                      mesh_dim_names=(axis,))


def validate_sharding(cfg: SimConfig, n_shards: int, state=None) -> None:
    """Fail fast on layouts the block partition cannot cut on rack
    boundaries, and on a replica batch (a sharded run is one farm)."""
    if cfg.n_servers % n_shards:
        raise ValueError(
            f"n_servers={cfg.n_servers} is not divisible by "
            f"n_shards={n_shards}; pad the farm first (farm.pad_to_racks)")
    if state is not None and state.t.dim() != 0:
        raise ValueError(
            f"run_sharded runs one farm, got a replica batch (t of shape "
            f"{tuple(state.t.shape)}); shard a batch over replicas with "
            f"montecarlo.run_replicas(mesh=)")
    if cfg.thermal.enabled and state is not None:
        if state.thermal.rack_onehot.numel():
            raise ValueError(
                "sharded runs need a contiguous equal-size rack grouping "
                "(the i // rack_size default or a block topology); this "
                "state uses the general grouping")
        R = int(state.thermal.t_set.shape[0])
        if R % n_shards:
            raise ValueError(
                f"{R} racks do not split over {n_shards} shards; pad the "
                f"farm to a rack multiple of n_shards (farm.pad_to_racks)")


def all_gather(x: torch.Tensor, group, k: int) -> torch.Tensor:
    """``x`` of every rank of ``group`` (k ranks) concatenated along axis
    0, in rank order: one collective."""
    x = x.contiguous()
    out = x.new_empty((k * x.shape[0],) + tuple(x.shape[1:]))
    single = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    single(out, x, group=group)
    return out


def _gather_leaves(local, sharded, group, k):
    """Every rack-sharded leaf back to its full (N, ...) shape -- the
    macro-step's whole collective phase."""
    return tree_map(lambda x, s: all_gather(x, group, k) if s else x,
                    local, sharded)


def _slice_leaves(full, sharded, idx, k):
    """This rank's rack block of every sharded leaf (a view, no
    communication)."""
    def block(x, s):
        if not s:
            return x
        n = x.shape[0] // k
        return x[idx * n:(idx + 1) * n]
    return tree_map(block, full, sharded)


def _axis_of(mesh, axis: str):
    """(the mesh's process group along ``axis``, its size, this rank's
    index on it); raises on a rank outside the mesh."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes "
                         f"{mesh.mesh_dim_names})")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh}")
    return (mesh.get_group(axis), mesh_lib.mesh_sizes(mesh)[axis],
            mesh.get_local_rank(axis))


def _sharded_flags(state, cfg: SimConfig, mesh, axis: str):
    """A tree of ``state``'s layout holding True at the leaves the rack
    partition shards."""
    specs = iter(mesh_lib.sim_state_specs(state, cfg, mesh, axis))
    return tree_map(lambda _: next(specs)[:1] == (axis,), state)


def run_sharded(state, cfg: SimConfig, tc=None, mesh=None):
    """Run to completion like ``engine.run``, with the rack-major state
    axes sharded over ``mesh``'s ``cfg.partition.axis`` (a mesh built by
    :func:`make_mesh` from ``cfg.partition`` when None).  Every rank
    passes the same full initial state and gets the full final state;
    bit-identical to the single-device engine by construction.  The
    flight recorder's ring is copied once, as ``engine.run`` does, so
    ``state`` is left as it was."""
    axis = cfg.partition.axis
    if mesh is None:
        mesh = make_mesh(cfg.partition.n_shards, axis, state.t.device)
    group, k, idx = _axis_of(mesh, axis)
    validate_sharding(cfg, k, state)
    engine.check_scope(cfg)
    if tc is None:
        tc = engine.consts(cfg, state.t.device)
    engine._check_consts(cfg, tc)
    sharded = _sharded_flags(state, cfg, mesh, axis)
    if cfg.trace.enabled:
        state = replace(state, trace=trace_mod.own(state.trace, cfg))
    local = _slice_leaves(state, sharded, idx, k)
    while True:
        full = _gather_leaves(local, sharded, group, k)
        # replicated scalars: every rank reads the same flag
        if not bool(~full.done & (full.events < cfg.max_events)):
            return full
        local = _slice_leaves(engine._step(full, cfg, tc), sharded, idx, k)


# ==========================================================================
# shard-efficiency introspection
# ==========================================================================

def sharded_step_jaxpr(state, cfg: SimConfig, tc=None, mesh=None):
    """The reference's jaxpr of one shard-mapped macro-step has no
    counterpart until the port's graph audit."""
    raise NotImplementedError(
        "repro_torch has no captured graph of the sharded macro-step yet: "
        "it comes with ROADMAP.md Queue 1 item 11 (the graph audit)")


def n_sharded_leaves(state, cfg: SimConfig, mesh=None) -> int:
    """How many state leaves the rack partition shards: the number of
    ``all_gather`` calls a macro-step issues."""
    axis = cfg.partition.axis
    if mesh is None:
        mesh = make_mesh(cfg.partition.n_shards, axis, state.t.device)
    return sum(s for _, s in tree_leaves(_sharded_flags(state, cfg, mesh,
                                                          axis)))
