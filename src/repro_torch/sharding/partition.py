"""Logical-axis sharding rules for the simulator's state, port of the
simulator part of ``repro.sharding.partition``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (or any object
with its ``mesh_dim_names`` and ``shape``): the axis names and their
sizes are all the rules read.  A spec is a plain tuple with one entry per
leading dim, each ``None`` (replicated), a mesh axis name or a tuple of
names, trailing ``None``s dropped: the port's stand-in for the
reference's ``PartitionSpec``, so ``()`` is replicated and ``("racks",)``
splits axis 0 over "racks".

The simulator's state has exactly two shardable logical axes: "server"
(the rack-major per-server axis of ``ServerFarm`` and ``ThermalState``)
and "rack" (the per-rack CRAC arrays).  Both map onto the same mesh axis,
a contiguous block of whole racks per rank, so rack row-reductions never
straddle a shard boundary.  Everything else (job, flow and switch tables,
telemetry windows, the trace ring, scalars) is replicated.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

from ..core.types import tree_leaves

SIM_AXIS = "racks"

# ThermalState fields that carry the per-server / per-rack axes.  The
# remaining thermal fields (scalar integrals, ctrl_next) are replicated,
# as is rack_onehot: it is only non-empty for non-contiguous rack
# groupings, which the sharded path refuses up front.
THERMAL_SERVER_FIELDS = frozenset(
    {"t_srv", "throttled", "rack_id", "t_peak", "throttle_seconds"})
THERMAL_RACK_FIELDS = frozenset({"t_set", "rack_inv"})


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _axes_size(sizes: Dict[str, int], axes: Sequence[str]) -> int:
    return math.prod(sizes[a] for a in axes)


def resolve_spec(logical: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                 mesh, rules: Dict[str, Any]) -> tuple:
    """The spec of one array from its per-dim logical names, with the
    reference's two rails: a dim whose size the assigned mesh axes do not
    divide is replicated instead, and a mesh axis shards at most one dim
    of an array (later dims fall back to replication)."""
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        axes = rules.get(name) if name else None
        if axes is None:
            out.append(None)
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if a in sizes)
        if not axes or any(a in used for a in axes) \
                or dim % _axes_size(sizes, axes) != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def sim_rules(axis: str = SIM_AXIS) -> Dict[str, Any]:
    return {"server": (axis,), "rack": (axis,)}


def sim_state_specs(state, cfg, mesh, axis: str = SIM_AXIS) -> tuple:
    """One spec a leaf of a ``SimState``, in ``types.tree_leaves`` order:
    the rack-major axes -> ``(axis,)``, all else ``()``.

    Uses the same ``resolve_spec`` rail as the reference's model
    shardings, so a farm the mesh does not divide degrades to
    replication; ``shard_sim.run_sharded`` validates divisibility up
    front and never reaches that fallback."""
    rules = sim_rules(axis)
    N = cfg.n_servers
    out = []
    for path, leaf in tree_leaves(state):
        names = path.split(".")
        top, name = names[0], names[-1]
        ax0 = None
        if leaf.dim() >= 1:
            if top == "farm" and leaf.shape[0] == N:
                ax0 = "server"
            elif top == "thermal" and cfg.thermal.enabled:
                if name in THERMAL_SERVER_FIELDS:
                    ax0 = "server"
                elif name in THERMAL_RACK_FIELDS:
                    ax0 = "rack"
        logical = (ax0,) + (None,) * (leaf.dim() - 1) if leaf.dim() else ()
        out.append(resolve_spec(logical, tuple(leaf.shape), mesh, rules))
    return tuple(out)


__all__ = ["SIM_AXIS", "THERMAL_SERVER_FIELDS", "THERMAL_RACK_FIELDS",
           "mesh_sizes", "resolve_spec", "sim_rules", "sim_state_specs"]
