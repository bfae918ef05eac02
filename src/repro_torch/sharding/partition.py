"""Logical-axis sharding rules (port of ``repro.sharding.partition``):
the model side (parameters, caches, batches) and the simulator's state.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (or any object
with its ``mesh_dim_names`` and ``shape``): the axis names and their
sizes are all the rules read.  A spec is a plain tuple with one entry per
leading dim, each ``None`` (replicated), a mesh axis name or a tuple of
names, trailing ``None``s dropped: the port's stand-in for the
reference's ``PartitionSpec``, so ``()`` is replicated and ``("racks",)``
splits axis 0 over "racks".  ``tree_shardings`` gives one ``Sharding``
record (mesh, spec) a leaf, the port's ``NamedSharding``;
``sharding/spmd.py`` cuts and gathers tensors by them.

Parameters and caches carry logical axis names per dim
(``models/transformer.py``'s ``param_specs``/``cache_specs``), resolved
against a mesh with the reference's two rails: a dim whose size the
assigned mesh axes do not divide is replicated instead, and one mesh axis
shards at most one dim of an array.  The default rules are the
reference's (tensor and expert parallelism over "model", FSDP and data
parallelism over the batch axes "pod" and "data"):

  vocab/heads/ff/expert/ssm -> model
  embed                     -> pod,data     (FSDP)
  batch                     -> pod,data     (data parallelism)
  kv_seq                    -> model        (decode KV cache sequence dim)

The simulator's state has exactly two shardable logical axes: "server"
(the rack-major per-server axis of ``ServerFarm`` and ``ThermalState``)
and "rack" (the per-rack CRAC arrays).  Both map onto the same mesh axis,
a contiguous block of whole racks per rank, so rack row-reductions never
straddle a shard boundary.  Everything else (job, flow and switch tables,
telemetry windows, the trace ring, scalars) is replicated.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

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


# --------------------------------------------------------------------------
# the model side: parameters, caches, batches
# --------------------------------------------------------------------------

class Sharding(NamedTuple):
    """One leaf's placement, the port's ``NamedSharding``: the mesh and
    the resolved spec."""
    mesh: Any
    spec: tuple


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def default_rules(mesh, *, fsdp: bool = True) -> Dict[str, Any]:
    bax = batch_axes(mesh)
    return {
        "vocab": ("model",),
        "heads": ("model",),
        "kv": None,                  # kv_dim: covered by embed-FSDP instead
        "kv_heads": None,
        "ff": ("model",),
        "expert": ("model",),
        "e_ff": None,                # expert hidden: see serve_rules
        "ssm": ("model",),
        "embed": bax if fsdp else None,
        "batch": bax,
        "kv_seq": ("model",),
        "seq": None,
    }


def serve_rules(mesh) -> Dict[str, Any]:
    """The reference's weights-stationary decode rules: no FSDP over the
    contraction dim; the experts' hidden dim over the batch axes
    instead."""
    r = default_rules(mesh, fsdp=False)
    r["e_ff"] = batch_axes(mesh)
    return r


def is_spec(x) -> bool:
    """A logical or resolved spec: a tuple of names, name tuples and
    Nones (``()`` included)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists whose leaves are
    specs (``is_spec``), with ``rest`` trees of the same layout."""
    if is_spec(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def tree_pspecs(specs, shapes, mesh, rules=None):
    """specs: nested dicts/lists of logical tuples; shapes: the same
    layout of tensors (or anything with ``.shape``).  Returns the same
    layout of resolved specs."""
    rules = rules or default_rules(mesh)
    return _tree_map(
        lambda sp, a: resolve_spec(sp, tuple(a.shape), mesh, rules),
        specs, shapes)


def tree_shardings(specs, shapes, mesh, rules=None):
    """``tree_pspecs`` with every resolved spec in a ``Sharding``."""
    return _tree_map(lambda p: Sharding(mesh, p),
                     tree_pspecs(specs, shapes, mesh, rules))


def batch_pspec(mesh, global_batch: Optional[int] = None) -> tuple:
    """Batch sharding over (pod, data); replicated when the batch is not
    divisible (the B=1 long-context decode shape, for one)."""
    bax = batch_axes(mesh)
    sizes = mesh_sizes(mesh)
    if global_batch is not None and global_batch % _axes_size(sizes, bax):
        return ()
    return (bax if len(bax) > 1 else bax[0],)


def sim_rules(axis: str = SIM_AXIS) -> Dict[str, Any]:
    return {"server": (axis,), "rack": (axis,)}


def sim_state_specs(state, cfg, mesh, axis: str = SIM_AXIS) -> tuple:
    """One spec a leaf of a ``SimState``, in ``types.tree_leaves`` order:
    the rack-major axes -> ``(axis,)``, all else ``()``.

    Uses the same ``resolve_spec`` rail as the reference's model
    shardings, so a farm the mesh does not divide degrades to
    replication; ``shard_sim.run_sharded`` validates divisibility up
    front and never reaches that fallback."""
    from ..core.types import tree_leaves     # core imports this module
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
           "Sharding", "batch_axes", "batch_pspec", "default_rules",
           "is_spec", "mesh_sizes", "resolve_spec", "serve_rules",
           "sim_rules", "sim_state_specs", "tree_pspecs", "tree_shardings"]
