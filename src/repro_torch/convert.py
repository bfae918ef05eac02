"""Carry configurations, states and model parameters across from the JAX
package's plain data, so both packages can start from the same point.

``config_from_dict`` rebuilds a port ``SimConfig`` from the reference's
``farm._config_dict(cfg)`` dump; ``state_from_numpy`` builds a port
``SimState`` from the reference ``SimState``'s leaves as numpy arrays,
keyed by field path (``"farm.core_busy_until"``; a leading ``"."`` as
``jax.tree_util.keystr`` writes it is accepted).  The flows, net, thermal
and trace subtrees come across too, so a mid-run network, thermal or
traced state steps in both packages (the engine copies a converted ring
into one with its sentinel row before it writes it, ``core/trace.py``).
The reference's (R, N) rack membership matrix becomes the port's (R, K)
member table (``core.types.ThermalState``).  A replica batch (the
reference's ``montecarlo.batched_state``, a leading R on every leaf)
comes across as a port batch, leaf for leaf.
``params_from_jax`` turns the reference's LM parameter tree (numpy
leaves, stacked over periods; an encoder's blocks stacked over
``enc_layers``) into the port's per-layer ``Params``.
Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .core import types as T

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_NESTED = {"server_power": T.ServerPowerProfile,
           "switch_power": T.SwitchPowerProfile,
           "telemetry": T.TelemetryConfig, "thermal": T.ThermalConfig,
           "trace": T.TraceConfig, "partition": T.PartitionConfig}


def _untuple(v):
    return tuple(_untuple(x) for x in v) if isinstance(v, list) else v


def config_from_dict(d: dict) -> T.SimConfig:
    """A port SimConfig from the reference's ``_config_dict`` dump."""
    kw = {}
    for f in dataclasses.fields(T.SimConfig):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NESTED:
            v = _NESTED[f.name](**{k: _untuple(x) for k, x in v.items()})
        elif f.name == "time_dtype":
            if v not in _DTYPES:
                raise ValueError(f"unsupported time_dtype {v!r}")
            v = _DTYPES[v]
        kw[f.name] = _untuple(v)
    unknown = set(d) - {f.name for f in dataclasses.fields(T.SimConfig)}
    if unknown:
        raise ValueError(f"unknown SimConfig fields: {sorted(unknown)}")
    return T.SimConfig(**kw)


def _tensor(x, device) -> torch.Tensor:
    # np.array, not np.ascontiguousarray: the latter turns a 0-d leaf
    # (the clock, counters) into shape (1,)
    a = np.array(x, order="C")
    if a.dtype == np.int64:
        a = a.astype(np.int32)       # the reference's int32 state
    return torch.from_numpy(a).to(device)


def _build(cls, prefix, tree, device):
    kw = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}.{f.name}" if prefix else f.name
        sub = {"farm": T.ServerFarm, "jobs": T.JobTable,
               "flows": T.FlowTable, "net": T.NetState,
               "sched": T.SchedState, "telem": T.Telemetry,
               "thermal": T.ThermalState, "trace": T.TraceState}.get(key)
        if sub is not None:
            kw[f.name] = _build(sub, key, tree, device)
        elif key == "thermal.rack_onehot" and key in tree:
            kw[f.name] = _rack_marker(tree[key], device)
        elif key in tree:
            kw[f.name] = _tensor(tree[key], device)
        else:
            raise KeyError(f"state leaf {key!r} missing from the tree")
    return cls(**kw)


def _rack_marker(onehot, device) -> torch.Tensor:
    """The port's ``rack_onehot`` for the reference's: (0, 0) (contiguous
    racks) and the (1, 1) placeholder of a disabled subsystem come across
    as they are; an (R, N) membership matrix becomes the port's (R, K)
    member table.  A replica batch's (n, ...) stack converts matrix by
    matrix."""
    onehot = np.asarray(onehot)
    if onehot.shape[-2:] in ((0, 0), (1, 1)):
        return _tensor(onehot, device)
    if onehot.ndim == 3:
        return torch.stack([_rack_marker(m, device) for m in onehot])
    from .core.thermal import member_table
    return torch.from_numpy(member_table(onehot.argmax(axis=0),
                                         onehot.shape[0])).to(device)


def state_from_numpy(tree: dict, cfg: T.SimConfig, device=None) -> T.SimState:
    """A port SimState from ``{field path: numpy array}`` on ``device`` (the
    default CUDA device, or the CPU when asked).  Time-typed leaves keep
    the dtype they come with, which is ``cfg.time_dtype`` for a reference
    state of the same configuration.  A batched tree (every leaf with a
    leading R, ``t`` of shape (R,)) gives a replica batch."""
    tree = {k.lstrip("."): v for k, v in tree.items()}
    state = _build(T.SimState, "", tree, T.resolve_device(device))
    if state.t.dtype != cfg.time_dtype:
        raise ValueError(f"state clock is {state.t.dtype}, config says "
                         f"{cfg.time_dtype}")
    return state


def _param_tensor(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor, bit for bit.  bfloat16 leaves arrive as
    ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses: they
    go through an int16 view."""
    a = np.array(x, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg, tree: dict, device=None):
    """The port's ``Params`` for ``cfg`` from the reference's parameter
    tree (``repro.models.transformer.make_params(...)[0]`` with numpy
    leaves): ``tree["layers"][j]`` holds pattern position j stacked over
    periods, so layer i is ``tree["layers"][i % period][i // period]``
    (with its ``ln_x`` and ``cross`` in an encoder-decoder);
    ``tree["enc"]["layers"]`` is one dict stacked over ``enc_layers``, so
    encoder layer i is its slice i.  ``dec_pos`` comes across whole.
    Every leaf keeps its bits."""
    from .models.transformer import Params, check_supported
    check_supported(cfg)
    dev = T.resolve_device(device)
    conv = functools.partial(_param_tensor, device=dev)
    port = {k: _map_tree(v, conv) for k, v in tree.items()
            if k not in ("layers", "enc")}
    if "enc" in tree:
        enc = tree["enc"]
        port["enc"] = {"final_norm": conv(enc["final_norm"]), "layers": [
            _map_tree(enc["layers"], lambda a, j=j: conv(a[j]))
            for j in range(cfg.enc_layers)]}
    stacks = tree["layers"]
    if len(stacks) != cfg.period:
        raise ValueError(f"{len(stacks)} stacked pattern positions, config "
                         f"has period {cfg.period}")
    port["layers"] = [
        _map_tree(stacks[i % cfg.period],
                  lambda a, j=i // cfg.period: conv(a[j]))
        for i in range(cfg.n_layers)]
    return Params(port)
