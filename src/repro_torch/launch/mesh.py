"""Meshes (port of ``repro.launch.mesh``) over the ranks of the
default process group, which the caller has initialised (``torchrun``,
or ``core.shard_sim.spawn``; gloo on the CPU, NCCL with one card a
rank).  Functions, never module constants, so importing this module
touches no process group.

The production mesh is the reference's 16 x 16 ("data", "model") pod, or
2 x 16 x 16 ("pod", "data", "model") over two pods: the batch is split
over ("pod", "data"), tensor and expert parallelism run over "model".
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.types import resolve_device

__all__ = ["local_shape", "make_local_mesh", "make_production_mesh"]


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def _device_type(device) -> str:
    """The mesh's device type: CUDA unless the caller asks for the CPU
    (``resolve_device``).  Over a fake process group (the dry run's,
    ``launch/dryrun.py``) a CUDA mesh needs no card."""
    if dist.get_backend() == "fake":
        return torch.device("cuda" if device is None else device).type
    return resolve_device(device).type


def _mesh(shape, axes, device):
    from torch.distributed.device_mesh import DeviceMesh
    n = _ranks()
    need = 1
    for s in shape:
        need *= s
    if n < need:
        raise ValueError(
            f"a {shape} mesh needs {need} ranks, the default process group "
            f"has {n}; launch them (torchrun --nproc-per-node {need}, or "
            f"core.shard_sim.spawn) and call "
            f"torch.distributed.init_process_group in each first")
    return DeviceMesh(_device_type(device),
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def local_shape(data: int, model: int, n: int) -> tuple:
    """The reference's clamp of a (data, model) request to ``n``
    devices."""
    data = min(data, n)
    model = max(1, min(model, n // data))
    return data, model


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A ("data", "model") mesh over the first ranks of the default
    process group, the request clamped to its size as the reference
    clamps it to the devices there are.  ``device``: ``None`` (CUDA) or
    ``"cpu"``."""
    n = _ranks()
    if n == 0:
        raise ValueError("make_local_mesh needs an initialised default "
                         "process group (one process a rank)")
    return _mesh(local_shape(data, model, n), ("data", "model"), device)
