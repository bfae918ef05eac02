"""Wrapper of the fused farm-advance CUDA kernel (``csrc/dcsim_step.cu``).

Port of the Pallas TPU kernel ``repro.kernels.dcsim_step.dcsim_advance``
with its full signature (``throttled`` and ``throttle_power_scale``
included).  The plain version is ``ref.dcsim_advance_reference``; the
source note in the ``.cu`` file says what bounds the kernel on an H100 and
what its design does about it.  ``LAUNCHES`` counts the kernel's launches
(the farm-wide minimum pass is part of the same launch).
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

LAUNCHES = 0


def _check(x, name, shape, dtype):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x):
    return None if x is None else x.data_ptr()


def dcsim_advance(core_busy, srv_state, energy, busy_seconds, t, t_next,
                  state_power, p_core_active, p_core_idle,
                  srv_wake_at=None, srv_idle_since=None, srv_tau=None,
                  throttled=None, *, throttle_power_scale=1.0):
    """Fused farm advance on the card.  core_busy (N, C) f32; srv_state (N,)
    int32; energy/busy_seconds/srv_wake_at/srv_idle_since/srv_tau (N,) f32;
    t/t_next 0-d f32 tensors on the same card (read there, no host sync);
    state_power (6,) f32; throttled (N,) int32 or bool.

    Returns (new_core_busy (N, C) f32, done (N, C) bool, energy (N,),
    busy_seconds (N,), next_candidate () f32)."""
    global LAUNCHES
    N, C = core_busy.shape
    f32, i32 = torch.float32, torch.int32
    _check(core_busy, "core_busy", (N, C), f32)
    _check(srv_state, "srv_state", (N,), i32)
    _check(energy, "energy", (N,), f32)
    _check(busy_seconds, "busy_seconds", (N,), f32)
    _check(t, "t", (), f32)
    _check(t_next, "t_next", (), f32)
    _check(state_power, "state_power", (6,), f32)
    for x, name in ((srv_wake_at, "srv_wake_at"),
                    (srv_idle_since, "srv_idle_since"), (srv_tau, "srv_tau")):
        if x is not None:
            _check(x, name, (N,), f32)
    if throttled is not None:
        if throttled.dtype != i32:
            throttled = throttled.to(i32)
        _check(throttled, "throttled", (N,), i32)
    dev = core_busy.device
    for x in (srv_state, energy, busy_seconds, t, t_next, state_power,
              srv_wake_at, srv_idle_since, srv_tau, throttled):
        if x is not None and x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")

    lib = build.load("dcsim_step")
    threads = 256                       # DCSIM_THREADS in dcsim_step.cu
    n_blocks = (N + threads - 1) // threads
    new_busy = torch.empty((N, C), dtype=f32, device=dev)
    done = torch.empty((N, C), dtype=torch.bool, device=dev)
    new_energy = torch.empty((N,), dtype=f32, device=dev)
    new_bsec = torch.empty((N,), dtype=f32, device=dev)
    block_cand = torch.empty((n_blocks,), dtype=f32, device=dev)
    cand = torch.empty((), dtype=f32, device=dev)
    p_act = float(np.float32(p_core_active))
    p_thr = float(np.float32(p_core_active * throttle_power_scale))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dcsim_advance_launch(
            _ptr(core_busy), _ptr(srv_state), _ptr(energy),
            _ptr(busy_seconds), _ptr(srv_wake_at), _ptr(srv_idle_since),
            _ptr(srv_tau), _ptr(throttled), _ptr(state_power), _ptr(t),
            _ptr(t_next), p_act, p_thr, float(np.float32(p_core_idle)),
            N, C, _ptr(new_busy), _ptr(done), _ptr(new_energy),
            _ptr(new_bsec), _ptr(block_cand), _ptr(cand), stream)
    if err != 0:
        raise RuntimeError(f"dcsim_advance kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return new_busy, done, new_energy, new_bsec, cand
