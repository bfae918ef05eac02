"""Wrapper of the fused farm-advance CUDA kernel (``csrc/dcsim_step.cu``).

Port of the Pallas TPU kernel ``repro.kernels.dcsim_step.dcsim_advance``
with its full signature (``throttled`` and ``throttle_power_scale``
included).  The plain version is ``ref.dcsim_advance_reference``; the
source note in the ``.cu`` file says what bounds the kernel on an H100 and
what its design does about it.  Two instances: a float32 clock and a
float64 clock (the time-typed tensors all float64; power and energy stay
float32).  ``LAUNCHES`` counts the kernel's launches, both instances (the
farm-wide minimum is part of the same launch); ``CLOCK_LAUNCHES`` splits
them by clock.

A call may advance a batch of R independent farms (``core/montecarlo.py``):
every per-server input then has a leading (R,) axis, t and t_next are
(R,), and the kernel launches once for the batch (``blockIdx.y`` is the
replica), with one candidate a replica.

Each device has one set of scratch words per instance and batch size (R
ticket counters, then R running minima of the in-kernel reduction: 32-bit
words for the float32 clock, 64-bit for the float64 one), made at the
first call there and reused by every later one: launches on one device
must not overlap, so call it on one stream at a time (the port issues
every call on the current stream).  The first call of an instance and
batch size on a device must come before any CUDA graph capture, which
then replays the launch on the same words.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import build

LAUNCHES = 0
CLOCK_LAUNCHES = {"float32": 0, "float64": 0}
THREADS = 256                   # DCSIM_THREADS in dcsim_step.cu
BLOCKS_PER_SM = 4               # the grid's cap, past which threads loop

# (device index, clock dtype, replicas R) -> (2R,) int32 (float32 clock)
# or int64 (float64 clock): R tickets (0), then R minima's order images
# (all bits set: empty), each put back by the launch that used it
_SCRATCH: dict = {}
SCRATCH_WORDS = 2                       # a replica
_WORD = {torch.float32: torch.int32, torch.float64: torch.int64}
_SMS: dict = {}                 # device index -> number of SMs


@dataclasses.dataclass(frozen=True)
class Plan:
    grid: int             # blocks a replica (the grid's x extent)
    block: int            # threads a block
    vec4: bool            # one float4 of core slots a server (C == 4)
    scratch: int          # scratch words: a ticket and a minimum a replica
    replicas: int = 1     # the grid's y extent


def plan(N: int, C: int, *, sms: int = 132, aligned: bool = True,
         f64: bool = False, replicas: int = 1) -> Plan:
    """The launch geometry for ``replicas`` farms of (N, C) on a card
    with ``sms`` SMs, or ValueError.  Pure, so it runs without a card.
    One server a thread up to ``BLOCKS_PER_SM`` blocks an SM in all, a
    grid-stride loop past that (each replica keeps at least one block);
    the float4 path when the clock is float32, C == 4 and the core-slot
    rows are 16-byte ``aligned`` (the float64 clock reads its slots as
    scalars).  The reduction's scratch is two words a replica whatever N,
    so a device's set serves every call of that batch size."""
    if N < 1 or C < 1:
        raise ValueError(f"dcsim_advance takes N, C >= 1, got N={N} C={C}")
    if not 1 <= replicas <= build.MAX_REPLICAS:
        raise ValueError(f"dcsim_advance takes 1..{build.MAX_REPLICAS} "
                         f"replicas, got {replicas}")
    if N * C > 2**31 - 1:
        raise ValueError(f"dcsim_advance indexes servers with 32-bit ints: "
                         f"N={N} is too large")
    cap = max(BLOCKS_PER_SM * sms // replicas, 1)
    grid = min(-(-N // THREADS), cap)
    return Plan(grid=grid, block=THREADS,
                vec4=C == 4 and aligned and not f64,
                scratch=SCRATCH_WORDS * replicas, replicas=replicas)


def sm_count(dev: torch.device) -> int:
    """The card's number of SMs, read once per device."""
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def scratch(dev: torch.device, clock=torch.float32,
            replicas: int = 1) -> torch.Tensor:
    """The scratch words (R tickets, then R minimum images) of the
    ``clock`` instance for batches of ``replicas`` on the device: made at
    its first call and put back to (0, empty) by every launch since."""
    key = (dev.index, clock, replicas)
    s = _SCRATCH.get(key)
    if s is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("dcsim_advance: call it once on this device "
                               "with this batch size before capturing a "
                               "CUDA graph")
        s = _SCRATCH[key] = torch.tensor([0] * replicas + [-1] * replicas,
                                         dtype=_WORD[clock], device=dev)
    return s


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


def _launch(dev, fn):
    """Run ``fn(stream)`` with ``dev`` current, switching to it only when it
    is not current already."""
    if torch.cuda.current_device() == dev.index:
        return fn(torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(torch.cuda.current_stream(dev).cuda_stream)


def dcsim_advance(core_busy, srv_state, energy, busy_seconds, t, t_next,
                  state_power, p_core_active, p_core_idle,
                  srv_wake_at=None, srv_idle_since=None, srv_tau=None,
                  throttled=None, *, throttle_power_scale=1.0):
    """Fused farm advance on the card.  core_busy (*B, N, C) in the
    clock's dtype, float32 or float64, with B the batch shape (``()`` for
    one farm, ``(R,)`` for R replicas); srv_state (*B, N) int32;
    energy/busy_seconds (*B, N) f32; srv_wake_at/srv_idle_since/srv_tau
    (*B, N) and t/t_next (*B,) tensors in core_busy's dtype, on the same
    card (read there, no host sync); state_power (6,) f32, shared;
    throttled (*B, N) int32 or bool.  A mix of clock dtypes raises.

    Returns (new_core_busy (*B, N, C), done (*B, N, C) bool, energy (*B,
    N) f32, busy_seconds (*B, N) f32, next_candidate (*B,)), the
    clock-typed outputs in core_busy's dtype."""
    global LAUNCHES
    if core_busy.dim() < 2:
        raise ValueError(f"core_busy must be (*B, N, C), got "
                         f"{tuple(core_busy.shape)}")
    *batch, N, C = core_busy.shape
    B = tuple(batch)
    R = math.prod(B)
    f32, i32 = torch.float32, torch.int32
    tdt = core_busy.dtype
    if tdt not in _WORD:
        raise ValueError(f"core_busy must be float32 or float64, got {tdt}")
    _check(core_busy, "core_busy", B + (N, C), tdt)
    _check(srv_state, "srv_state", B + (N,), i32)
    _check(energy, "energy", B + (N,), f32)
    _check(busy_seconds, "busy_seconds", B + (N,), f32)
    # the clock-typed inputs share core_busy's dtype: no mix of clocks
    _check(t, "t", B, tdt)
    _check(t_next, "t_next", B, tdt)
    _check(state_power, "state_power", (6,), f32)
    for x, name in ((srv_wake_at, "srv_wake_at"),
                    (srv_idle_since, "srv_idle_since"), (srv_tau, "srv_tau")):
        if x is not None:
            _check(x, name, B + (N,), tdt)
    if throttled is not None:
        if throttled.dtype != i32:
            throttled = throttled.to(i32)
        _check(throttled, "throttled", B + (N,), i32)
    dev = core_busy.device
    for x in (srv_state, energy, busy_seconds, t, t_next, state_power,
              srv_wake_at, srv_idle_since, srv_tau, throttled):
        if x is not None and x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")

    p = plan(N, C, sms=sm_count(dev), aligned=core_busy.data_ptr() % 16 == 0,
             f64=tdt == torch.float64, replicas=R)
    lib = build.load("dcsim_step")
    f64 = tdt == torch.float64
    words = scratch(dev, tdt, R)
    new_busy = torch.empty(B + (N, C), dtype=tdt, device=dev)
    done = torch.empty(B + (N, C), dtype=torch.bool, device=dev)
    new_energy = torch.empty(B + (N,), dtype=f32, device=dev)
    new_bsec = torch.empty(B + (N,), dtype=f32, device=dev)
    cand = torch.empty(B, dtype=tdt, device=dev)
    p_act = float(np.float32(p_core_active))
    p_thr = float(np.float32(p_core_active * throttle_power_scale))
    head = (_ptr(core_busy), _ptr(srv_state), _ptr(energy),
            _ptr(busy_seconds), _ptr(srv_wake_at), _ptr(srv_idle_since),
            _ptr(srv_tau), _ptr(throttled), _ptr(state_power), _ptr(t),
            _ptr(t_next), p_act, p_thr, float(np.float32(p_core_idle)), N, C,
            p.grid, R)
    outs = (_ptr(new_busy), _ptr(done), _ptr(new_energy), _ptr(new_bsec),
            words.data_ptr(), words.data_ptr() + R * words.element_size(),
            _ptr(cand))
    if f64:
        err = _launch(dev, lambda stream: lib.dcsim_advance_launch_f64(
            *head, *outs, stream))
    else:
        err = _launch(dev, lambda stream: lib.dcsim_advance_launch(
            *head, int(p.vec4), *outs, stream))
    if err != 0:
        raise RuntimeError(f"dcsim_advance kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    CLOCK_LAUNCHES["float64" if f64 else "float32"] += 1
    return new_busy, done, new_energy, new_bsec, cand
