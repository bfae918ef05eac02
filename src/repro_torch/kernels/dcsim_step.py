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

Each device has one pair of scratch words per instance (the ticket counter
and the running minimum of the in-kernel reduction: 32-bit words for the
float32 clock, 64-bit for the float64 one), made at the first call there
and reused by every later one: launches on one device must not overlap,
so call it on one stream at a time (the port issues every call on the
current stream).  The first call of an instance on a device must come
before any CUDA graph capture, which then replays the launch on the same
words.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build

LAUNCHES = 0
CLOCK_LAUNCHES = {"float32": 0, "float64": 0}
THREADS = 256                   # DCSIM_THREADS in dcsim_step.cu
BLOCKS_PER_SM = 4               # the grid's cap, past which threads loop

# (device index, clock dtype) -> (2,) int32 (float32 clock) or int64
# (float64 clock): the ticket (0) and the minimum's order image (all bits
# set: empty), each put back by the launch that used it
_SCRATCH: dict = {}
SCRATCH_WORDS = 2
_WORD = {torch.float32: torch.int32, torch.float64: torch.int64}
_SMS: dict = {}                 # device index -> number of SMs


@dataclasses.dataclass(frozen=True)
class Plan:
    grid: int             # blocks
    block: int            # threads a block
    vec4: bool            # one float4 of core slots a server (C == 4)
    scratch: int          # 32-bit scratch words: ticket and minimum


def plan(N: int, C: int, *, sms: int = 132, aligned: bool = True,
         f64: bool = False) -> Plan:
    """The launch geometry for an (N, C) farm on a card with ``sms`` SMs,
    or ValueError.  Pure, so it runs without a card.  One server a thread
    up to ``BLOCKS_PER_SM`` blocks an SM, a grid-stride loop past that;
    the float4 path when the clock is float32, C == 4 and the core-slot
    rows are 16-byte ``aligned`` (the float64 clock reads its slots as
    scalars).  The reduction's scratch is two words whatever N, so a
    device's pair serves every call."""
    if N < 1 or C < 1:
        raise ValueError(f"dcsim_advance takes N, C >= 1, got N={N} C={C}")
    if N * C > 2**31 - 1:
        raise ValueError(f"dcsim_advance indexes servers with 32-bit ints: "
                         f"N={N} is too large")
    cap = BLOCKS_PER_SM * sms
    grid = min(-(-N // THREADS), cap)
    return Plan(grid=grid, block=THREADS,
                vec4=C == 4 and aligned and not f64, scratch=SCRATCH_WORDS)


def sm_count(dev: torch.device) -> int:
    """The card's number of SMs, read once per device."""
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def scratch(dev: torch.device, clock=torch.float32) -> torch.Tensor:
    """The scratch words (ticket, minimum image) of the ``clock`` instance
    on the device: made at its first call and put back to (0, empty) by
    every launch since."""
    key = (dev.index, clock)
    s = _SCRATCH.get(key)
    if s is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("dcsim_advance: call it once on this device "
                               "before capturing a CUDA graph")
        s = _SCRATCH[key] = torch.tensor([0, -1], dtype=_WORD[clock],
                                         device=dev)
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
    """Fused farm advance on the card.  core_busy (N, C) in the clock's
    dtype, float32 or float64; srv_state (N,) int32; energy/busy_seconds
    (N,) f32; srv_wake_at/srv_idle_since/srv_tau (N,) and t/t_next 0-d
    tensors in core_busy's dtype, on the same card (read there, no host
    sync); state_power (6,) f32; throttled (N,) int32 or bool.  A mix of
    clock dtypes raises.

    Returns (new_core_busy (N, C), done (N, C) bool, energy (N,) f32,
    busy_seconds (N,) f32, next_candidate ()), the clock-typed outputs in
    core_busy's dtype."""
    global LAUNCHES
    N, C = core_busy.shape
    f32, i32 = torch.float32, torch.int32
    tdt = core_busy.dtype
    if tdt not in _WORD:
        raise ValueError(f"core_busy must be float32 or float64, got {tdt}")
    _check(core_busy, "core_busy", (N, C), tdt)
    _check(srv_state, "srv_state", (N,), i32)
    _check(energy, "energy", (N,), f32)
    _check(busy_seconds, "busy_seconds", (N,), f32)
    # the clock-typed inputs share core_busy's dtype: no mix of clocks
    _check(t, "t", (), tdt)
    _check(t_next, "t_next", (), tdt)
    _check(state_power, "state_power", (6,), f32)
    for x, name in ((srv_wake_at, "srv_wake_at"),
                    (srv_idle_since, "srv_idle_since"), (srv_tau, "srv_tau")):
        if x is not None:
            _check(x, name, (N,), tdt)
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
    f64 = tdt == torch.float64
    words = scratch(dev, tdt)
    new_busy = torch.empty((N, C), dtype=tdt, device=dev)
    done = torch.empty((N, C), dtype=torch.bool, device=dev)
    new_energy = torch.empty((N,), dtype=f32, device=dev)
    new_bsec = torch.empty((N,), dtype=f32, device=dev)
    cand = torch.empty((), dtype=tdt, device=dev)
    p = plan(N, C, sms=sm_count(dev), aligned=core_busy.data_ptr() % 16 == 0,
             f64=f64)
    p_act = float(np.float32(p_core_active))
    p_thr = float(np.float32(p_core_active * throttle_power_scale))
    head = (_ptr(core_busy), _ptr(srv_state), _ptr(energy),
            _ptr(busy_seconds), _ptr(srv_wake_at), _ptr(srv_idle_since),
            _ptr(srv_tau), _ptr(throttled), _ptr(state_power), _ptr(t),
            _ptr(t_next), p_act, p_thr, float(np.float32(p_core_idle)), N, C,
            p.grid)
    outs = (_ptr(new_busy), _ptr(done), _ptr(new_energy), _ptr(new_bsec),
            words.data_ptr(), words.data_ptr() + words.element_size(),
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
