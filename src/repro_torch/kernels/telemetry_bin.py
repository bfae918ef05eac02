"""Wrapper of the fused latency-binning CUDA kernel
(``csrc/telemetry_bin.cu``).

Port of the Pallas TPU kernel ``repro.kernels.telemetry_bin.
telemetry_accum``.  The plain version is ``ref.telemetry_accum_reference``;
the source note in the ``.cu`` file says what bounds the kernel on an H100
and what its design does about it.  ``LAUNCHES`` counts the kernel's
launches.

The large-stream path reduces across blocks inside the launch, on scratch
(2B partial bins a block and a ticket counter) that each device makes at
its first large call for a number of bins B and keeps.  As with
``dcsim_step``, launches on one device must not overlap, and that first
call must come before any CUDA graph capture.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import build
from .dcsim_step import _check, _launch, sm_count
from .ref import inv_f32

LAUNCHES = 0
THREADS = 1024                  # TB_THREADS in telemetry_bin.cu
SMALL_MAX = THREADS             # the longest stream the one-block path takes
# shared memory a block may use without opting in, less the kernel's static
# arrays (a float a thread for the last block's part sums, and a flag)
SMEM_LIMIT = 48 * 1024 - 4 * THREADS - 16

# (device index, B) -> (partial bins (SMs * 2B,) f32, ticket (1,) i32)
_SCRATCH: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str             # "small" (one block) or "large" (grid-stride)
    grid: int             # blocks
    block: int            # threads a block
    smem: int             # dynamic shared memory: float parts and counts
                          # of two B-bin histograms
    scratch: int          # partial-bin slots, 2B a block (0 on "small")


def plan(J: int, M: int, B: int, W: int, K: int, *, sms: int = 132) -> Plan:
    """The path and launch geometry for J job values, M task values, B bins
    and a (W, K) window on a card with ``sms`` SMs, or ValueError.  Pure,
    so it runs without a card.  Streams of at most ``SMALL_MAX`` values
    (one a thread) take one block; longer ones up to one block an SM,
    grid-stride, each block with 2B partial bins of scratch."""
    if min(J, M, W, K) < 0 or B < 1:
        raise ValueError(f"telemetry_accum takes J, M, W, K >= 0 and B >= 1, "
                         f"got J={J} M={M} B={B} W={W} K={K}")
    if max(J, M, W * K) > 2**31 - 1:
        raise ValueError("telemetry_accum indexes with 32-bit ints: a "
                         "stream or the window is too long")
    smem = 4 * B * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"n_bins={B} exceeds the kernel's shared memory: "
                         f"{smem} bytes of bins, {SMEM_LIMIT} available")
    n = max(J, M)
    if n <= SMALL_MAX:
        return Plan("small", 1, THREADS, smem, 0)
    grid = min(-(-n // THREADS), sms)
    return Plan("large", grid, THREADS, smem, grid * 2 * B)


def scratch(dev: torch.device, B: int):
    """The device's (partial bins, ticket) for B bins, room for one block
    an SM: made (the ticket zeroed) at the first large-stream call with
    this B and kept, so a captured graph's pointers stay valid; every
    launch sets the ticket back to 0."""
    s = _SCRATCH.get((dev.index, B))
    if s is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("telemetry_accum: make a large-stream call "
                               "once on this device before capturing a "
                               "CUDA graph")
        s = _SCRATCH[(dev.index, B)] = (
            torch.empty((sm_count(dev) * 2 * B,), dtype=torch.float32,
                        device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    return s


def telemetry_accum(job_vals, job_wts, task_vals, task_wts,
                    job_hist, task_hist, win, widx, wvals, lo, hi):
    """Fused telemetry update on the card.  job_vals/job_wts (J,) f32;
    task_vals/task_wts (M,) f32; job_hist/task_hist (B,) f32; win (W, K)
    f32; widx 0-d int32 tensor on the card; wvals (K,) f32; lo/hi Python
    floats bounding the log-spaced bins.

    Returns new (job_hist, task_hist, win), written by the kernel into
    fresh tensors; the inputs are not modified."""
    global LAUNCHES
    f32 = torch.float32
    J, M, B = job_vals.shape[0], task_vals.shape[0], job_hist.shape[0]
    W, K = win.shape
    _check(job_vals, "job_vals", (J,), f32)
    _check(job_wts, "job_wts", (J,), f32)
    _check(task_vals, "task_vals", (M,), f32)
    _check(task_wts, "task_wts", (M,), f32)
    _check(job_hist, "job_hist", (B,), f32)
    _check(task_hist, "task_hist", (B,), f32)
    _check(win, "win", (W, K), f32)
    _check(widx, "widx", (), torch.int32)
    _check(wvals, "wvals", (K,), f32)
    dev = job_vals.device
    for x in (job_wts, task_vals, task_wts, job_hist, task_hist, win, widx,
              wvals):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")
    p = plan(J, M, B, W, K, sms=sm_count(dev))

    lib = build.load("telemetry_bin")
    partial = ticket = None
    if p.path == "large":
        partial, ticket = scratch(dev, B)
    jh = torch.empty((B,), dtype=f32, device=dev)
    th = torch.empty((B,), dtype=f32, device=dev)
    w = torch.empty((W, K), dtype=f32, device=dev)
    lo32 = float(np.float32(lo))
    scale = float(np.float32(B / math.log(hi / lo)))
    err = _launch(dev, lambda stream: lib.telemetry_bin_launch(
        job_vals.data_ptr(), job_wts.data_ptr(), J, task_vals.data_ptr(),
        task_wts.data_ptr(), M, lo32, inv_f32(lo), scale, B,
        job_hist.data_ptr(),
        task_hist.data_ptr(), win.data_ptr(), W, K, widx.data_ptr(),
        wvals.data_ptr(), jh.data_ptr(), th.data_ptr(), w.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if ticket is None else ticket.data_ptr(), p.grid, stream))
    if err != 0:
        raise RuntimeError(f"telemetry_accum kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return jh, th, w
