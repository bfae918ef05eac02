"""Wrapper of the fused latency-binning CUDA kernel
(``csrc/telemetry_bin.cu``).

Port of the Pallas TPU kernel ``repro.kernels.telemetry_bin.
telemetry_accum``.  The plain version is ``ref.telemetry_accum_reference``;
the source note in the ``.cu`` file says what bounds the kernel on an H100
and what its design does about it.  ``LAUNCHES`` counts the kernel's
launches.

A call may bin a batch of R replicas' streams (``core/montecarlo.py``):
every argument then has a leading (R,) axis (widx is (R,)), and the
kernel launches once for the batch, each replica into its own
histograms (``blockIdx.y`` is the replica).

The large-stream path reduces across blocks inside the launch, on scratch
(2B partial bins a block and a ticket counter a replica) that each device
makes at its first large call for a number of bins B and a batch size
and keeps.  As with ``dcsim_step``, launches on one device must not
overlap, and that first call must come before any CUDA graph capture.
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
BATCH_MIN_BLOCK = 128           # a batch's narrowest one-block launch
# shared memory a block may use without opting in, less the kernel's static
# arrays (a float a thread for the last block's part sums, and a flag)
SMEM_LIMIT = 48 * 1024 - 4 * THREADS - 16

# (device index, B, R) -> (partial bins (R * blocks * 2B,) f32, tickets
# (R,) i32)
_SCRATCH: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str             # "small" (one block) or "large" (grid-stride)
    grid: int             # blocks a replica (the grid's x extent)
    block: int            # threads a block
    smem: int             # dynamic shared memory: float parts and counts
                          # of two B-bin histograms
    scratch: int          # partial-bin slots, 2B a block (0 on "small")
    replicas: int = 1     # the grid's y extent


def plan(J: int, M: int, B: int, W: int, K: int, *, sms: int = 132,
         replicas: int = 1) -> Plan:
    """The path and launch geometry for ``replicas`` sets of J job values,
    M task values, B bins and a (W, K) window on a card with ``sms`` SMs,
    or ValueError.  Pure, so it runs without a card.  Streams of at most
    ``SMALL_MAX`` values (one a thread) take one block a replica; longer
    ones up to one block an SM in all (at least one a replica),
    grid-stride, each block with 2B partial bins of scratch; a replica
    left with one block takes the one-block path, grid-stride.  A batch's
    one-block path narrows its blocks to the streams (a multiple of 32,
    at least ``BATCH_MIN_BLOCK`` threads); one stream set keeps
    ``THREADS``."""
    if min(J, M, W, K) < 0 or B < 1:
        raise ValueError(f"telemetry_accum takes J, M, W, K >= 0 and B >= 1, "
                         f"got J={J} M={M} B={B} W={W} K={K}")
    if not 1 <= replicas <= build.MAX_REPLICAS:
        raise ValueError(f"telemetry_accum takes 1..{build.MAX_REPLICAS} "
                         f"replicas, got {replicas}")
    if max(J, M, W * K) > 2**31 - 1:
        raise ValueError("telemetry_accum indexes with 32-bit ints: a "
                         "stream or the window is too long")
    smem = 4 * B * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"n_bins={B} exceeds the kernel's shared memory: "
                         f"{smem} bytes of bins, {SMEM_LIMIT} available")
    n = max(J, M)
    grid = min(-(-n // THREADS), max(sms // replicas, 1))
    if n <= SMALL_MAX or grid == 1:
        block = THREADS if replicas == 1 else \
            min(THREADS, max(BATCH_MIN_BLOCK, -(-n // 32) * 32))
        return Plan("small", 1, block, smem, 0, replicas)
    return Plan("large", grid, THREADS, smem, replicas * grid * 2 * B,
                replicas)


def scratch(dev: torch.device, B: int, replicas: int = 1):
    """The device's (partial bins, tickets) for B bins and batches of
    ``replicas``, room for the blocks the plan can give them: made (the
    tickets zeroed) at the first large-stream call with this B and batch
    size and kept, so a captured graph's pointers stay valid; every launch
    sets its tickets back to 0."""
    key = (dev.index, B, replicas)
    s = _SCRATCH.get(key)
    if s is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("telemetry_accum: make a large-stream call "
                               "once on this device with this batch size "
                               "before capturing a CUDA graph")
        build.MISSES["telemetry_bin.scratch", key] += 1
        blocks = replicas * max(sm_count(dev) // replicas, 1)
        s = _SCRATCH[key] = (
            torch.empty((blocks * 2 * B,), dtype=torch.float32, device=dev),
            torch.zeros((replicas,), dtype=torch.int32, device=dev))
    return s


def telemetry_accum(job_vals, job_wts, task_vals, task_wts,
                    job_hist, task_hist, win, widx, wvals, lo, hi):
    """Fused telemetry update on the card.  job_vals/job_wts (*R, J) f32;
    task_vals/task_wts (*R, M) f32; job_hist/task_hist (*R, B) f32; win
    (*R, W, K) f32; widx (*R,) int32 on the card; wvals (*R, K) f32, with
    R the batch shape (``()`` for one stream set, ``(R,)`` for a replica
    batch); lo/hi Python floats bounding the log-spaced bins.

    Returns new (job_hist, task_hist, win), written by the kernel into
    fresh tensors; the inputs are not modified."""
    global LAUNCHES
    f32 = torch.float32
    if win.dim() < 2:
        raise ValueError(f"win must be (*R, W, K), got {tuple(win.shape)}")
    *batch, W, K = win.shape
    R = tuple(batch)
    J, M, B = job_vals.shape[-1], task_vals.shape[-1], job_hist.shape[-1]
    _check(job_vals, "job_vals", R + (J,), f32)
    _check(job_wts, "job_wts", R + (J,), f32)
    _check(task_vals, "task_vals", R + (M,), f32)
    _check(task_wts, "task_wts", R + (M,), f32)
    _check(job_hist, "job_hist", R + (B,), f32)
    _check(task_hist, "task_hist", R + (B,), f32)
    _check(win, "win", R + (W, K), f32)
    _check(widx, "widx", R, torch.int32)
    _check(wvals, "wvals", R + (K,), f32)
    dev = job_vals.device
    for x in (job_wts, task_vals, task_wts, job_hist, task_hist, win, widx,
              wvals):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")
    reps = math.prod(R)
    p = plan(J, M, B, W, K, sms=sm_count(dev), replicas=reps)

    lib = build.load("telemetry_bin")
    partial = ticket = None
    if p.path == "large":
        partial, ticket = scratch(dev, B, reps)
    jh = torch.empty(R + (B,), dtype=f32, device=dev)
    th = torch.empty(R + (B,), dtype=f32, device=dev)
    w = torch.empty(R + (W, K), dtype=f32, device=dev)
    lo32 = float(np.float32(lo))
    scale = float(np.float32(B / math.log(hi / lo)))
    err = _launch(dev, lambda stream: lib.telemetry_bin_launch(
        job_vals.data_ptr(), job_wts.data_ptr(), J, task_vals.data_ptr(),
        task_wts.data_ptr(), M, lo32, inv_f32(lo), scale, B,
        job_hist.data_ptr(),
        task_hist.data_ptr(), win.data_ptr(), W, K, widx.data_ptr(),
        wvals.data_ptr(), jh.data_ptr(), th.data_ptr(), w.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if ticket is None else ticket.data_ptr(), p.grid, reps,
        p.block, stream))
    if err != 0:
        raise RuntimeError(f"telemetry_accum kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return jh, th, w
