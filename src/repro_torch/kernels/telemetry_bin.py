"""Wrapper of the fused latency-binning CUDA kernel
(``csrc/telemetry_bin.cu``).

Port of the Pallas TPU kernel ``repro.kernels.telemetry_bin.
telemetry_accum``.  The plain version is ``ref.telemetry_accum_reference``;
the source note in the ``.cu`` file says what bounds the kernel on an H100
and what its design does about it.  ``LAUNCHES`` counts the kernel's
launches.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import build
from .dcsim_step import _check

LAUNCHES = 0


def telemetry_accum(job_vals, job_wts, task_vals, task_wts,
                    job_hist, task_hist, win, widx, wvals, lo, hi):
    """Fused telemetry update on the card.  job_vals/job_wts (J,) f32;
    task_vals/task_wts (M,) f32; job_hist/task_hist (B,) f32; win (W, K)
    f32; widx 0-d int32 tensor on the card; wvals (K,) f32; lo/hi Python
    floats bounding the log-spaced bins.

    Returns new (job_hist, task_hist, win); the inputs are not modified."""
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
    if 2 * B * 4 > 48 * 1024:
        raise ValueError(f"n_bins={B} exceeds the kernel's shared memory")

    lib = build.load("telemetry_bin")
    jh, th, w = job_hist.clone(), task_hist.clone(), win.clone()
    lo32 = float(np.float32(lo))
    scale = float(np.float32(B / math.log(hi / lo)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.telemetry_bin_launch(
            job_vals.data_ptr(), job_wts.data_ptr(), J,
            task_vals.data_ptr(), task_wts.data_ptr(), M,
            lo32, scale, B, jh.data_ptr(), th.data_ptr(),
            w.data_ptr(), W, K, widx.data_ptr(), wvals.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"telemetry_accum kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return jh, th, w
