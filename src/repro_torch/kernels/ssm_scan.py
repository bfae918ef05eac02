"""Wrapper of the selective-SSM scan CUDA kernel (``csrc/ssm_scan.cu``).

Port of the Pallas TPU kernel ``repro.kernels.ssm_scan.ssm_scan``.  Unlike
the TPU kernel it returns the final state as well as ``y``, as the plain
version ``ref.ssm_scan_reference`` does: prefill keeps it in the decode
cache.  The source note in the ``.cu`` file says what bounds the kernel on
an H100 and what its design does about it.  ``LAUNCHES`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from . import build
from .dcsim_step import _check

LAUNCHES = 0
MAX_STATE = 64                  # the largest N the kernel's registers hold


def ssm_scan(dt, Bm, Cm, x, A):
    """Selective-SSM scan on the card.  dt/x (B, S, Dss), Bm/Cm (B, S, N),
    A (Dss, N): float32, contiguous, on one card; N <= ``MAX_STATE``.

    Returns (y (B, S, Dss) float32, h_final (B, Dss, N) float32)."""
    global LAUNCHES
    f32 = torch.float32
    B, S, Dss = x.shape
    N = Bm.shape[-1]
    _check(dt, "dt", (B, S, Dss), f32)
    _check(Bm, "Bm", (B, S, N), f32)
    _check(Cm, "Cm", (B, S, N), f32)
    _check(x, "x", (B, S, Dss), f32)
    _check(A, "A", (Dss, N), f32)
    dev = x.device
    for t in (dt, Bm, Cm, A):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    if min(B, S, Dss, N) < 1 or N > MAX_STATE or B > 65535:
        raise ValueError(f"ssm_scan takes 1 <= B <= 65535, S, Dss >= 1 and "
                         f"1 <= N <= {MAX_STATE}; got B={B} S={S} Dss={Dss} "
                         f"N={N}")

    lib = build.load("ssm_scan")
    y = torch.empty((B, S, Dss), dtype=f32, device=dev)
    h = torch.empty((B, Dss, N), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssm_scan_launch(
            dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(),
            A.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, Dss, N, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return y, h
