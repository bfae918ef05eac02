"""Wrapper of the selective-SSM scan CUDA kernel (``csrc/ssm_scan.cu``).

Port of the Pallas TPU kernel ``repro.kernels.ssm_scan.ssm_scan``.  Unlike
the TPU kernel it returns the final state as well as ``y``, as the plain
version ``ref.ssm_scan_reference`` does: prefill keeps it in the decode
cache.  The source note in the ``.cu`` file says what bounds the kernel on
an H100 and what its design does about it.  ``LAUNCHES`` counts the
kernel's launches; ``LAST_INSTANCE`` names the lane split of the latest.
"""
from __future__ import annotations

import torch

from . import build

LAUNCHES = 0
LAST_INSTANCE = None
MAX_STATE = 64                  # the largest N the kernel's registers hold


def lanes_for(N: int) -> tuple:
    """(lanes per channel G, state elements per lane E) for state size N:
    two elements a lane (one at N = 1), G = N / 2 rounded up to a power of
    two, so 8 lanes at hymba's N = 16 and 32 at N = ``MAX_STATE``."""
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan takes 1 <= N <= {MAX_STATE}, got N={N}")
    E = 1 if N == 1 else 2
    return 1 << (-(-N // E) - 1).bit_length(), E


def plan(dt, Bm, Cm, x, A) -> tuple:
    """The wrapper's checks and the kernel instance, or ValueError with the
    reason.  Pure: reads dtypes, shapes and strides only, so it runs on
    CPU tensors.  dt/x (B, S, Dss), Bm/Cm (B, S, N), A (Dss, N), float32
    and contiguous.  Returns (G, E) of ``lanes_for``."""
    B, S, Dss = x.shape
    N = Bm.shape[-1]
    for t, name, shape in ((dt, "dt", (B, S, Dss)), (Bm, "Bm", (B, S, N)),
                           (Cm, "Cm", (B, S, N)), (x, "x", (B, S, Dss)),
                           (A, "A", (Dss, N))):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be {torch.float32}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(B, S, Dss) < 1 or B > 65535:
        raise ValueError(f"ssm_scan takes 1 <= B <= 65535 and S, Dss >= 1; "
                         f"got B={B} S={S} Dss={Dss}")
    return lanes_for(N)


def ssm_scan(dt, Bm, Cm, x, A):
    """Selective-SSM scan on the card.  dt/x (B, S, Dss), Bm/Cm (B, S, N),
    A (Dss, N): float32, contiguous, on one card; N <= ``MAX_STATE``.

    Returns (y (B, S, Dss) float32, h_final (B, Dss, N) float32)."""
    global LAUNCHES, LAST_INSTANCE
    dev = x.device
    for t, name in ((dt, "dt"), (Bm, "Bm"), (Cm, "Cm"), (x, "x"), (A, "A")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    G, E = plan(dt, Bm, Cm, x, A)
    B, S, Dss = x.shape
    N = Bm.shape[-1]

    lib = build.load("ssm_scan")
    y = torch.empty((B, S, Dss), dtype=torch.float32, device=dev)
    h = torch.empty((B, Dss, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssm_scan_launch(
            dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(),
            A.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, Dss, N, G,
            stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    LAST_INSTANCE = f"lanes{G}x{E}"
    return y, h


# --------------------------------------------------------------------------
# the backward kernel (csrc/ssm_scan_bwd.cu)
# --------------------------------------------------------------------------

BWD_LAUNCHES = 0
CKPT_STEPS = 64                 # the backward's checkpoint interval (SB_T)


def plan_backward(dt, Bm, Cm, x, A, dy, dh=None) -> tuple:
    """``plan``'s checks, plus dy (B, S, Dss) and dh (B, Dss, N) or None,
    float32 and contiguous.  Returns (G, E) of ``lanes_for``."""
    lanes = plan(dt, Bm, Cm, x, A)
    B, S, Dss = x.shape
    N = Bm.shape[-1]
    for t, name, shape in ((dy, "dy", (B, S, Dss)), (dh, "dh", (B, Dss, N))):
        if t is None and name == "dh":
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be {torch.float32}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return lanes


def ssm_scan_backward(dt, Bm, Cm, x, A, dy, dh=None):
    """The scan's gradient on the card: (ddt, dBm, dCm, dx, dA), float32,
    from its inputs, the gradient dy of y and dh of the final state (None:
    zero); see ``plan_backward``, and ``ref.ssm_scan_backward_reference``
    for the plain version.  The kernel recomputes the states from
    checkpoints every ``CKPT_STEPS`` steps, kept in (B, ceil(S / 64), Dss,
    N) float32 scratch, and adds dBm, dCm and dA with float atomics into
    zeroed outputs."""
    global BWD_LAUNCHES
    dev = x.device
    for t, name in ((dt, "dt"), (Bm, "Bm"), (Cm, "Cm"), (x, "x"), (A, "A"),
                    (dy, "dy"), (dh, "dh")):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    G, _ = plan_backward(dt, Bm, Cm, x, A, dy, dh)
    B, S, Dss = x.shape
    N = Bm.shape[-1]
    lib = build.load("ssm_scan_bwd")
    f32 = dict(dtype=torch.float32, device=dev)
    ddt, dx = torch.empty((B, S, Dss), **f32), torch.empty((B, S, Dss), **f32)
    dBm, dCm = torch.zeros((B, S, N), **f32), torch.zeros((B, S, N), **f32)
    dA = torch.zeros((Dss, N), **f32)
    ckpt = torch.empty((B, -(-S // CKPT_STEPS), Dss, N), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssm_scan_bwd_launch(
            dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(),
            A.data_ptr(), dy.data_ptr(), 0 if dh is None else dh.data_ptr(),
            ckpt.data_ptr(), ddt.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
            dx.data_ptr(), dA.data_ptr(), B, S, Dss, N, G, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan backward kernel launch failed: "
                           f"cudaError {err}")
    BWD_LAUNCHES += 1
    return ddt, dBm, dCm, dx, dA
