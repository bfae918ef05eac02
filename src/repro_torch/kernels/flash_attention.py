"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Port of the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention`` with its full signature: GQA, ``causal``, ``window``,
``softcap``, any Sq and Skv.  The plain version is ``ref.mha_reference``;
the source note in the ``.cu`` file says what bounds the kernel on an H100
and what its design does about it.  ``LAUNCHES`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

LAUNCHES = 0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _check(x, name, dtype, dev):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.device != dev:
        raise ValueError(f"all inputs must be on {dev}, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name} must have 4 dims, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Attention on the card.  q (B, H, Sq, hd); k/v (B, KV, Skv, hd), all
    float32 or all bfloat16, H % KV == 0, hd in ``HEAD_DIMS``.  Any strides
    with the head dimension contiguous: the model passes its (B, S, H, hd)
    tensors as ``transpose(1, 2)`` views and no copy is made.

    Returns (B, H, Sq, hd) in q's dtype, laid out like q (``empty_like``),
    so the model's transpose back is contiguous again."""
    global LAUNCHES
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be one of {list(DTYPES)}, got {q.dtype}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(x, name, q.dtype, q.device)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, Skv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v must have shape (B, KV, Skv, hd) = "
                         f"{(B, KV, Skv, hd)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv "
                         f"heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if min(B, Sq, Skv) < 1 or window < 0:
        raise ValueError(f"empty attention or negative window: B={B} "
                         f"Sq={Sq} Skv={Skv} window={window}")

    lib = build.load("flash_attention")
    dev = q.device
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Skv, hd, DTYPES[q.dtype], strides, int(causal),
            int(window), 1.0 / math.sqrt(hd), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
