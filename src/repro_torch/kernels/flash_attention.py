"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Port of the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention`` with its full signature: GQA, ``causal``, ``window``,
``softcap``, any Sq and Skv.  The plain version is ``ref.mha_reference``;
the source note in the ``.cu`` file says what bounds the kernel on an H100
and what its design does about it.

Two hand-written instances, chosen by dtype in ``plan``: bfloat16 runs on
the tensor cores (``mma_bf16``), float32 on the CUDA cores (``simt_f32``).
``LAUNCHES`` counts the kernel's launches, ``INSTANCE_LAUNCHES`` splits
them by instance, ``SHAPE_LAUNCHES`` by shape and mask ((B, H, KV, Sq,
Skv, hd, causal, window) -> launches), and ``LAST_INSTANCE`` names the
instance of the latest.  The backward (``csrc/flash_attention_bwd.cu``)
has the same two instances, chosen in ``plan_backward``, and counts in
``BWD_LAUNCHES``, ``BWD_INSTANCE_LAUNCHES``, ``BWD_SHAPE_LAUNCHES`` and
``LAST_BWD_INSTANCE``.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch._subclasses.fake_tensor import is_fake

from . import build

LAUNCHES = 0
TENSOR_CORE, CUDA_CORE = "mma_bf16", "simt_f32"
INSTANCE_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
SHAPE_LAUNCHES: dict = {}
LAST_INSTANCE = None
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _check(q, k, v, *others, window=0) -> None:
    """The checks every instance and the backward share (``others``, named
    tensors shaped like q: the backward's out and dout), or ValueError
    with the reason."""
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be one of {list(DTYPES)}, got {q.dtype}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")) + others:
        if x.dim() != 4:
            raise ValueError(f"{name} must have 4 dims, got {tuple(x.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {x.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, Skv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v must have shape (B, KV, Skv, hd) = "
                         f"{(B, KV, Skv, hd)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    for x, name in others:
        if tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(x.shape)}")
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv "
                         f"heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}: neither "
                         f"instance is built for it")
    if min(B, Sq, Skv) < 1 or window < 0 or max(B, H) > 65535:
        raise ValueError(f"empty attention, negative window or grid too "
                         f"large: B={B} H={H} Sq={Sq} Skv={Skv} "
                         f"window={window}")


def rows_aligned(x) -> bool:
    """Whether x's base address and its batch, head and sequence strides
    are multiples of 16 bytes (8 bf16 elements), as the tensor-core
    instances' 16-byte row copies need.  A tensor without storage (fake or
    meta; the dry run's) has its offset into an aligned allocation."""
    if is_fake(x) or x.is_meta:
        base = x.storage_offset() * x.element_size()
    else:
        base = x.data_ptr()
    return base % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3])


def _check_aligned(tensors) -> None:
    for x, name in tensors:
        if not rows_aligned(x):
            raise ValueError(
                f"{name}: the bf16 tensor-core instance loads 16-byte rows "
                f"asynchronously, so its base address and its batch, head "
                f"and sequence strides must be multiples of 16 bytes; got "
                f"address {x.data_ptr()} (storage offset "
                f"{x.storage_offset()}) and strides {x.stride()}")


def plan(q, k, v, *, window=0) -> str:
    """The instance that takes this call, or ValueError with the reason.

    Pure: reads dtypes, shapes, strides and addresses only, so it runs on
    CPU tensors.  q (B, H, Sq, hd), k/v (B, KV, Skv, hd), one dtype, head
    dimension contiguous, H % KV == 0, hd in ``HEAD_DIMS``.  The bf16
    instance copies 16-byte row chunks asynchronously, so there the base
    addresses and the batch, head and sequence strides must be multiples
    of 16 bytes (8 elements); a bf16 call that breaks this raises and
    never runs on the f32 instance."""
    _check(q, k, v, window=window)
    if q.dtype == torch.float32:
        return CUDA_CORE
    _check_aligned(((q, "q"), (k, "k"), (v, "v")))
    return TENSOR_CORE


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Attention on the card.  q (B, H, Sq, hd); k/v (B, KV, Skv, hd), all
    float32 or all bfloat16 (see ``plan``).  Any strides with the head
    dimension contiguous: the model passes its (B, S, H, hd) tensors as
    ``transpose(1, 2)`` views and no copy is made.

    Returns (B, H, Sq, hd) in q's dtype, laid out like q (``empty_like``),
    so the model's transpose back is contiguous again."""
    global LAUNCHES, LAST_INSTANCE
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{x.device}")
    instance = plan(q, k, v, window=window)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]

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
        raise RuntimeError(f"flash_attention kernel ({instance}) launch "
                           f"failed: cudaError {err}")
    LAUNCHES += 1
    INSTANCE_LAUNCHES[instance] += 1
    shape = (B, H, KV, Sq, Skv, hd, bool(causal), int(window))
    SHAPE_LAUNCHES[shape] = SHAPE_LAUNCHES.get(shape, 0) + 1
    LAST_INSTANCE = instance
    return out


# --------------------------------------------------------------------------
# the backward kernel (csrc/flash_attention_bwd.cu)
# --------------------------------------------------------------------------

BWD_LAUNCHES = 0
# the backward's launches by instance, and the instance of the latest
BWD_INSTANCE_LAUNCHES = {TENSOR_CORE: 0, CUDA_CORE: 0}
BWD_SHAPE_LAUNCHES: dict = {}
LAST_BWD_INSTANCE = None
# head dims the backward's tensor-core instance takes: at 256 its dk and
# dv would hold 128 registers each a thread, so bf16 hd 256 runs on the
# CUDA cores
BWD_TENSOR_CORE_HEAD_DIMS = (16, 32, 64, 128)


def plan_backward(q, k, v, out, dout, *, window=0) -> str:
    """The backward instance that takes this call, or ValueError with the
    reason.  Pure, like ``plan``: what the forward takes (q (B, H, Sq,
    hd), k/v (B, KV, Skv, hd), one dtype of ``DTYPES``, the head dimension
    contiguous, hd in ``HEAD_DIMS``), with ``out`` and ``dout`` shaped and
    typed like q.  bfloat16 at the head dims of
    ``BWD_TENSOR_CORE_HEAD_DIMS`` takes the tensor cores (``mma_bf16``),
    under the forward's alignment rule for q, k, v, out and dout: a call
    that breaks it raises and never runs on another instance.  float32,
    and bfloat16 at hd 256, take the CUDA cores (``simt_f32``), which read
    rows element by element and put no alignment rule on their inputs."""
    _check(q, k, v, (out, "out"), (dout, "dout"), window=window)
    if q.dtype == torch.float32 or \
            q.shape[-1] not in BWD_TENSOR_CORE_HEAD_DIMS:
        return CUDA_CORE
    _check_aligned(((q, "q"), (k, "k"), (v, "v"), (out, "out"),
                    (dout, "dout")))
    return TENSOR_CORE


def flash_attention_backward(q, k, v, out, dout, *, causal=True, window=0,
                             softcap=0.0):
    """The attention's gradient on the card: (dq, dk, dv), each shaped,
    typed and laid out like q, k and v (``empty_like``), from the forward's
    inputs, its output ``out`` and the output's gradient ``dout`` (see
    ``plan_backward``; ``ref.mha_backward_reference`` is the plain
    version).  Two kernels on the stream, no atomics, so two calls on the
    same inputs give the same bits: the first recomputes each row's
    log-sum-exp and D = rowsum(dout * out) into (B, H, Sq) float32 scratch
    and accumulates dq, the second accumulates dk and dv over each kv
    head's group.  One call counts once, in ``BWD_LAUNCHES`` and under
    its instance in ``BWD_INSTANCE_LAUNCHES``."""
    global BWD_LAUNCHES, LAST_BWD_INSTANCE
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"),
                    (dout, "dout")):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{x.device}")
    instance = plan_backward(q, k, v, out, dout, window=window)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    lib = build.load("flash_attention_bwd")
    dev = q.device
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    dd = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 24)(
        *(t.stride(i) for t in (q, k, v, out, dout, dq, dk, dv)
          for i in range(3)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), B, H, KV, Sq, Skv, hd,
            DTYPES[q.dtype], int(instance == TENSOR_CORE), strides,
            int(causal), int(window),
            1.0 / math.sqrt(hd), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel ({instance}) "
                           f"launch failed: cudaError {err}")
    BWD_LAUNCHES += 1
    BWD_INSTANCE_LAUNCHES[instance] += 1
    shape = (B, H, KV, Sq, Skv, hd, bool(causal), int(window))
    BWD_SHAPE_LAUNCHES[shape] = BWD_SHAPE_LAUNCHES.get(shape, 0) + 1
    LAST_BWD_INSTANCE = instance
    return dq, dk, dv
