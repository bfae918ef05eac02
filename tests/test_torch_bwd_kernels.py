"""What Python decides before the backward kernels launch, on CPU tensors:
the attention backward's instance and alignment rule, a twin of each
attention backward kernel's tile ranges held exhaustively against the
mask, and the scan backward's lane split and geometry (checkpoints,
partial-sum scratch, shared memory, blocks an SM).  No card, no build:
the kernels themselves are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, ops, ssm_scan
from torch_kernel_inputs import FLASH_TC_EDGES

TC, SIMT = flash_attention.TENSOR_CORE, flash_attention.CUDA_CORE


def _bwd_args(B, H, KV, Sq, Skv, hd, dtype, model_layout=False):
    """q, k, v, out, dout of zeros, contiguous or in the model's (B, S,
    H, hd) storage seen as (B, H, S, hd)."""
    def make(n, S):
        if model_layout:
            return torch.zeros((B, S, n, hd), dtype=dtype).transpose(1, 2)
        return torch.zeros((B, n, S, hd), dtype=dtype)
    return make(H, Sq), make(KV, Skv), make(KV, Skv), make(H, Sq), \
        make(H, Sq)


@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("hd", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_plan_backward_picks_the_instance_by_dtype_and_head_dim(
        dtype, hd, model_layout):
    """bf16 at hd 16-128 on the tensor cores; hd 256 bf16 (dk and dv
    would take 128 registers each a thread) and every f32 call on the CUDA
    cores."""
    args = _bwd_args(2, 10, 2, 77, 130, hd, dtype, model_layout)
    want = TC if dtype == torch.bfloat16 and hd <= 128 else SIMT
    assert flash_attention.plan_backward(*args, window=16) == want
    assert (hd in flash_attention.BWD_TENSOR_CORE_HEAD_DIMS) == (hd <= 128)


def _shifted(x):
    """x's values in a view whose storage offset is one element."""
    return torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)


def _odd_stride(x):
    """x's values in a view whose sequence stride is hd + 1 elements."""
    B, H, S, hd = x.shape
    return torch.zeros((B, H, S, hd + 1), dtype=x.dtype)[..., :hd]


@pytest.mark.parametrize("mutate", [_shifted, _odd_stride])
@pytest.mark.parametrize("which", range(5))
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_flash_plan_backward_refuses_misaligned_bf16(hd, which, mutate):
    """A bf16 call that breaks the 16-byte row rule raises, whichever of
    q, k, v, out and dout breaks it: it is never sent to the CUDA-core
    instance or the plain version."""
    args = list(_bwd_args(1, 4, 2, 40, 40, hd, torch.bfloat16))
    args[which] = mutate(args[which])
    name = ("q", "k", "v", "out", "dout")[which]
    with pytest.raises(ValueError, match=f"{name}: the bf16 tensor-core"):
        flash_attention.plan_backward(*args)


@pytest.mark.parametrize("which", range(5))
def test_flash_plan_backward_alignment_binds_the_tensor_cores_only(which):
    """The CUDA-core instance reads element by element: f32 and bf16 hd
    256 take misaligned views."""
    for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 256)):
        args = list(_bwd_args(1, 4, 2, 40, 40, hd, dtype))
        args[which] = _shifted(_odd_stride(args[which]))
        assert flash_attention.plan_backward(*args) == SIMT


def test_flash_backward_wrapper_refuses_cpu_tensors_and_counts_nothing():
    args = _bwd_args(1, 2, 1, 8, 8, 16, torch.bfloat16)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention_backward(*args)
    assert flash_attention.BWD_INSTANCE_LAUNCHES == {TC: 0, SIMT: 0}
    assert ops.launch_counts(ops.BACKWARD)["flash_attention_backward"] == 0


def test_autograd_backward_hands_the_kernel_aligned_rows():
    """_FlashAttention.backward copies an output gradient that breaks the
    tensor-core instance's rule (a view at an odd offset) before the
    backward op sees it, which then takes its plan; the gradients are
    those of the aligned copy."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Spy(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.douts = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "flash_attention_backward" in str(func):
                self.douts.append(args[4])
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(torch.bfloat16).requires_grad_()
               for s in ((1, 4, 24, 16), (1, 2, 24, 16), (1, 2, 24, 16)))
    dout = torch.from_numpy(rng.standard_normal((1, 4, 24, 16),
                                                dtype=np.float32))
    odd = _shifted(dout.to(torch.bfloat16))
    odd.copy_(dout.to(torch.bfloat16))
    assert not flash_attention.rows_aligned(odd)
    got = []
    for g_out in (odd, odd.clone()):
        out = ops.flash_attention(q, k, v, causal=True, window=0)
        with Spy() as spy:
            got.append(torch.autograd.grad(out, (q, k, v), g_out))
        assert len(spy.douts) == 1
        seen = spy.douts[0]
        assert flash_attention.rows_aligned(seen) and torch.equal(seen, odd)
        assert flash_attention.plan_backward(
            q.detach(), k.detach(), v.detach(), out.detach(), seen) == TC
    for g, e in zip(*got):
        assert torch.equal(g, e)


# --------------------------------------------------------------------------
# the attention backward's tile ranges (csrc/flash_attention_bwd.cu
# fb_key_tiles, fb_query_tiles and the CUDA-core kernels' inline ranges)
# --------------------------------------------------------------------------

def _tiles(instance, hd):
    """(query rows of a dq block, keys of its tiles, keys of a dk/dv
    block, queries of its tiles) of each instance, as the kernels have
    them (FtTile, FbTile)."""
    if instance == TC:
        return 64, 64, 64, 32
    b = 32 if hd >= 256 else 64
    return b, b, b, b


def _key_tiles(q0, bq, bk, Sq, Skv, causal, window):
    """fb_key_tiles: the key tiles a query tile [q0, q0 + bq) visits."""
    q_last = min(q0 + bq, Sq) - 1
    k_begin, k_end = 0, Skv
    if not (window > 0 and q_last > Skv + window - 2):
        if window > 0:
            k_begin = max(0, q0 - window + 1)
        if causal:
            k_end = min(Skv, q_last + 1)
    lo = k_begin // bk
    return range(lo, (k_end - 1) // bk + 1 if k_end > k_begin else lo)


def _query_tiles(k0, bk, bq, Sq, Skv, causal, window):
    """fb_query_tiles: the query tiles a key tile [k0, k0 + bk) visits."""
    k_last = min(k0 + bk, Skv) - 1
    q_begin = k0 if causal else 0
    q_end = min(Sq, k_last + window) if window > 0 else Sq
    if window > 0 and Sq > Skv + window - 1:
        q_end = Sq
    q_begin = min(q_begin, q_end)
    lo = q_begin // bq
    return range(lo, (q_end - 1) // bq + 1 if q_end > q_begin else lo)


def _mask(Sq, Skv, causal, window):
    """(unmasked pairs, rows with no unmasked key), as ref.py has them."""
    q = np.arange(Sq)[:, None]
    kk = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), bool)
    if causal:
        m &= kk <= q
    if window:
        m &= kk > q - window
    dead = (np.arange(Sq) >= Skv + window - 1) if window else \
        np.zeros(Sq, bool)
    return m, dead


_TILE_CASES = [(1, 25, 5, 1100, 1100, 64, True, 1024, 0.0)] + FLASH_TC_EDGES


@pytest.mark.parametrize("case,instance", [
    (c, inst) for c in _TILE_CASES for inst in (TC, SIMT)
    if inst == SIMT or c[5] in flash_attention.BWD_TENSOR_CORE_HEAD_DIMS])
def test_flash_backward_tiles_cover_every_unmasked_pair_once(case,
                                                             instance):
    """The dq kernel's (query tile, key tile) visits cover every unmasked
    pair; the dk/dv kernel's cover every unmasked pair and every pair of a
    row with no unmasked key (it averages every key there, so dv takes
    1 / Skv of its dout); neither visits a tile twice, so every pair is
    covered exactly once.  hymba's training shape cut to 1,100 tokens and
    every tensor-core edge case, window edges and dead rows included."""
    _, _, _, Sq, Skv, hd, causal, window, _ = case
    bq, bk, bkv, bqk = _tiles(instance, hd)
    unmasked, dead = _mask(Sq, Skv, causal, window)
    need_kv = unmasked | (dead[:, None] & np.ones(Skv, bool)[None, :])

    seen = np.zeros((Sq, Skv), np.int32)
    for qt in range(-(-Sq // bq)):
        visited = list(_key_tiles(qt * bq, bq, bk, Sq, Skv, causal, window))
        assert len(set(visited)) == len(visited)
        for kt in visited:
            seen[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk] += 1
    assert seen.max() <= 1
    assert (seen[unmasked] == 1).all()

    seen[:] = 0
    for kt in range(-(-Skv // bkv)):
        visited = list(_query_tiles(kt * bkv, bkv, bqk, Sq, Skv, causal,
                                    window))
        assert len(set(visited)) == len(visited)
        for qt in visited:
            seen[qt * bqk:(qt + 1) * bqk, kt * bkv:(kt + 1) * bkv] += 1
    assert seen.max() <= 1
    assert (seen[need_kv] == 1).all()


def test_flash_backward_tiles_skip_most_of_hymbas_band():
    """At hymba's training shape (4,096, window 1,024) a dq block visits at
    most 17 of the 64 key tiles and a dk/dv block at most 17 query tiles:
    the kernels' work follows the band, not the square."""
    S, W = 4096, 1024
    assert max(len(_key_tiles(q0, 64, 64, S, S, True, W))
               for q0 in range(0, S, 64)) == 17
    assert max(len(_query_tiles(k0, 64, 64, S, S, True, W))
               for k0 in range(0, S, 64)) == 17


# --------------------------------------------------------------------------
# the scan backward's lane split and geometry (csrc/ssm_scan_bwd.cu)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("N,lanes", [
    (1, (1, 1)), (2, (1, 2)), (3, (1, 4)), (4, (1, 4)), (5, (2, 4)),
    (8, (2, 4)), (16, (4, 4)), (17, (8, 4)), (32, (8, 4)), (33, (16, 4)),
    (64, (16, 4))])
def test_ssm_backward_lane_split(N, lanes):
    """Four consecutive state elements a lane (N itself below 3); the
    lanes of a channel a power of two that holds N, and never more than
    the instances the launcher has (lanes x elements >= N)."""
    assert ssm_scan.backward_lanes(N) == lanes
    G, E = lanes
    assert G * E >= N and G & (G - 1) == 0 and 32 % G == 0


def test_ssm_backward_geometry_at_hymbas_training_shape():
    """(4, 4,096, 3,200, 16): 4 lanes of 4 elements, 32 channels a block,
    100 channel groups, a 100 x 4 grid; checkpoints every 16 steps (256
    segments, 210 MB); dB/dC partials (2, 4, 100, 4,096, 16), 210 MB,
    under the 256 MB the design allows; 55,808 bytes of shared memory a
    block, four blocks an SM, so the 400 blocks run as one wave."""
    geo = ssm_scan.backward_geometry(4, 4096, 3200, 16)
    assert geo["lanes"] == (4, 4)
    assert geo["channels_per_block"] == 32 and geo["groups"] == 100
    assert geo["grid"] == (100, 4)
    assert geo["segments"] == 256 == -(-4096 // ssm_scan.CKPT_STEPS)
    assert geo["ckpt_shape"] == (4, 256, 3200, 16)
    assert geo["ckpt_bytes"] == 4 * 4 * 256 * 3200 * 16 == 209_715_200
    assert geo["partial_shape"] == (2, 4, 100, 4096, 16)
    assert geo["partial_bytes"] == 209_715_200 <= 256 * 2**20
    assert geo["partial_dA_shape"] == (4, 3200, 16)
    assert geo["smem_bytes"] == 55_808 <= 232_448
    assert geo["blocks_per_sm"] >= 4
    slots = 132 * geo["blocks_per_sm"]
    assert np.prod(geo["grid"]) <= slots        # one wave, no tail


@pytest.mark.parametrize("N", [1, 2, 3, 7, 16, 17, 33, 64])
@pytest.mark.parametrize("B,S,Dss", [(2, 40, 50), (1, 17, 13),
                                     (3, 37, 200), (4, 4096, 3200)])
def test_ssm_backward_geometry_fits_every_instance(B, S, Dss, N):
    """Every lane split's block fits the 227 KB a block may take and at
    least two blocks an SM; the groups cover every channel, the segments
    every step, and the scratch holds one partial a (group, step, state)
    and one checkpoint a (segment, channel, state)."""
    geo = ssm_scan.backward_geometry(B, S, Dss, N)
    G, E = geo["lanes"]
    cpb = geo["channels_per_block"]
    assert cpb * G == ssm_scan.BWD_THREADS
    assert geo["smem_bytes"] <= 232_448 and geo["blocks_per_sm"] >= 2
    assert (geo["groups"] - 1) * cpb < Dss <= geo["groups"] * cpb
    nseg = geo["segments"]
    assert (nseg - 1) * ssm_scan.CKPT_STEPS < S <= nseg * ssm_scan.CKPT_STEPS
    assert geo["partial_bytes"] == 4 * int(np.prod(geo["partial_shape"]))
    assert geo["ckpt_bytes"] == 4 * int(np.prod(geo["ckpt_shape"]))


def test_ssm_plan_backward_returns_the_backward_split():
    from torch_kernel_inputs import ssm_inputs, torch_args
    args = torch_args(ssm_inputs(2, 9, 11, 16, 1))
    dy = torch.zeros((2, 9, 11))
    assert ssm_scan.plan_backward(*args, dy) == (4, 4)
    assert ssm_scan.plan_backward(*args, dy, torch.zeros((2, 11, 16))) == \
        (4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssm_scan.ssm_scan_backward(*args, dy)
