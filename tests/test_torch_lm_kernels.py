"""The LM substrate's kernels in the port: the plain PyTorch versions of
flash attention and the selective-SSM scan (what the CPU path runs and
what the CUDA kernels are held against on the card) against the JAX
package's jnp oracles and its Pallas kernels in interpret mode, at the
shapes of tests/test_kernels.py and at ragged ones; dispatch and launch
counting; what the CUDA wrappers decide before a launch (the attention's
instance and its checks, the scan's lane split).  The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: attention 2e-5 in float32 and 2e-2 in bfloat16 (those of
tests/test_kernels.py: both sides sum in float32 in their own order);
SSM scan 1e-4 in float32 and 3e-2 in bfloat16 (a recurrence over S steps
accumulates the reordered sums of the output's contraction)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm
from repro_torch.kernels import flash_attention, ops, ref, ssm_scan

from torch_kernel_inputs import flash_inputs, ssm_inputs, torch_args

torch.set_num_threads(1)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(np_arrays, dtype):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in np_arrays],
            [torch.from_numpy(a).to(td) for a in np_arrays])


def _close(got, exp, tol, ctx=""):
    np.testing.assert_allclose(got.float().numpy(), np.float32(exp),
                               atol=tol, rtol=tol, err_msg=ctx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,causal,window,cap", [
    (2, 4, 2, 256, 256, 64, True, 0, 0.0),
    (1, 4, 4, 128, 128, 128, True, 0, 50.0),     # softcap (gemma2)
    (2, 2, 1, 256, 256, 64, True, 64, 0.0),      # sliding window
    (1, 8, 2, 384, 384, 64, True, 0, 0.0),       # non-multiple of block
    (1, 2, 2, 128, 256, 32, False, 0, 0.0),      # cross attention
])
def test_mha_plain_matches_jax_ref_and_pallas(B, H, KV, Sq, Skv, hd, causal,
                                              window, cap, dtype):
    """The CPU route of ops.flash_attention (the plain version) equals the
    jnp oracle and the Pallas kernel (interpret) over the reference's
    sweep: GQA, softcap, window, non-multiple of the block, cross."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        flash_inputs(B, H, KV, Sq, Skv, hd, 0), dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == (B, H, Sq, hd)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    _close(got, jref.mha_reference(jq, jk, jv, **kw), tol, "vs jnp oracle")
    _close(got, pallas_flash(jq, jk, jv, interpret=True, **kw), tol,
           "vs Pallas interpret")


@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,causal,window,cap", [
    (1, 6, 3, 70, 70, 16, True, 24, 0.0),        # ragged, window < S
    (2, 4, 2, 100, 60, 32, True, 0, 30.0),       # Sq > Skv, softcap
    (1, 2, 1, 90, 30, 16, True, 20, 0.0),        # rows with no unmasked key
    (1, 2, 2, 33, 129, 128, False, 17, 0.0),     # non-causal window
])
def test_mha_plain_ragged_matches_jax_ref(B, H, KV, Sq, Skv, hd, causal,
                                          window, cap):
    (jq, jk, jv), (tq, tk, tv) = _both(
        flash_inputs(B, H, KV, Sq, Skv, hd, 1), "float32")
    kw = dict(causal=causal, window=window, softcap=cap)
    _close(ref.mha_reference(tq, tk, tv, **kw),
           jref.mha_reference(jq, jk, jv, **kw), 2e-5)


def test_mha_plain_takes_strided_views():
    """The model hands (B, S, H, hd) tensors over as (B, H, S, hd) views."""
    _, (q, k, v) = _both(flash_inputs(2, 4, 2, 40, 40, 16, 2), "float32")
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert not qs.is_contiguous()
    assert torch.equal(ref.mha_reference(qs, ks, vs, window=8),
                       ref.mha_reference(q, k, v, window=8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Dss,N", [(2, 32, 64, 8), (3, 37, 50, 16),
                                       (1, 5, 3, 20)])
def test_ssm_plain_matches_jax_ref(B, S, Dss, N, dtype):
    """y and the final state h against the reference's lax.scan oracle,
    ragged Dss and S included (the Pallas kernel refuses those)."""
    j, t = _both(ssm_inputs(B, S, Dss, N, 3), dtype)
    y, h = ops.ssm_scan(*t)
    ye, he = jref.ssm_scan_reference(*j)
    assert y.dtype == t[3].dtype and h.dtype == torch.float32
    assert y.shape == (B, S, Dss) and h.shape == (B, Dss, N)
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    _close(y, ye, tol, "y")
    _close(h, he, tol, "h")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Dss,N,block_d,chunk_t", [
    (2, 32, 256, 16, 256, 16), (1, 48, 128, 8, 64, 16)])
def test_ssm_plain_matches_pallas(B, S, Dss, N, block_d, chunk_t, dtype):
    """y against the Pallas kernel (interpret) where its asserts allow:
    Dss % block_d == 0 and S % chunk_t == 0."""
    j, t = _both(ssm_inputs(B, S, Dss, N, 4), dtype)
    y, _ = ref.ssm_scan_reference(*t)
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    _close(y, pallas_ssm(*j, block_d=block_d, chunk_t=chunk_t,
                         interpret=True), tol)


def test_ops_dispatch_lm_kernels_on_cpu_counts_nothing():
    ops.reset_launch_counts()
    _, (q, k, v) = _both(flash_inputs(1, 4, 2, 20, 20, 16, 5), "float32")
    assert torch.equal(ops.flash_attention(q, k, v, window=6),
                       ref.mha_reference(q, k, v, window=6))
    a = torch_args(ssm_inputs(2, 9, 12, 4, 6))
    for g, e in zip(ops.ssm_scan(*a), ref.ssm_scan_reference(*a)):
        assert torch.equal(g, e)
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["ssm_scan"] == 0
    # a device with no kernel never runs one: only the CPU (the plain
    # version), CUDA (the kernel) and Meta (the op's fake implementation,
    # shapes only) have one, and the fake refuses inputs on more than one
    # device
    for op in ("flash_attention", "ssm_scan"):
        assert [torch._C._dispatch_has_kernel_for_dispatch_key(
            f"repro_torch::{op}", key) for key in
            ("CPU", "CUDA", "Meta", "XPU", "MPS")] == [True] * 3 + [False] * 2
    with pytest.raises(ValueError, match="more than one device"):
        ops.ssm_scan(*a[:3], a[3].to("meta"), a[4])
    y, h = ops.ssm_scan(*[x.to("meta") for x in a])
    exp = ref.ssm_scan_reference(*a)
    assert (y.shape, y.dtype, h.shape, h.dtype) == \
        (exp[0].shape, exp[0].dtype, exp[1].shape, exp[1].dtype)
    assert ops.launch_counts()["ssm_scan"] == 0


def test_lm_cuda_wrappers_refuse_cpu_tensors():
    """The wrappers check device, dtype and shape before they build or
    launch anything: a CPU tensor never reaches a kernel."""
    _, (q, k, v) = _both(flash_inputs(1, 2, 1, 8, 8, 16, 7), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssm_scan.ssm_scan(*torch_args(ssm_inputs(1, 4, 8, 4, 8)))


# What Python decides before a launch: flash attention's instance and
# checks, the scan's lane split.  Shapes and CPU tensors only -- no card,
# no build.

def _qkv(B, H, KV, Sq, Skv, hd, dtype, model_layout=False):
    q = torch.zeros((B, H, Sq, hd), dtype=dtype)
    k = torch.zeros((B, KV, Skv, hd), dtype=dtype)
    if model_layout:          # (B, S, H, hd) storage seen as (B, H, S, hd)
        q = torch.zeros((B, Sq, H, hd), dtype=dtype).transpose(1, 2)
        k = torch.zeros((B, Skv, KV, hd), dtype=dtype).transpose(1, 2)
    return q, k, k.clone()


@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("hd", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("dtype,instance", [
    (torch.bfloat16, flash_attention.TENSOR_CORE),
    (torch.float32, flash_attention.CUDA_CORE)])
def test_flash_plan_picks_the_instance_by_dtype(dtype, instance, hd,
                                                model_layout):
    q, k, v = _qkv(2, 10, 2, 77, 130, hd, dtype, model_layout)
    assert flash_attention.plan(q, k, v, window=16) == instance


def _shifted(q):
    """q's values in a view whose storage offset is one element."""
    return torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)


def _odd_stride(q):
    """q's values in a view whose sequence stride is hd + 1 elements."""
    B, H, S, hd = q.shape
    return torch.zeros((B, H, S, hd + 1), dtype=q.dtype)[..., :hd]


@pytest.mark.parametrize("mutate,match", [
    (lambda q, k, v: (q[..., :24], k[..., :24], v[..., :24]), "head_dim"),
    (lambda q, k, v: (q.half(), k.half(), v.half()), "one of"),
    (lambda q, k, v: (q, k.float(), v), "float32"),
    (lambda q, k, v: (q.transpose(2, 3), k, v), "contiguous"),
    (lambda q, k, v: (q[0], k, v), "4 dims"),
    (lambda q, k, v: (q, k[:, :, :-1], v), "shape"),
    (lambda q, k, v: (q[:, :3], k, v), "multiple"),
    (lambda q, k, v: (_shifted(q), k, v), "16 bytes"),
    (lambda q, k, v: (q, k, _odd_stride(v)), "16 bytes"),
])
def test_flash_plan_refuses_what_no_instance_takes(mutate, match):
    q, k, v = mutate(*_qkv(1, 4, 2, 40, 40, 64, torch.bfloat16))
    with pytest.raises(ValueError, match=match):
        flash_attention.plan(q, k, v)


def test_flash_plan_alignment_binds_bf16_only():
    """The f32 instance loads element by element: odd strides and offsets
    are its to take."""
    q, k, v = _qkv(1, 4, 2, 40, 40, 64, torch.float32)
    assert flash_attention.plan(_shifted(q), k, _odd_stride(v)) == \
        flash_attention.CUDA_CORE
    with pytest.raises(ValueError, match="window"):
        flash_attention.plan(q, k, v, window=-1)


@pytest.mark.parametrize("N,lanes", [
    (1, (1, 1)), (2, (1, 2)), (3, (2, 2)), (5, (4, 2)), (8, (4, 2)),
    (16, (8, 2)), (17, (16, 2)), (32, (16, 2)), (33, (32, 2)),
    (64, (32, 2))])
def test_ssm_plan_splits_the_state_over_lanes(N, lanes):
    a = torch_args(ssm_inputs(2, 3, 5, N, 9))
    assert ssm_scan.lanes_for(N) == lanes == ssm_scan.plan(*a)


@pytest.mark.parametrize("mutate,match", [
    (lambda a: (a[0].double(),) + a[1:], "float32"),
    (lambda a: a[:1] + (a[1][:, :-1],) + a[2:], "shape"),
    (lambda a: a[:3] + (a[3].transpose(1, 2).contiguous().transpose(1, 2),)
     + a[4:], "contiguous"),
])
def test_ssm_plan_refuses_bad_inputs(mutate, match):
    with pytest.raises(ValueError, match=match):
        ssm_scan.plan(*mutate(torch_args(ssm_inputs(1, 4, 8, 4, 1))))


def test_ssm_plan_refuses_a_state_past_the_registers():
    with pytest.raises(ValueError, match="N <= 64"):
        ssm_scan.plan(*torch_args(ssm_inputs(1, 4, 8, 65, 1)))
