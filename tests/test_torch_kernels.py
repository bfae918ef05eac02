"""The port's kernels: the plain PyTorch versions (what the CPU engine runs
and what the CUDA kernels are held against on the card) against the JAX
package's jnp oracles and its Pallas kernels in interpret mode; dispatch and
launch counting.  The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: new_busy, done mask, candidate and histograms exact (values are
drawn away from bin edges: a 1-ulp difference between two ``log``
implementations can move an edge value by one bin, which the edge test
allows with that reason); energy and busy_seconds within 1 ulp, since XLA
may contract ``e + p*dt`` into an FMA."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dcsim_step import dcsim_advance as pallas_advance
from repro.kernels.telemetry_bin import telemetry_accum as pallas_accum
from repro_torch.kernels import dcsim_step, ops, ref, telemetry_bin

from torch_kernel_inputs import dcsim_inputs, tb_inputs, torch_args


def _jax_args(np_args):
    return tuple(jnp.asarray(a) if isinstance(a, (np.ndarray, np.generic))
                 else a for a in np_args)


def _ulps(got, exp):
    got, exp = np.float32(got), np.float32(exp)
    up = np.spacing(np.abs(exp))
    return float(np.max(np.abs(got - exp) / up))


def _assert_advance(got, exp, ctx):
    names = ("new_busy", "done", "energy", "busy_seconds", "candidate")
    for name, g, e in zip(names, got, exp):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        e = np.asarray(e)
        if name in ("energy", "busy_seconds"):
            assert _ulps(g, e) <= 1.0, f"{ctx}: {name}"
        else:
            np.testing.assert_array_equal(g.astype(e.dtype), e,
                                          err_msg=f"{ctx}: {name}")


@pytest.mark.parametrize("n,c,seed", [
    (1, 1, 0), (3, 2, 1), (17, 4, 2), (255, 4, 3), (257, 3, 4), (1000, 4, 5),
])
@pytest.mark.parametrize("throttled", [True, False])
def test_dcsim_plain_matches_jax_ref_and_pallas(n, c, seed, throttled):
    """Ragged N, all six server states, throttling on/off: the port's plain
    advance equals the jnp oracle and the Pallas kernel (interpret)."""
    a = dcsim_inputs(n, c, seed, throttled)
    got = ref.dcsim_advance_reference(*torch_args(a),
                                      throttle_power_scale=0.6)
    ja = _jax_args(a)
    exp_ref = jref.dcsim_advance_reference(*ja, throttle_power_scale=0.6)
    _assert_advance(got, exp_ref, "vs repro.kernels.ref")
    exp_pl = pallas_advance(*ja[:9], ja[9], ja[10], ja[11], ja[12],
                            throttle_power_scale=0.6, interpret=True)
    _assert_advance(got, exp_pl, "vs Pallas interpret")
    assert set(np.unique(a[1])) == set(range(6)) or n < 50


def test_dcsim_plain_defaults_and_f64_clock():
    """Missing wake/idle/tau/throttle inputs mean INF/0/INF/off, and an f64
    clock keeps f64 times on the CPU while energy stays f32."""
    a = dcsim_inputs(64, 4, 9, throttled=False)
    ta = torch_args(a)
    got = ref.dcsim_advance_reference(*ta[:9])
    exp = jref.dcsim_advance_reference(*_jax_args(a)[:9])
    _assert_advance(got, exp, "defaults")
    busy64 = ta[0].double()
    nb, done, en, bs, cand = ref.dcsim_advance_reference(
        busy64, ta[1], ta[2], ta[3], ta[4].double(), ta[5].double(),
        *ta[6:12])
    assert nb.dtype == torch.float64 and cand.dtype == torch.float64
    assert en.dtype == torch.float32
    np.testing.assert_array_equal(nb.float().numpy(), got[0].numpy())
    np.testing.assert_array_equal(en.numpy(), got[2].numpy())


@pytest.mark.parametrize("J,M,B,W,K", [
    (64, 64, 32, 16, 12),
    (200, 700, 64, 1, 19),       # the engine's shape: dummy one-row window
    (1024, 100, 128, 8, 12),     # job stream longer than task stream
    (600, 1800, 64, 256, 19),    # J != J*T (T = 3)
])
def test_telemetry_plain_matches_jax_ref_and_pallas(J, M, B, W, K):
    a = tb_inputs(J, M, B, W, K, seed=J + M)
    got = ref.telemetry_accum_reference(*torch_args(a))
    ja = _jax_args(a)
    exp_ref = jref.telemetry_accum_reference(*ja)
    exp_pl = pallas_accum(*ja, block=256, interpret=True)
    for name, g, e1, e2 in zip(("job_hist", "task_hist", "win"), got,
                               exp_ref, exp_pl):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e1),
                                      err_msg=f"{name} vs jnp oracle")
        np.testing.assert_array_equal(g.numpy(), np.asarray(e2),
                                      err_msg=f"{name} vs Pallas")


def test_telemetry_bin_edges_within_one_bin():
    """Values on (and one ulp either side of) every bin edge.  The port's
    ``log`` and XLA's may differ by an ulp, which moves an edge value by at
    most one bin -- so bins agree within +-1 and the mass is conserved."""
    lo, hi, B = 1e-5, 1e3, 64
    edges = lo * (hi / lo) ** (np.arange(B + 1) / B)
    v = np.concatenate([edges, np.nextafter(edges, 0),
                        np.nextafter(edges, np.inf)]).astype(np.float32)
    got = ref.log_bin(torch.from_numpy(v), lo, hi, B).numpy()
    exp = np.asarray(jref.log_bin(jnp.asarray(v), lo, hi, B))
    assert np.abs(got - exp).max() <= 1
    assert got.min() >= 0 and got.max() <= B - 1
    w = np.ones_like(v)
    z = np.zeros((B,), np.float32)
    jh, _, _ = ref.telemetry_accum_reference(
        torch.from_numpy(v), torch.from_numpy(w), torch.zeros(1),
        torch.zeros(1), torch.from_numpy(z), torch.from_numpy(z),
        torch.zeros((1, 3)), torch.zeros((), dtype=torch.int32),
        torch.zeros(3), lo, hi)
    assert float(jh.sum()) == len(v)


def test_telemetry_plain_clamps_and_drops_out_of_range_window():
    """Out-of-range latencies clamp into the edge bins; an out-of-range
    window index adds nothing (the reference's drop semantics)."""
    B, K, W = 16, 12, 4
    vals = torch.tensor([1e-9, 1e-5, 0.5, 1e3, 1e7])
    z = torch.zeros(B)
    win = torch.ones((W, K))
    jh, _, w = ref.telemetry_accum_reference(
        vals, torch.ones(5), torch.zeros(1), torch.zeros(1), z, z, win,
        torch.tensor(W, dtype=torch.int32), torch.ones(K), 1e-5, 1e3)
    assert float(jh.sum()) == 5.0
    assert float(jh[0]) >= 2.0 and float(jh[-1]) >= 2.0
    assert torch.equal(w, win)


def test_ops_dispatch_cpu_to_plain_and_counts_nothing():
    ops.reset_launch_counts()
    a = torch_args(dcsim_inputs(40, 4, 1))
    got = ops.dcsim_advance(*a, throttle_power_scale=0.6)
    exp = ref.dcsim_advance_reference(*a, throttle_power_scale=0.6)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    t = torch_args(tb_inputs(50, 50, 64, 1, 19, 3))
    for g, e in zip(ops.telemetry_accum(*t),
                    ref.telemetry_accum_reference(*t)):
        assert torch.equal(g, e)
    assert ops.launch_counts() == {"dcsim_advance": 0, "telemetry_accum": 0,
                                   "flash_attention": 0, "ssm_scan": 0}
    # a device with no kernel never runs one: only the CPU (the plain
    # version), CUDA (the kernel) and Meta (the op's fake implementation,
    # shapes only) have one, and the fake refuses inputs on more than one
    # device
    for op in ("dcsim_advance", "telemetry_accum"):
        assert [torch._C._dispatch_has_kernel_for_dispatch_key(
            f"repro_torch::{op}", key) for key in
            ("CPU", "CUDA", "Meta", "XPU", "MPS")] == [True] * 3 + [False] * 2
    with pytest.raises(ValueError, match="more than one device"):
        ops.dcsim_advance(a[0].to("meta"), *a[1:])
    meta = ops.dcsim_advance(*[x.to("meta") if torch.is_tensor(x) else x
                               for x in a])
    assert [(m.shape, m.dtype) for m in meta] == \
        [(e.shape, e.dtype) for e in exp]
    assert sum(ops.launch_counts().values()) == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers check device, dtype and shape before they build
    or launch anything."""
    a = torch_args(dcsim_inputs(8, 4, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dcsim_step.dcsim_advance(*a)
    t = torch_args(tb_inputs(8, 8, 64, 1, 19, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        telemetry_bin.telemetry_accum(*t)


@pytest.mark.parametrize("N", [1, 255, 256, 257, 1000, 65_535, 65_536,
                               65_537, 135_168, 135_169, 1_000_003])
@pytest.mark.parametrize("sms", [132, 2])
def test_dcsim_plan_covers_every_server(N, sms):
    """One server a thread up to the cap of BLOCKS_PER_SM blocks an SM,
    then a grid-stride loop: grid x block x per_thread covers N and no
    block is left without a server.  The reduction's scratch is the same
    two words (ticket, minimum) for every N and grid."""
    p = dcsim_step.plan(N, 4, sms=sms)
    cap = dcsim_step.BLOCKS_PER_SM * sms
    assert p.block == dcsim_step.THREADS == 256
    assert p.grid == min(-(-N // p.block), cap)
    assert (p.grid - 1) * p.block < N                  # no empty block
    # one server a thread unless the grid is at its cap; the grid-stride
    # loop then takes ceil(N / threads) servers a thread
    assert p.grid * p.block >= N or p.grid == cap
    per_thread = -(-N // (p.grid * p.block))
    assert p.grid * p.block * per_thread >= N
    assert p.scratch == dcsim_step.SCRATCH_WORDS == 2
    assert p.vec4


def test_dcsim_plan_at_the_main_shape_is_one_wave():
    """65,536 x 4 on 132 SMs: 256 blocks of 256 threads, one server each,
    all resident at once."""
    p = dcsim_step.plan(65_536, 4)
    assert (p.grid, p.block, p.vec4) == (256, 256, True)
    assert p.grid * p.block == 65_536


@pytest.mark.parametrize("C,aligned,vec4", [(4, True, True),
                                            (4, False, False),
                                            (3, True, False),
                                            (8, True, False)])
def test_dcsim_plan_takes_float4_rows_only_when_it_can(C, aligned, vec4):
    assert dcsim_step.plan(100, C, aligned=aligned).vec4 is vec4


@pytest.mark.parametrize("N,C,match", [(0, 4, "N, C >= 1"),
                                       (5, 0, "N, C >= 1"),
                                       (2**29, 4, "32-bit")])
def test_dcsim_plan_refuses_what_it_cannot_take(N, C, match):
    with pytest.raises(ValueError, match=match):
        dcsim_step.plan(N, C)


@pytest.mark.parametrize("J,M", [(0, 0), (600, 600), (600, 1800),
                                 (1024, 1024), (1024, 1), (1025, 1024),
                                 (1, 1025), (100_003, 300_009),
                                 (10_000_000, 10)])
@pytest.mark.parametrize("B", [64, 128])
def test_telemetry_plan_paths_and_grid(J, M, B):
    """Streams of at most SMALL_MAX values (one a thread) take the
    one-block path with no scratch; longer ones take the cross-block path
    with at most one block an SM, a grid that covers the longer stream,
    and 2B partial bins a block."""
    p = telemetry_bin.plan(J, M, B, 1, 19)
    n = max(J, M)
    assert telemetry_bin.SMALL_MAX == telemetry_bin.THREADS == 1024
    assert p.block == telemetry_bin.THREADS
    assert p.smem == 4 * B * 4              # float parts and counts
    chunk = p.block
    if n <= telemetry_bin.SMALL_MAX:
        assert (p.path, p.grid, p.scratch) == ("small", 1, 0)
    else:
        assert p.path == "large"
        assert 2 <= p.grid <= 132
        assert p.grid == min(-(-n // chunk), 132)
        assert (p.grid - 1) * chunk < n                # no empty block
        assert p.scratch == p.grid * 2 * B


def test_telemetry_plan_switches_at_the_boundary():
    small = telemetry_bin.SMALL_MAX
    assert telemetry_bin.plan(small, small, 64, 1, 19).path == "small"
    assert telemetry_bin.plan(small + 1, 0, 64, 1, 19).path == "large"
    assert telemetry_bin.plan(0, small + 1, 64, 1, 19).path == "large"
    assert telemetry_bin.plan(small + 1, 1, 64, 1, 19).grid == 2


@pytest.mark.parametrize("args,match", [
    ((10, 10, 0, 1, 19), "B >= 1"),
    ((-1, 10, 64, 1, 19), ">= 0"),
    ((10, 10, 64, -1, 19), ">= 0"),
    ((10, 10, 2**16, 1, 19), "shared memory"),
    ((10, 10, 2816, 1, 19), "shared memory"),
    ((10, 10, 64, 2**16, 2**16), "32-bit"),
])
def test_telemetry_plan_refuses_what_no_path_takes(args, match):
    with pytest.raises(ValueError, match=match):
        telemetry_bin.plan(*args)


def test_telemetry_plan_takes_the_most_bins_the_shared_memory_holds():
    most = telemetry_bin.SMEM_LIMIT // 16
    assert telemetry_bin.plan(10, 10, most, 1, 19).smem == 16 * most
    with pytest.raises(ValueError, match="shared memory"):
        telemetry_bin.plan(10, 10, most + 1, 1, 19)


# --------------------------------------------------------------------------
# the replica axis: the plain versions with a leading R, against jax.vmap of
# the jnp oracles and of the Pallas kernels (interpret)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,seed", [(1, 1, 0), (17, 4, 2), (257, 3, 4)])
def test_dcsim_plain_batched_matches_vmap(n, c, seed):
    """R = 3 farms, ragged N, replica 1 all INF (an empty farm: its
    candidate is INF): the batched plain advance equals jax.vmap of the
    jnp oracle and of the Pallas kernel, and replica by replica the
    unbatched plain advance."""
    import jax
    from torch_kernel_inputs import dcsim_inputs_batched
    a = dcsim_inputs_batched(3, n, c, seed, inf_replica=1)
    got = ref.dcsim_advance_reference(*torch_args(a),
                                      throttle_power_scale=0.6)
    ja = _jax_args(a)
    per = (0, 1, 2, 3, 4, 5, 9, 10, 11, 12)

    def vm(fn, **kw):
        def one(*xs):
            full = list(ja)
            for i, x in zip(per, xs):
                full[i] = x
            return fn(*full, throttle_power_scale=0.6, **kw)
        return jax.vmap(one)(*(ja[i] for i in per))

    _assert_advance(got, vm(jref.dcsim_advance_reference), "vs vmap(ref)")
    _assert_advance(got, vm(pallas_advance, interpret=True),
                    "vs vmap(Pallas interpret)")
    assert float(got[4][1]) == float(np.float32(ref.INF))
    ta = torch_args(a)
    for r in range(3):
        one = ref.dcsim_advance_reference(
            *(x[r] if i in per else x for i, x in enumerate(ta)),
            throttle_power_scale=0.6)
        for g, e in zip(got, one):
            assert torch.equal(g[r], e)


@pytest.mark.parametrize("J,M,W", [(64, 64, 16), (200, 700, 1),
                                   (600, 1800, 256)])
def test_telemetry_plain_batched_matches_vmap(J, M, W):
    """R = 3 replicas' streams: each bins into its own histograms and
    window row, equal to jax.vmap of the jnp oracle and of the Pallas
    kernel, and replica by replica to the unbatched plain version."""
    import jax
    from torch_kernel_inputs import tb_inputs_batched
    a = tb_inputs_batched(3, J, M, 64, W, 19, seed=J + M)
    got = ref.telemetry_accum_reference(*torch_args(a))
    ja = _jax_args(a)
    lo, hi = a[9], a[10]
    exp_ref = jax.vmap(lambda *x: jref.telemetry_accum_reference(
        *x, lo, hi))(*ja[:9])
    exp_pl = jax.vmap(lambda *x: pallas_accum(*x, lo, hi, block=256,
                                              interpret=True))(*ja[:9])
    for name, g, e1, e2 in zip(("job_hist", "task_hist", "win"), got,
                               exp_ref, exp_pl):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e1),
                                      err_msg=f"{name} vs vmap(oracle)")
        np.testing.assert_array_equal(g.numpy(), np.asarray(e2),
                                      err_msg=f"{name} vs vmap(Pallas)")
    ta = torch_args(a)
    for r in range(3):
        one = ref.telemetry_accum_reference(*(x[r] for x in ta[:9]), lo, hi)
        for g, e in zip(got, one):
            assert torch.equal(g[r], e)


@pytest.mark.parametrize("R", [1, 3, 1024, 65_535])
def test_batched_plans_launch_once_whatever_R(R):
    """One launch a call whatever R: the replica is the grid's y extent;
    each replica keeps at least one block, the total stays near the
    single farm's cap, and the scratch is a pair of words (advance) or a
    ticket (binning) a replica."""
    p = dcsim_step.plan(16, 4, replicas=R)
    assert (p.replicas, p.grid, p.scratch) == (R, 1, 2 * R)
    big = dcsim_step.plan(65_536, 4, replicas=R)
    cap = dcsim_step.BLOCKS_PER_SM * 132
    assert big.grid == min(256, max(cap // R, 1))
    t = telemetry_bin.plan(128, 128, 64, 1, 19, replicas=R)
    assert (t.path, t.grid, t.scratch, t.replicas) == ("small", 1, 0, R)
    # a batch's one-block launch is as wide as its streams, one stream
    # set's keeps THREADS
    assert t.block == (telemetry_bin.THREADS if R == 1 else 128)
    assert telemetry_bin.plan(600, 300, 64, 1, 19, replicas=R).block == \
        (telemetry_bin.THREADS if R == 1 else 608)
    t = telemetry_bin.plan(100_003, 300_009, 64, 256, 19, replicas=R)
    assert t.grid == min(-(-300_009 // 1024), max(132 // R, 1))
    assert t.path == ("large" if t.grid > 1 else "small")
    assert t.scratch == (R * t.grid * 128 if t.grid > 1 else 0)


def test_batched_plans_refuse_too_many_replicas():
    with pytest.raises(ValueError, match="replicas"):
        dcsim_step.plan(16, 4, replicas=65_536)
    with pytest.raises(ValueError, match="replicas"):
        telemetry_bin.plan(16, 16, 64, 1, 19, replicas=0)
