"""The port on the card: each CUDA kernel against its plain PyTorch version
on the same inputs, the dispatch's launch counting, and the engine on the
card against the engine on the CPU (with an f64 clock, and the thermal
subsystem with its control plane).  Every test here needs an NVIDIA GPU
and skips without one; the file imports no JAX, so it runs on a machine
with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the engine's kernels repeat the plain versions' roundings
operation by operation, and the histogram weights are 0/1 (exact integer
sums in any order), so every output is bitwise equal.  Engine runs:
discrete state exact, float reductions (energy, residency, windows) rtol
1e-5, since PyTorch sums in another order on the card.  Attention: 2e-5
in float32 and 2e-2 in bfloat16 (tests/test_kernels.py's tolerances; the
kernel sums q.k and p.v in its own order).  SSM scan: y and h within
rtol/atol 1e-5 (the sum over the state runs in another order).  Network
functions: integer and boolean leaves exact, elementwise floats bitwise
(IEEE division and the fused multiply-adds computed in float64 on both),
the switch power and what accrues from it rtol 1e-5 (a sum over ports).
The flight recorder's ring: exact, card against CPU (its flush is
elementwise work, a cumsum of integers and one scatter to distinct
slots).  Rack-sharded runs (one rank over NCCL; two ranks over NCCL on
two cards, else over gloo on one): bitwise equal to engine.run on the
card.  MoE (models/moe.py): the routes equal, or a differing one only at
a near-tie (the CPU's gap under torch_kernel_inputs.ROUTE_GAP, the route
flip rule); with equal routes, dropped equal, the layer's output within
1e-5 in float32 and 2e-2 in bfloat16 and aux rel 1e-5.  Recurrent
mixers (models/ssm.py): the mLSTM and sLSTM at 1,100 tokens within 1e-3
in float32 (their products add in another order); smoke xLSTM and mamba
generate, the same greedy tokens.  The encoder-decoder: smoke whisper's
serve steps with 37 frames, logits within 1e-3 in float32 and the same
greedy tokens, the attention through the kernel in every mode.  Training:
the attention's backward within 2e-2 of each output's largest magnitude
in bfloat16 and 1e-4 in float32, the scan's within 1e-4 (the kernel sums
over the state, channels, batch and time in its own fixed order), two
calls of each bit-equal; a smoke train step card against CPU, loss and
grad_norm rel 1e-5, parameters 1e-4, and a bf16 one on the attention
backward's tensor-core instance."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (engine, farm, jobs, network, power, server,
                              topology, trace, traceio, types, workload)
from repro_torch.core.types import (SchedPolicy, SimConfig, SleepPolicy,
                                    SrvState, ThermalConfig, TraceConfig,
                                    TraceKind, tree_leaves)
from repro_torch.kernels import (dcsim_step, flash_attention, ops, ref,
                                 ssm_scan, telemetry_bin)

from torch_kernel_inputs import (FLASH_TC_EDGES, SSM_EDGES, dcsim_inputs,
                                 edge_inputs, flash_inputs, graph_ops,
                                 net_inputs, recorded_routes, route_flips,
                                 ssm_inputs, star_scenario, tb_inputs,
                                 thermal_main_scenario, torch_args)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels build and run only there.
    Decided when the test runs, never at import, so every test worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels are built with "
                    "nvcc and run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,c,throttled", [
    (65536, 4, True), (1000, 4, True), (1000, 3, False), (1, 1, True),
    (257, 8, False), (1, 4, True), (255, 4, False), (257, 4, True),
    (65537, 4, True), (65537, 3, False)])
def test_dcsim_advance_matches_plain(cuda, n, c, throttled):
    a = torch_args(dcsim_inputs(n, c, 7, throttled), cuda)
    before = dcsim_step.LAUNCHES
    got = dcsim_step.dcsim_advance(*a, throttle_power_scale=0.6)
    exp = ref.dcsim_advance_reference(*a, throttle_power_scale=0.6)
    torch.cuda.synchronize()
    assert dcsim_step.LAUNCHES == before + 1
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype and torch.equal(g, e)


def test_dcsim_advance_default_inputs(cuda):
    """No wake/idle/tau/throttle tensors: INF/0/INF/not throttled."""
    a = torch_args(dcsim_inputs(300, 4, 8, False), cuda)[:9]
    for g, e in zip(dcsim_step.dcsim_advance(*a),
                    ref.dcsim_advance_reference(*a)):
        assert torch.equal(g, e)


@pytest.mark.parametrize("J,M,W", [(600, 600, 1), (100_003, 300_009, 256),
                                   (7, 21, 4),
                                   # the two paths' boundary (SMALL_MAX)
                                   (1024, 1024, 2), (1025, 1025, 3),
                                   (1, 1025, 1), (0, 5000, 2)])
def test_telemetry_accum_matches_plain(cuda, J, M, W):
    a = torch_args(tb_inputs(J, M, 64, W, 19, 11), cuda)
    before = telemetry_bin.LAUNCHES
    got = telemetry_bin.telemetry_accum(*a)
    exp = ref.telemetry_accum_reference(*a)
    torch.cuda.synchronize()
    assert telemetry_bin.LAUNCHES == before + 1
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert torch.equal(a[4], torch_args(tb_inputs(J, M, 64, W, 19, 11),
                                        cuda)[4])       # inputs untouched


@pytest.mark.parametrize("per_edge", [16, 2000])
def test_telemetry_accum_near_bin_edges_matches_plain(cuda, per_edge):
    """Values within +-3e-7 relative of every inner bin edge, where
    ``max(v, lo) * fl(1/lo)`` (the kernel's inv_lo, as the reference's
    compiled step computes the division) and a true division bin
    differently: the kernel equals its plain version on both paths."""
    lo, hi, B = 1e-5, 1e3, 64
    rng = np.random.default_rng(per_edge)
    edges = lo * (hi / lo) ** (np.arange(1, B) / B)
    v = (edges[:, None] * (1 + rng.uniform(-3e-7, 3e-7, (B - 1, per_edge)))
         ).astype(np.float32).ravel()
    n = v.shape[0]
    z = np.zeros(B, np.float32)
    a = torch_args((v, np.ones(n, np.float32), v[::-1].copy(),
                    np.ones(n, np.float32), z, z, np.zeros((2, 3), np.float32),
                    np.int32(0), np.ones(3, np.float32), lo, hi), cuda)
    got = telemetry_bin.telemetry_accum(*a)
    exp = ref.telemetry_accum_reference(*a)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert float(got[0].sum()) == n
    # the reciprocal and the division put some of these values in
    # different bins, so this input tells the two apart
    vt = a[0]
    lo_t = torch.tensor(lo, dtype=torch.float32, device=cuda)
    div = torch.log(torch.maximum(vt, lo_t) / lo_t)
    mul = torch.log(torch.maximum(vt, lo_t) * ref.inv_f32(lo))
    assert (div != mul).any()


@pytest.mark.parametrize("J,M,W", [(600, 600, 1), (100_003, 300_009, 256)])
def test_telemetry_accum_takes_weights_other_than_one(cuda, J, M, W):
    """Weights of 0.5 and 2 take the float atomics, weights of 1 the
    integer counts, on both paths; dyadic sums are exact in any order."""
    a = torch_args(tb_inputs(J, M, 64, W, 19, 13, unit=False), cuda)
    assert set(torch.unique(a[3]).tolist()) == {0.0, 0.5, 1.0, 2.0}
    for g, e in zip(telemetry_bin.telemetry_accum(*a),
                    ref.telemetry_accum_reference(*a)):
        assert torch.equal(g, e)


def _dcsim_call(a):
    return dcsim_step.dcsim_advance(*a, throttle_power_scale=0.6)


def _engine_call(kind, dev, seed=11):
    """(call, inputs) of one engine kernel at a main path's shape: the
    advance at 65,536 x 4, the binning at the engine's J = J*T = 600 (the
    one-block path) and at the check case 100,003 / 300,009 (the
    cross-block path)."""
    if kind == "dcsim_advance":
        return _dcsim_call, torch_args(dcsim_inputs(65536, 4, seed), dev)
    J, M, W = {"telemetry_small": (600, 600, 1),
               "telemetry_large": (100_003, 300_009, 256)}[kind]
    return (lambda a: telemetry_bin.telemetry_accum(*a),
            torch_args(tb_inputs(J, M, 64, W, 19, seed), dev))


ENGINE_CALLS = ["dcsim_advance", "telemetry_small", "telemetry_large"]


@pytest.mark.parametrize("kind", ENGINE_CALLS)
def test_engine_kernels_issue_one_device_op_per_call(cuda, kind):
    """No copy, fill or second pass around the kernel: each call is one
    device operation, the kernel itself."""
    call, a = _engine_call(kind, cuda)
    # counted in a CUDA graph of one call: the profiler loses records
    ops_seen = graph_ops(lambda: call(a))
    assert sum(ops_seen.values()) == 1, ops_seen
    assert not set(ops_seen) & {"memcpy", "memset"}, ops_seen


@pytest.mark.parametrize("kind", ENGINE_CALLS)
def test_engine_kernels_leave_inputs_and_own_their_outputs(cuda, kind):
    call, a = _engine_call(kind, cuda)
    before = [x.clone() if torch.is_tensor(x) else x for x in a]
    got = call(a)
    torch.cuda.synchronize()
    for x, b in zip(a, before):
        if torch.is_tensor(x):
            assert torch.equal(x, b)
    spans = [(x.untyped_storage().data_ptr(),
              x.untyped_storage().data_ptr() + x.untyped_storage().nbytes())
             for x in a if torch.is_tensor(x)]
    for g in got:
        lo = g.untyped_storage().data_ptr()
        hi = lo + g.untyped_storage().nbytes()
        assert all(hi <= s or lo >= e for s, e in spans)


@pytest.mark.parametrize("kind", ENGINE_CALLS)
def test_engine_kernels_ten_calls_in_a_row_agree(cuda, kind):
    """The in-kernel reduction's scratch returns to its empty state after
    every launch: ten calls on the same inputs (each output kept, so no
    call can find the last one's result in reused memory) are bitwise
    equal to each other and to the plain version, and the scratch reads
    empty after them (ticket 0; the advance's minimum word all bits
    set)."""
    call, a = _engine_call(kind, cuda)
    outs = [call(a) for _ in range(10)]
    exp = (ref.dcsim_advance_reference(*a, throttle_power_scale=0.6)
           if kind == "dcsim_advance" else ref.telemetry_accum_reference(*a))
    torch.cuda.synchronize()
    for out in outs:
        for g, e in zip(out, exp):
            assert torch.equal(g, e)
    if kind == "dcsim_advance":               # ticket 0, minimum empty
        assert dcsim_step.scratch(cuda).tolist() == [0, -1]
    if kind == "telemetry_large":
        assert int(telemetry_bin.scratch(cuda, 64)[1]) == 0


@pytest.mark.parametrize("kind", ENGINE_CALLS)
def test_engine_kernels_replay_in_a_cuda_graph(cuda, kind):
    """One call captured with torch.cuda.graph and replayed on new inputs
    copied into the captured ones equals the eager call on those inputs,
    bit for bit."""
    call, static = _engine_call(kind, cuda, seed=11)
    _, fresh = _engine_call(kind, cuda, seed=12)
    call(static)                             # scratch made before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call(static)
    for s, f in zip(static, fresh):
        if torch.is_tensor(s):
            s.copy_(f)
    graph.replay()
    eager = call(fresh)
    torch.cuda.synchronize()
    for g, e in zip(captured, eager):
        assert torch.equal(g, e)


def test_wrappers_check_their_inputs(cuda):
    a = list(torch_args(dcsim_inputs(64, 4, 1), cuda))
    with pytest.raises(ValueError, match="float32"):      # a mix of clocks
        dcsim_step.dcsim_advance(a[0].double(), *a[1:])
    with pytest.raises(ValueError, match="float32 or float64"):
        dcsim_step.dcsim_advance(a[0].half(), *a[1:])
    with pytest.raises(ValueError, match="contiguous"):
        dcsim_step.dcsim_advance(a[0].t().contiguous().t(), *a[1:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        dcsim_step.dcsim_advance(a[0], a[1].cpu(), *a[2:])
    t = list(torch_args(tb_inputs(16, 16, 64, 1, 19, 2), cuda))
    with pytest.raises(ValueError, match="shape"):
        telemetry_bin.telemetry_accum(t[0], t[1][:-1], *t[2:])


def test_ops_routes_cuda_tensors_to_the_kernels(cuda):
    ops.reset_launch_counts()
    a = torch_args(dcsim_inputs(128, 4, 3), cuda)
    ops.dcsim_advance(*a)
    ops.telemetry_accum(*torch_args(tb_inputs(32, 32, 64, 1, 19, 4), cuda))
    assert ops.launch_counts() == {"dcsim_advance": 1, "telemetry_accum": 1,
                                   "flash_attention": 0, "ssm_scan": 0}


FLASH_CASES = [   # B, H, KV, Sq, Skv, hd, causal, window, softcap, dtype
    (4, 25, 5, 1536, 1536, 64, True, 1024, 0.0, torch.bfloat16),  # hymba
    (2, 25, 5, 1000, 1000, 64, True, 1024, 0.0, torch.bfloat16),
    (1, 4, 4, 300, 300, 128, True, 0, 50.0, torch.bfloat16),
    (1, 4, 2, 200, 330, 32, False, 0, 0.0, torch.float32),
    (2, 4, 2, 260, 260, 128, True, 64, 0.0, torch.float32),
    (1, 2, 1, 300, 90, 16, True, 40, 0.0, torch.float32),   # empty rows
    (1, 2, 2, 129, 129, 256, True, 0, 30.0, torch.bfloat16),
    # the encoder-decoder's and chameleon's shapes, batch and length cut:
    # whisper's encoder (bidirectional over 1,500 frames), its
    # cross-attention in prefill and in decode, chameleon's GQA 64/8
    (1, 20, 20, 1500, 1500, 64, False, 0, 0.0, torch.bfloat16),
    (1, 20, 20, 224, 1500, 64, False, 0, 0.0, torch.bfloat16),
    (2, 20, 20, 1, 1500, 64, False, 0, 0.0, torch.bfloat16),
    (1, 64, 8, 512, 512, 128, True, 0, 0.0, torch.bfloat16),
] + [case + (torch.bfloat16,) for case in FLASH_TC_EDGES]


def _flash_args(case, dev, model_layout):
    B, H, KV, Sq, Skv, hd, causal, window, cap, dtype = case
    q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in
               flash_inputs(B, H, KV, Sq, Skv, hd, 21))
    if model_layout:          # (B, S, H, hd) storage seen as (B, H, S, hd)
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    return (q, k, v), dict(causal=causal, window=window, softcap=cap)


@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case, model_layout):
    args, kw = _flash_args(case, cuda, model_layout)
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_attention(*args, **kw)
    exp = ref.mha_reference(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    assert got.shape == exp.shape and got.dtype == exp.dtype
    assert got.stride() == args[0].stride()
    tol = 2e-2 if case[-1] == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,Dss,N", [(4, 1536, 3200, 16), (3, 37, 200, 16),
                                       (2, 70, 100, 8), (1, 5, 3, 40)]
                         + SSM_EDGES)
def test_ssm_scan_matches_plain(cuda, B, S, Dss, N):
    a = torch_args(ssm_inputs(B, S, Dss, N, 23), cuda)
    before = ssm_scan.LAUNCHES
    y, h = ssm_scan.ssm_scan(*a)
    ye, he = ref.ssm_scan_reference(*a)
    torch.cuda.synchronize()
    assert ssm_scan.LAUNCHES == before + 1
    torch.testing.assert_close(y, ye, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, he, atol=1e-5, rtol=1e-5)


def test_lm_wrappers_check_their_inputs(cuda):
    (q, k, v), _ = _flash_args(FLASH_CASES[3], cuda, False)
    with pytest.raises(ValueError, match="float32"):
        flash_attention.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(q[..., :24], k[..., :24],
                                        v[..., :24])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(2, 3), k, v)
    a = list(torch_args(ssm_inputs(1, 4, 8, 4, 1), cuda))
    with pytest.raises(ValueError, match="float32"):
        ssm_scan.ssm_scan(a[0].double(), *a[1:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssm_scan.ssm_scan(*a[:4], a[4].cpu())


def test_flash_attention_reports_its_instance(cuda):
    """bf16 runs on the tensor cores, f32 on the CUDA cores; the wrapper
    counts each and names the latest."""
    before = dict(flash_attention.INSTANCE_LAUNCHES)
    for case, inst in ((FLASH_CASES[1], flash_attention.TENSOR_CORE),
                       (FLASH_CASES[3], flash_attention.CUDA_CORE)):
        args, kw = _flash_args(case, cuda, True)
        flash_attention.flash_attention(*args, **kw)
        assert flash_attention.LAST_INSTANCE == inst
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in
            flash_attention.INSTANCE_LAUNCHES.items()} == {
        flash_attention.TENSOR_CORE: 1, flash_attention.CUDA_CORE: 1}


def test_flash_bf16_refuses_what_its_instance_cannot_take(cuda):
    """A bf16 call the tensor-core instance cannot take raises; it never
    runs on the f32 instance."""
    (q, k, v), _ = _flash_args(FLASH_TC_EDGES[0] + (torch.bfloat16,), cuda,
                               False)
    launches = flash_attention.LAUNCHES
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(q[..., :24], k[..., :24],
                                        v[..., :24])
    raw = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    shifted = raw.view(q.shape).copy_(q)          # storage offset 1
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_attention(shifted, k, v)
    wide = torch.empty(q.shape[:3] + (q.shape[3] + 1,), dtype=q.dtype,
                       device=cuda)[..., :q.shape[3]].copy_(q)  # odd stride
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_attention(wide, k, v)
    assert flash_attention.LAUNCHES == launches
    # the f32 instance loads element by element and takes that stride
    wide32 = torch.empty(wide.shape[:3] + (wide.shape[3] + 1,),
                         device=cuda)[..., :wide.shape[3]].copy_(wide)
    args = (wide32, k.float(), v.float())
    got = flash_attention.flash_attention(*args)
    assert flash_attention.LAST_INSTANCE == flash_attention.CUDA_CORE
    torch.testing.assert_close(got, ref.mha_reference(*args), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("N,instance", [(1, "lanes1x1"), (2, "lanes1x2"),
                                        (16, "lanes8x2"), (17, "lanes16x2"),
                                        (64, "lanes32x2")])
def test_ssm_scan_reports_its_lane_split(cuda, N, instance):
    ssm_scan.ssm_scan(*torch_args(ssm_inputs(1, 3, 5, N, 2), cuda))
    assert ssm_scan.LAST_INSTANCE == instance


def _scenario(n_jobs=120):
    cfg = SimConfig(n_servers=6, n_cores=2, max_jobs=128, tasks_per_job=3,
                    sched_policy=SchedPolicy.LOAD_BALANCE,
                    sleep_policy=SleepPolicy.SINGLE_TIMER,
                    sleep_state=SrvState.S3, max_events=50_000)
    rng = np.random.default_rng(13)
    arr = workload.poisson_arrivals(40.0, n_jobs, seed=6)
    specs = [jobs.dag_chain(rng.exponential(0.01, size=3))
             for _ in range(n_jobs)]
    return cfg, arr, specs


def _run(cfg, arr, specs, dev):
    jt = jobs.build_jobs(cfg, arr, specs, device=dev)
    state, tc = engine.init_state(cfg, jt)
    state.farm.srv_tau = torch.full_like(state.farm.srv_tau, 0.05)
    return engine.run(state, cfg, tc)


def test_engine_on_card_matches_cpu(cuda):
    cfg, arr, specs = _scenario()
    cpu = _run(cfg, arr, specs, "cpu")
    ops.reset_launch_counts()
    gpu = _run(cfg, arr, specs, cuda)
    counts = ops.launch_counts()
    for (path, g), (_, c) in zip(tree_leaves(gpu), tree_leaves(cpu)):
        g = g.cpu()
        if path in ("farm.energy", "farm.residency",
                    "farm.busy_core_seconds", "telem.win",
                    "telem.win_overflow"):
            assert torch.allclose(g, c, rtol=1e-5, atol=1e-6), path
        else:
            assert torch.equal(g, c), path
    assert bool(gpu.done)
    assert counts["dcsim_advance"] == int(gpu.steps) * cfg.events_per_step
    assert counts["telemetry_accum"] == int(gpu.steps)


def test_simulate_defaults_to_the_card(cuda):
    cfg, arr, specs = _scenario(20)
    res = farm.simulate(cfg, arr, specs, tau=0.05)
    assert res.run_info.backend == "cuda" and res.n_finished == 20
    assert res.run_info.device_name == torch.cuda.get_device_name(0)


def _card_equals_cpu(cfg, arr, specs, dev, tau=None, topo=None):
    """The engine run to its end on the CPU and on the card: discrete
    leaves exact, floats rtol 1e-5 (sums run in another order on the
    card); the advance launched K times a step on the card."""
    finals = {}
    for d in ("cpu", dev):
        jt = jobs.build_jobs(cfg, arr, specs, device=d)
        state, tc = engine.init_state(cfg, jt, topo)
        if tau is not None:
            state.farm.srv_tau = torch.full_like(state.farm.srv_tau, tau)
        ops.reset_launch_counts()
        finals[str(d)] = engine.run(state, cfg, tc)
    counts = dict(dcsim_step.CLOCK_LAUNCHES)
    gpu, cpu = finals[str(dev)], finals["cpu"]
    for (path, g), (_, c) in zip(tree_leaves(gpu), tree_leaves(cpu)):
        g = g.cpu()
        assert g.dtype == c.dtype and g.shape == c.shape, path
        if g.dtype.is_floating_point and path not in (
                "telem.job_hist", "telem.task_hist", "trace.buf"):
            assert torch.allclose(g, c, rtol=1e-5, atol=0.0), path
        else:
            assert torch.equal(g, c), path
    assert bool(gpu.done)
    clock = str(cfg.time_dtype).removeprefix("torch.")
    assert counts[clock] == int(gpu.steps) * cfg.events_per_step
    return gpu


def test_f64_clock_on_the_card_matches_cpu(cuda):
    """An f64 clock runs on the card through the advance kernel's float64
    instance; every clock leaf stays float64."""
    cfg, arr, specs = _scenario()
    cfg = dataclasses.replace(cfg, time_dtype=torch.float64)
    gpu = _card_equals_cpu(cfg, arr, specs, cuda, tau=0.05)
    assert gpu.t.dtype == gpu.farm.core_busy_until.dtype == torch.float64


@pytest.mark.parametrize("n,c", [(65536, 4), (1024, 4), (1000, 3), (1, 4),
                                 (257, 4), (65537, 4)])
def test_dcsim_advance_f64_matches_plain(cuda, n, c):
    """The float64 instance, exactly, around t = 86,400 s with slots a few
    microseconds either side of t_next."""
    a = torch_args(dcsim_inputs(n, c, 9, clock=np.float64), cuda)
    before = dcsim_step.CLOCK_LAUNCHES["float64"]
    got = dcsim_step.dcsim_advance(*a, throttle_power_scale=0.6)
    exp = ref.dcsim_advance_reference(*a, throttle_power_scale=0.6)
    torch.cuda.synchronize()
    assert dcsim_step.CLOCK_LAUNCHES["float64"] == before + 1
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype and torch.equal(g, e)
    assert dcsim_step.scratch(cuda, torch.float64).tolist() == [0, -1]


def test_dcsim_advance_refuses_a_mix_of_clocks(cuda):
    a = list(torch_args(dcsim_inputs(64, 4, 1, clock=np.float64), cuda))
    for i in (4, 9):                    # t, then srv_wake_at, as float32
        b = list(a)
        b[i] = b[i].float()
        with pytest.raises(ValueError, match="float64"):
            dcsim_step.dcsim_advance(*b)


@pytest.mark.parametrize("name", ["control_plane", "thermal_main"])
def test_thermal_engine_on_card_matches_cpu(cuda, name):
    """The thermal subsystem with its control plane on the card: throttle
    crossings, the setpoint controller and CARBON_AWARE deferral take the
    same events as on the CPU (the elementary functions round once from
    float64 and the rack sums add in order on both)."""
    if name == "thermal_main":
        kw, th, arr, specs = thermal_main_scenario(jobs, workload, 64, 200)
        cfg = SimConfig(**kw, thermal=ThermalConfig(**th))
        tau = None
    else:
        th = ThermalConfig(enabled=True, r_th=0.5, tau_th=2.0, rack_size=3,
                           t_setpoint=(16.0, 26.0), ambient_swing=3.0,
                           ambient_period=40.0, ctrl_period=0.5,
                           ctrl_target=55.0, ctrl_min=14.0, t_throttle=58.0,
                           t_release=52.0, throttle_power_scale=0.6,
                           carbon_period=60.0, price_period=60.0)
        cfg = SimConfig(n_servers=6, n_cores=2, max_jobs=256,
                        sleep_policy=SleepPolicy.SINGLE_TIMER,
                        sleep_state=SrvState.S3, thermal=th)
        rng = np.random.default_rng(7)
        arr = workload.poisson_arrivals(40.0, 150, seed=3)
        specs = [jobs.dag_single(rng.exponential(0.04)) for _ in range(150)]
        tau = 0.05
    gpu = _card_equals_cpu(cfg, arr, specs, cuda, tau=tau)
    assert float(gpu.thermal.throttle_seconds.sum()) > 0
    if name == "thermal_main":
        assert int(gpu.thermal.defer_count) > 0


# --------------------------------------------------------------------------
# network mode
# --------------------------------------------------------------------------

def _net_pair(topo, F, n_tasks, seed, dev, n_active=None):
    """The same random flow table and switch state on the CPU and on
    ``dev``."""
    flows, net = net_inputs(topo, F, n_tasks, seed, n_active=n_active)

    def make(d):
        return (types.FlowTable(**{k: torch.from_numpy(np.array(v)).to(d)
                                   for k, v in flows.items()}),
                types.NetState(**{k: torch.from_numpy(np.array(v)).to(d)
                                  for k, v in net.items()}))
    return make("cpu"), make(dev)


def _same(got, exp, ctx, reduced=()):
    """Every field of a port state dataclass (or a tensor) on the card
    against the CPU's."""
    if not torch.is_tensor(exp):
        for f in exp.__dataclass_fields__:
            _same(getattr(got, f), getattr(exp, f), f"{ctx}.{f}", reduced)
        return
    g = got.cpu()
    assert g.dtype == exp.dtype and g.shape == exp.shape, ctx
    if ctx.split(".")[-1] in reduced:
        assert torch.allclose(g, exp, rtol=1e-5, atol=0.0), ctx
    else:
        assert torch.equal(g, exp), ctx


@pytest.mark.parametrize("name,args", [("star", (6,)), ("fat_tree", (4,)),
                                       ("fat_tree", (16,)), ("bcube", (3,))])
def test_network_functions_on_card_match_cpu(cuda, name, args):
    topo = getattr(topology, name)(*args, link_cap=1.25e9)
    tcs = {d: network.topo_consts(topo, d) for d in ("cpu", cuda)}
    F = 1024 if topo.n_servers > 100 else 24
    for comm_model, n_active in ((0, F // 4), (1, F - 4)):
        cfg = SimConfig(n_servers=topo.n_servers, max_jobs=F,
                        tasks_per_job=2, max_flows=F, has_network=True,
                        comm_model=comm_model)
        (cf, cn), (gf, gn) = _net_pair(topo, F, cfg.n_tasks, 3, cuda,
                                       n_active)
        e = edge_inputs(topo.n_servers, cfg.n_tasks, 5, E=min(F, 512))
        now = torch.tensor(1.0)
        out = {}
        for d, f, n in (("cpu", cf, cn), (cuda, gf, gn)):
            ed = [torch.from_numpy(e[k]).to(d) for k in e]
            sf, sn, ok = network.spawn_flows_many(f, n, tcs[d], cfg, *ed,
                                                  now.to(d))
            rf, lf = network.recompute_rates(sf, tcs[d], now.to(d))
            af = network.advance_flows(rf, torch.tensor(0.004).to(d))
            kf, fin = network.complete_flows(af, torch.tensor(1.2).to(d))
            un = network.update_switch_states(sn, lf, tcs[d], cfg,
                                              torch.tensor(1.002).to(d))
            p = power.switch_power(un, cfg)
            en = power.accrue_switch_energy(un, torch.tensor(0.0137).to(d),
                                            p)
            cost = network.route_wake_cost(
                tcs[d], n, 0, torch.arange(topo.n_servers, device=d))
            out[str(d)] = (sf, sn, ok, rf, lf, af, kf, fin, un, p, en, cost)
        names = ("spawn flows", "spawn net", "ok", "rates", "link_flows",
                 "advance", "complete", "fin", "switch states",
                 "sw_power", "accrue", "net_cost")
        for nm, g, c in zip(names, out[str(cuda)], out["cpu"]):
            _same(g, c, nm, reduced=("sw_power", "sw_energy"))
        assert int(out["cpu"][2].sum()) > 0


def _star_scenario(max_flows):
    kw, arr, specs, _, topo = star_scenario(jobs, topology, max_flows)
    return SimConfig(**kw), arr, specs, topo


@pytest.mark.parametrize("max_flows", [64, 2])
def test_network_engine_on_card_matches_cpu(cuda, max_flows):
    cfg, arr, specs, topo = _star_scenario(max_flows)
    finals = {}
    for d in ("cpu", cuda):
        jt = jobs.build_jobs(cfg, arr, specs, device=d)
        state, tc = engine.init_state(cfg, jt, topo)
        ops.reset_launch_counts()
        finals[str(d)] = engine.run(state, cfg, tc)
    counts = ops.launch_counts()
    gpu, cpu = finals[str(cuda)], finals["cpu"]
    for (path, g), (_, c) in zip(tree_leaves(gpu), tree_leaves(cpu)):
        g = g.cpu()
        if path in ("farm.energy", "farm.residency", "farm.busy_core_seconds",
                    "telem.win", "telem.win_overflow", "net.sw_energy"):
            assert torch.allclose(g, c, rtol=1e-5, atol=1e-6), path
        else:
            assert torch.equal(g, c), path
    assert bool(gpu.done) and (int(gpu.flows.flows_dropped) > 0) == \
        (max_flows == 2)
    assert counts["dcsim_advance"] == int(gpu.steps) * cfg.events_per_step
    assert counts["telemetry_accum"] == int(gpu.steps)


def test_network_simulate_on_the_card(cuda):
    cfg, arr, specs, topo = _star_scenario(64)
    res = farm.simulate(cfg, arr, specs, topo=topo)
    assert res.run_info.backend == "cuda" and res.n_finished == 30
    assert res.flows_dropped == 0 and res.switch_energy > 0


# --------------------------------------------------------------------------
# the flight recorder
# --------------------------------------------------------------------------

def _staged(rng, sizes, dens, dev):
    """Random staged records on ``dev``: tensors, 0-d tensors, Python
    numbers and None as payloads."""
    recs = []
    for s, m in enumerate(sizes):
        mask = torch.from_numpy(rng.random(m) < dens).to(dev)
        pay = [torch.from_numpy(rng.integers(-1, 5000, m).astype(np.int32)
                                ).to(dev),
               None if s % 2 else float(rng.uniform(-3, 3)),
               torch.from_numpy(rng.uniform(-1e3, 1e3, m).astype(np.float32)
                                ).to(dev) if s % 3 else
               torch.tensor(float(rng.uniform(0, 9)), device=dev)]
        trace.stage(recs, mask, int(rng.integers(0, TraceKind.NUM)), *pay)
    return recs


@pytest.mark.parametrize("sizes,dens,cap,ptr0", [
    ([3, 5], 0.5, 16, 0), ([8, 16, 24], 0.4, 64, 60),
    ([200, 40], 0.9, 64, 0), ([65536, 600, 8], 0.3, 1 << 16, 70_000)])
def test_flush_on_the_card_matches_cpu(cuda, sizes, dens, cap, ptr0):
    """Three passes of random staged records, with one closed pass: ring,
    pointer and drop count bit-equal on the card and the CPU, and the
    ring written in place."""
    cfg = SimConfig(trace=TraceConfig(enabled=True, capacity=cap))
    outs = {}
    for d in ("cpu", cuda):
        rng = np.random.default_rng(5)
        tr = trace.init_trace(cfg, d)
        tr = dataclasses.replace(tr, ptr=torch.tensor(ptr0, device=d,
                                                      dtype=torch.int32))
        ring = tr.buf
        for i, alive in enumerate((None, False, True)):
            recs = _staged(rng, sizes, dens, d)
            flag = None if alive is None else torch.tensor(alive, device=d)
            tr = trace.flush(tr, cfg, torch.tensor(0.25 * i, device=d), recs,
                             flag)
            assert tr.buf is ring
        outs[str(d)] = tr
    g, c = outs[str(cuda)], outs["cpu"]
    assert torch.equal(g.buf.cpu(), c.buf)
    assert int(g.ptr) == int(c.ptr) > ptr0
    assert int(g.dropped) == int(c.dropped)


def test_traced_engine_on_card_matches_cpu(cuda):
    """tests/test_trace.py's rich scenario (sleep timers, throttling) with
    the recorder on, at the default capacity and at 64 slots, where the
    ring wraps: every leaf as on the CPU, the ring exactly."""
    th = ThermalConfig(enabled=True, r_th=0.5, tau_th=2.0, recirc=0.2,
                       rack_size=3, t_throttle=50.0, t_release=45.0,
                       throttle_freq=0.5, throttle_power_scale=0.6,
                       carbon_period=600.0, price_period=600.0)
    rng = np.random.default_rng(7)
    arr = workload.poisson_arrivals(60.0, 150, seed=3)
    specs = [jobs.dag_single(s) for s in rng.exponential(0.02, 150)]
    for cap in (65536, 64):
        cfg = SimConfig(n_servers=6, n_cores=2, max_jobs=256,
                        sleep_policy=SleepPolicy.SINGLE_TIMER,
                        sleep_state=SrvState.S3, thermal=th,
                        trace=TraceConfig(enabled=True, capacity=cap))
        gpu = _card_equals_cpu(cfg, arr, specs, cuda, tau=0.05)
        ev, dropped = traceio.decode(gpu.trace, cfg)
        assert (dropped > 0) == (cap == 64)
        if cap > 64:        # the 64 newest records hold no crossing
            assert TraceKind.THROTTLE_CROSSING in set(ev["kind"].tolist())


# --------------------------------------------------------------------------
# the replica axis: batched kernels and run_replicas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("clock", [np.float32, np.float64])
@pytest.mark.parametrize("R,n", [(1, 1000), (3, 300), (1024, 16),
                                 (4, 65536)])
def test_batched_dcsim_advance_matches_plain(cuda, R, n, clock):
    """One launch for R farms, each with its own minimum (replica 1 of a
    batch is all INF): bitwise equal to the batched plain version."""
    from torch_kernel_inputs import dcsim_inputs_batched
    a = torch_args(dcsim_inputs_batched(R, n, 4, 7, clock=clock,
                                        inf_replica=1 if R > 1 else None),
                   cuda)
    before = dcsim_step.LAUNCHES
    got = dcsim_step.dcsim_advance(*a, throttle_power_scale=0.6)
    assert dcsim_step.LAUNCHES == before + 1
    exp = ref.dcsim_advance_reference(*a, throttle_power_scale=0.6)
    for g, e in zip(got, exp):
        assert g.shape == e.shape and torch.equal(g, e)
    assert list(dcsim_step.scratch(cuda, a[0].dtype, R).tolist()) == \
        [0] * R + [-1] * R


@pytest.mark.parametrize("R,J", [(1024, 128), (8, 600), (3, 100_003)])
def test_batched_telemetry_accum_matches_plain(cuda, R, J):
    """One launch for R replicas' streams, each into its own histograms
    and window row, on the one-block and the cross-block path."""
    from torch_kernel_inputs import tb_inputs_batched
    a = torch_args(tb_inputs_batched(R, J, J, 64, 1 if J < 1000 else 16,
                                     19, 5), cuda)
    before = telemetry_bin.LAUNCHES
    got = telemetry_bin.telemetry_accum(*a)
    assert telemetry_bin.LAUNCHES == before + 1
    exp = ref.telemetry_accum_reference(*a)
    for g, e in zip(got, exp):
        assert g.shape == e.shape and torch.equal(g, e)


def _replicas(name, dev):
    from repro_torch.core import montecarlo
    from torch_kernel_inputs import mc_config, mc_scenario
    kw, nested, arrs, specs, taus, net = mc_scenario(name, jobs)
    cfg = mc_config(types, kw, nested)
    topo = topology.fat_tree(4, link_cap=1.25e9) if net else None
    sb, tc = montecarlo.batched_state(cfg, arrs, specs, taus=taus,
                                      topo=topo, device=dev)
    ops.reset_launch_counts()
    return cfg, montecarlo.run_replicas(cfg, sb, tc), ops.launch_counts()


@pytest.mark.parametrize("name", ["replicas_r3", "fat_tree_rr",
                                  "thermal_sweep", "traced_rich_cap64"])
def test_run_replicas_on_card_matches_cpu(cuda, name):
    cfg, gpu, counts = _replicas(name, cuda)
    _, cpu, _ = _replicas(name, "cpu")
    for (path, g), (_, c) in zip(tree_leaves(gpu), tree_leaves(cpu)):
        g = g.cpu()
        assert g.dtype == c.dtype and g.shape == c.shape, path
        if g.dtype.is_floating_point and path not in (
                "telem.job_hist", "telem.task_hist", "trace.buf"):
            assert torch.allclose(g, c, rtol=1e-5, atol=0.0), path
        else:
            assert torch.equal(g, c), path
    steps = int(gpu.steps.max())
    assert counts["dcsim_advance"] == steps * cfg.events_per_step
    assert counts["telemetry_accum"] == steps


def test_replica_batch_launches_once_a_pass_at_r64(cuda):
    """R = 64 farms: one advance launch a pass (K a macro-step) and one
    binning launch a macro-step, as a single farm."""
    from repro_torch.core import montecarlo
    n, R = 64, 64
    cfg = SimConfig(n_servers=n, n_cores=4, local_q=64, max_jobs=256,
                    tasks_per_job=1, sleep_policy=SleepPolicy.ALWAYS_ON,
                    max_events=10_000)
    rng = np.random.default_rng(1)
    lam = workload.utilization_to_rate(0.5, 0.01, n, 4)
    arrs = np.stack([workload.poisson_arrivals(lam, 200, seed=s)
                     for s in range(R)])
    specs = [jobs.dag_single(rng.exponential(0.01)) for _ in range(200)]
    sb, tc = montecarlo.batched_state(cfg, arrs, specs, device=cuda)
    ops.reset_launch_counts()
    out = montecarlo.run_replicas(cfg, sb, tc)
    counts = ops.launch_counts()
    steps = int(out.steps.max())
    assert (montecarlo.replica_stats(out, cfg)["finished"] == 200).all()
    assert counts["dcsim_advance"] == steps * cfg.events_per_step
    assert counts["telemetry_accum"] == steps


def _sharded_bitwise(got, exp, context):
    lg, le = tree_leaves(got), tree_leaves(exp)
    bad = [p for (p, a), (_, b) in zip(lg, le)
           if a.dtype != b.dtype or not torch.equal(a.cpu(), b.cpu())]
    assert not bad, f"{context}: leaves differ: {bad}"


@pytest.mark.parametrize("name", ["lb_sleep", "thermal_throttle"])
def test_sharded_mesh_of_one_over_nccl_matches_engine_run(cuda, name,
                                                          tmp_path):
    """run_sharded on a one-rank NCCL mesh equals engine.run on the card
    bit for bit, the ring included."""
    import torch.distributed as dist
    from repro_torch.core import shard_sim
    from torch_spmd import shard_initial
    cfg, state, tc = shard_initial(name, cuda)
    ref = engine.run(state, cfg, tc)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1, device_id=cuda)
    try:
        got = shard_sim.run_sharded(state, cfg, tc,
                                    shard_sim.make_mesh(1, device=cuda))
    finally:
        dist.destroy_process_group()
    assert int(ref.events) > 0 and bool(ref.done)
    _sharded_bitwise(got, ref, f"{name} K=1 over NCCL")


def test_sharded_two_ranks_on_the_card_match_engine_run(cuda):
    """Two ranks: over NCCL with a card each where there are two cards,
    else both on card 0 over gloo (NCCL refuses two ranks on one card);
    every rank's final state equals engine.run on the card bit for
    bit."""
    import torch_spmd
    from repro_torch.core import shard_sim
    from torch_kernel_inputs import SHARD_SCENARIOS
    route = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    ranks = shard_sim.spawn(torch_spmd.plan, 2, (
        [("sharded_runs", (SHARD_SCENARIOS, "cuda"))],), backend=route)
    for name in SHARD_SCENARIOS:
        cfg, state, tc = torch_spmd.shard_initial(name, cuda)
        ref = engine.run(state, cfg, tc)
        for r, (results, mods) in enumerate(ranks):
            assert not mods, mods
            final, calls, n = results[0][name]
            _sharded_bitwise(final, ref, f"{name} K=2 ({route}) rank {r}")
            assert sum(calls.values()) == n * (int(ref.steps) + 1)


# --------------------------------------------------------------------------
# the graph audit on the card (src/repro_torch/analysis/)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "policy_load_balance", "policy_network_aware", "thermal_throttling",
    "trace_on", "montecarlo_vmap", "f64_thermal_throttling",
    "scalar_round_robin", "scalar_network"])
def test_graph_audit_on_card_matches_cpu(cuda, name):
    """A matrix case's macro-step recorded on the card: every rule of
    simlint holds (the histogram's drift advisory under another torch than
    the baseline's), no host sync, each kernel one op node a launch, and
    the per-region histogram equal to the CPU recording's once its plain
    versions are folded into their nodes."""
    from repro_torch.analysis import matrix, rules, simlint
    baseline = rules.load_baseline(simlint.DEFAULT_BASELINE)
    advisory = baseline["torch"] != torch.__version__
    violations, report, inv = simlint.audit_case(
        matrix.build_case(name), baseline["cases"][name], advisory,
        on_card=True)
    hard = [v for v in violations
            if not (advisory and v.rule == "no-new-ops")]
    assert hard == [], "\n".join(v.render() for v in hard)
    assert report["summary"]["host_syncs"] == 0
    assert not any(s.folded_away for s in inv.sites)
    (_, cpu, _, _, _), = simlint.record_case(matrix.build_case(name, "cpu"))
    assert inv.histogram() == cpu.histogram()


@pytest.mark.parametrize("name", ["lb_sleep", "thermal_throttle"])
def test_sharded_step_graph_over_nccl(cuda, name, tmp_path):
    """shard_sim.sharded_step_graph on a one-rank NCCL mesh: one
    all_gather per sharded leaf, no other collective, no host sync, each
    kernel one op node a launch."""
    import torch.distributed as dist
    from repro_torch.analysis.graph_audit import (ALL_GATHER_OPS,
                                                  COLLECTIVE_OPS,
                                                  HOST_SYNC_OPS, KERNEL_OPS)
    from repro_torch.core import shard_sim
    from torch_spmd import shard_initial
    cfg, state, tc = shard_initial(name, cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1, device_id=cuda)
    try:
        mesh = shard_sim.make_mesh(1, device=cuda)
        n = shard_sim.n_sharded_leaves(state, cfg, mesh)
        before = sum(ops.launch_counts().values())
        inv = shard_sim.sharded_step_graph(state, cfg, tc, mesh)
        torch.cuda.synchronize()
        launched = sum(ops.launch_counts().values()) - before
    finally:
        dist.destroy_process_group()
    assert n == (19 if cfg.thermal.enabled else 12)
    assert inv.count(ALL_GATHER_OPS) == inv.count(COLLECTIVE_OPS) == n
    assert inv.count(HOST_SYNC_OPS) == 0
    assert inv.count(KERNEL_OPS) == launched == 9


def test_library_ops_launch_once_a_node_on_the_card(cuda):
    """Each registered op on CUDA tensors launches its kernel once (a
    recording sees one node and nothing of the wrapper's inside) and
    equals the plain version; the same call on meta tensors gives the
    wrapper's shapes and dtypes without a launch."""
    from repro_torch.analysis import graph_audit
    a = torch_args(dcsim_inputs(1000, 4, 3), cuda)
    t = torch_args(tb_inputs(600, 600, 64, 1, 19, 4), cuda)
    for name, args, plain in (
            ("dcsim_advance", a, ref.dcsim_advance_reference),
            ("telemetry_accum", t, ref.telemetry_accum_reference)):
        before = ops.launch_counts()[name]
        inv = graph_audit.record(getattr(ops, name), *args)
        torch.cuda.synchronize()
        assert ops.launch_counts()[name] == before + 1
        assert [s.op for s in inv.sites] == [ops.OPS[name]]
        for g, e in zip(inv.result, plain(*args)):
            assert torch.equal(g, e)
        meta = getattr(ops, name)(*[x.to("meta") if torch.is_tensor(x)
                                    else x for x in args])
        assert [(m.shape, m.dtype) for m in meta] == \
            [(r.shape, r.dtype) for r in inv.result]
        assert ops.launch_counts()[name] == before + 1


# --------------------------------------------------------------------------
# the seed scalar hot loops (SimConfig(use_vectorized_hot_loop=False))
# --------------------------------------------------------------------------

def test_scalar_primitives_on_card_match_cpu(cuda):
    """queue_push, begin_wake, compact_mask and spawn_flow on a batch of
    three replicas, each under a mask that is false for one of them, at a
    full queue and a full flow table: the card's result equals the CPU's
    bit for bit, and a masked replica keeps every leaf."""
    cfg = SimConfig(n_servers=6, n_cores=2, local_q=3, max_jobs=16)
    rng = np.random.default_rng(11)
    farm = types.init_farm(cfg, "cpu")
    farm = dataclasses.replace(
        farm,
        q_len=torch.from_numpy(rng.integers(0, 4, (3, 6)).astype(np.int32)),
        q_seq=torch.tensor([5, 2 ** 31 - 1, 9], dtype=torch.int32),
        dropped=torch.zeros(3, dtype=torch.int32),
        srv_state=torch.from_numpy(rng.integers(0, 6, (3, 6))
                                   .astype(np.int32)),
        srv_wake_at=torch.full((3, 6), types.INF),
        wake_count=torch.zeros((3, 6), dtype=torch.int32))
    srv = torch.tensor([1, 3, 5], dtype=torch.int32)
    tid = torch.tensor([0, 7, 15], dtype=torch.int32)
    mask = torch.tensor([True, True, False])
    now = torch.full((3,), 0.5)
    masks = torch.from_numpy(rng.random((3, 40)) < 0.3)
    topo = topology.fat_tree(4, link_cap=1.25e9)
    fcfg = SimConfig(n_servers=16, max_jobs=16, tasks_per_job=2,
                     max_flows=12, has_network=True)
    (cf, cn), (gf, gn) = _net_pair(topo, 12, fcfg.n_tasks, 5, cuda,
                                   n_active=11)
    e = edge_inputs(16, fcfg.n_tasks, 7, E=4)
    out = {}
    for d, f, n in (("cpu", cf, cn), (cuda, gf, gn)):
        fd = types.ServerFarm(**{k: getattr(farm, k).to(d)
                                 for k in farm.__dataclass_fields__})
        pushed = server.queue_push(fd, cfg, srv.to(d), tid.to(d),
                                   mask.to(d))
        woke = server.begin_wake(pushed[0], cfg, srv.to(d), now.to(d),
                                 mask.to(d))
        compact = server.compact_mask(masks.to(d), 5)
        tc = network.topo_consts(topo, d)
        spawned = []
        for i in range(4):
            args = [torch.tensor(max(int(e[k][i]), 0) if k != "nbytes"
                                 else float(e[k][i])).to(d)
                    for k in ("src", "dst", "nbytes", "child")]
            f, n, ok = network.spawn_flow(f, n, tc, fcfg, *args,
                                          torch.tensor(1.0).to(d),
                                          torch.tensor(i != 2).to(d))
            spawned.append(ok)
        out[str(d)] = (pushed, (woke,), compact,
                       (f, n, torch.stack(spawned)))
    for nm, g, c in zip(("push", "wake", "compact", "spawn"),
                        out[str(cuda)], out["cpu"]):
        for k, (gg, cc) in enumerate(zip(g, c)):
            _same(gg, cc, f"{nm}[{k}]")
    pushed, (woke,) = out["cpu"][:2]
    full = int(farm.q_len[1, 3]) >= cfg.local_q
    assert int(pushed[0].q_seq[1]) == (2 ** 31 - 1 if full else -2 ** 31)
    for f in farm.__dataclass_fields__:
        assert torch.equal(getattr(woke, f)[2], getattr(farm, f)[2]), f
    f, n, ok = out["cpu"][3]
    assert int(ok.sum()) == 1 and int(f.flows_dropped) == 2 + int(
        cf.flows_dropped)


@pytest.mark.parametrize("name", ["star", "dag_chain_rr"])
def test_scalar_engine_on_card_matches_cpu(cuda, name):
    """A scalar-mode run on the card against the same run on the CPU
    (discrete exact, float reductions rtol 1e-5) and against the card's
    vectorized run of the same configuration (rtol/atol 1e-6): the star
    with two flow slots (all three loops, spawns refused) and three-task
    chains under ROUND_ROBIN with delay timers (assignment, drain and
    wakes)."""
    if name == "star":
        cfg, arr, specs, topo = _star_scenario(2)
        tau = None
    else:
        rng = np.random.default_rng(13)
        arr = workload.poisson_arrivals(40.0, 80, seed=6)
        specs = [jobs.dag_chain(rng.exponential(0.01, size=3))
                 for _ in range(80)]
        cfg = SimConfig(n_servers=4, n_cores=2, max_jobs=128,
                        tasks_per_job=3, sched_policy=SchedPolicy.ROUND_ROBIN,
                        sleep_policy=SleepPolicy.SINGLE_TIMER,
                        sleep_state=SrvState.S3, max_events=50_000)
        topo, tau = None, 0.05
    scalar = dataclasses.replace(cfg, use_vectorized_hot_loop=False)
    finals = {}
    for key, c, d in (("cpu", scalar, "cpu"), ("card", scalar, cuda),
                      ("card vec", cfg, cuda)):
        jt = jobs.build_jobs(c, arr, specs, device=d)
        state, tc = engine.init_state(c, jt, topo)
        if tau is not None:
            state.farm.srv_tau = torch.full_like(state.farm.srv_tau, tau)
        ops.reset_launch_counts()
        finals[key] = engine.run(state, c, tc)
        if key == "card":
            counts = ops.launch_counts()
    gpu, cpu, vec = finals["card"], finals["cpu"], finals["card vec"]
    for (path, g), (_, c), (_, v) in zip(tree_leaves(gpu), tree_leaves(cpu),
                                         tree_leaves(vec)):
        g = g.cpu()
        if path in ("farm.energy", "farm.residency", "farm.busy_core_seconds",
                    "telem.win", "telem.win_overflow", "net.sw_energy"):
            assert torch.allclose(g, c, rtol=1e-5, atol=1e-6), path
        else:
            assert torch.equal(g, c), path
        assert np.allclose(g.double().numpy(), v.cpu().double().numpy(),
                           rtol=1e-6, atol=1e-6), path
    assert bool(gpu.done)
    assert counts["dcsim_advance"] == int(gpu.steps) * cfg.events_per_step
    assert counts["telemetry_accum"] == int(gpu.steps)


# --------------------------------------------------------------------------
# MoE serving (models/moe.py)
# --------------------------------------------------------------------------

def _moe_cfg(dtype, **kw):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke("moonshot_v1_16b_a3b"),
                               param_dtype=dtype, compute_dtype=dtype, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_scatter_on_card_matches_cpu(cuda, dtype):
    """One MoE layer at a small width (256 wide, 16 experts, top 4, one
    shared expert, capacity factor 0.5 so that tokens drop), 2 x 300
    tokens, card against CPU under the route-flip rule; the card's scatter
    path also against its einsum oracle."""
    from repro_torch.models import moe, transformer
    cfg = _moe_cfg(dtype, d_model=256, n_experts=16, top_k=4, d_expert=128,
                   capacity_factor=0.5)
    p = transformer.Params(transformer._moe_params(cfg, transformer._Init(
        cfg, torch.Generator().manual_seed(0), torch.device("cpu"))))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 300, cfg.d_model)).astype(np.float32)).to(p["wg"].dtype)
    pg, xg = copy.deepcopy(p).to(cuda), x.to(cuda)
    with recorded_routes(moe) as got:
        og, ag, dg = moe.moe_scatter(pg, xg, cfg)
    with recorded_routes(moe) as exp:
        oc, ac, dc = moe.moe_scatter(p, x, cfg)
    torch.cuda.synchronize()
    if route_flips(got, exp):        # near-ties only: nothing else holds
        return
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert og.dtype == x.dtype and int(dg) == int(dc) > 0
    torch.testing.assert_close(og.cpu().float(), oc.float(), atol=tol,
                               rtol=tol)
    assert float(ag) == pytest.approx(float(ac), rel=1e-5)
    oe, _, de = moe.moe_einsum(pg, xg, cfg)
    assert int(de) == int(dg)
    torch.testing.assert_close(oe.float(), og.float(), atol=2e-2, rtol=2e-2)


def test_moe_generate_on_card_matches_cpu(cuda):
    """Smoke moonshot, float32, parameters made on the card by default and
    copied to the CPU: ServeEngine.generate on ragged prompts gives the
    same greedy tokens on both, under the route-flip rule; the prefill
    launches the attention once a layer, on its CUDA-core instance."""
    from repro_torch.models import moe, transformer
    from repro_torch.serve.engine import ServeEngine
    cfg = _moe_cfg("float32")
    pg = transformer.make_params(cfg, torch.Generator(cuda).manual_seed(0))
    pc = copy.deepcopy(pg).cpu()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (19, 13, 9)]
    ops.reset_launch_counts()
    with recorded_routes(moe) as got:
        rg = ServeEngine(cfg, pg, max_batch=4, max_seq=40).generate(
            prompts, max_new=6)
    counts = dict(flash_attention.INSTANCE_LAUNCHES)
    with recorded_routes(moe) as exp:
        rc = ServeEngine(cfg, pc, max_batch=4, max_seq=40,
                         device="cpu").generate(prompts, max_new=6)
    assert counts == {flash_attention.TENSOR_CORE: 0,
                      flash_attention.CUDA_CORE: cfg.n_layers}
    if route_flips(got, exp):        # near-ties only: nothing else holds
        return
    assert [r.tokens for r in rg] == [r.tokens for r in rc]


# --------------------------------------------------------------------------
# recurrent serving (models/ssm.py): the xLSTM mixers and the mamba kind
# --------------------------------------------------------------------------

def _xlstm_cfg(**kw):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke("xlstm_350m"),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_mixer_on_card_matches_cpu(cuda, kind):
    """One mixer at a small width (256 wide, 4 heads of 64), float32,
    B = 2 x 1,100 tokens (the mLSTM's parallel form in three query chunks
    of 512, the last ragged): prefill output and final state, then two
    decode steps, card against CPU within 1e-3 (the products and, for the
    parallel form, exp of differences of the running gate sum, add in
    another order; the sum itself is taken in float64 on both)."""
    from repro_torch.models import ssm, transformer
    cfg = _xlstm_cfg(d_model=256, head_dim=64)
    fn = {"mlstm": transformer._mlstm_params,
          "slstm": transformer._slstm_params}[kind]
    p = transformer.Params(fn(cfg, transformer._Init(
        cfg, torch.Generator().manual_seed(0), torch.device("cpu"))))
    pg = copy.deepcopy(p).to(cuda)
    mixer = getattr(ssm, f"{kind}_mixer")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1102, cfg.d_model)).astype(np.float32))
    oc, sc = mixer(p, x[:, :1100], cfg, mode="prefill")
    og, sg = mixer(pg, x[:, :1100].to(cuda), cfg, mode="prefill")
    for t in (1100, 1101):
        assert og.device.type == "cuda"
        torch.testing.assert_close(og.cpu(), oc, atol=1e-3, rtol=1e-3)
        for k in sc:
            assert sg[k].device.type == "cuda"
            torch.testing.assert_close(sg[k].cpu(), sc[k], atol=1e-3,
                                       rtol=1e-3)
        oc, sc = mixer(p, x[:, t:t + 1], cfg, mode="decode", state=sc)
        og, sg = mixer(pg, x[:, t:t + 1].to(cuda), cfg, mode="decode",
                       state=sg)
    torch.testing.assert_close(og.cpu(), oc, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("arch,kw,scans", [
    ("xlstm_350m", {}, 0), ("hymba_1_5b", {"block_pattern": ("mamba",)}, 1)])
def test_recurrent_generate_on_card_matches_cpu(cuda, arch, kw, scans):
    """Smoke xLSTM and a smoke mamba stack, float32, parameters made on
    the card by default and copied to the CPU: ServeEngine.generate on
    ragged prompts gives the same greedy tokens on both.  The xLSTM
    launches no kernel; the mamba prefill launches the CUDA scan once a
    layer."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype="float32",
                              compute_dtype="float32", **kw)
    pg = transformer.make_params(cfg, torch.Generator(cuda).manual_seed(0))
    pc = copy.deepcopy(pg).cpu()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (19, 13, 9)]
    ops.reset_launch_counts()
    rg = ServeEngine(cfg, pg, max_batch=4, max_seq=40).generate(
        prompts, max_new=6)
    counts = ops.launch_counts()
    rc = ServeEngine(cfg, pc, max_batch=4, max_seq=40,
                     device="cpu").generate(prompts, max_new=6)
    assert counts["ssm_scan"] == scans * cfg.n_layers
    assert counts["flash_attention"] == 0
    assert [r.tokens for r in rg] == [r.tokens for r in rc]


# --------------------------------------------------------------------------
# the encoder-decoder (whisper): encoder, cross-attention, learned positions
# --------------------------------------------------------------------------

def test_whisper_serve_steps_on_card_match_cpu(cuda):
    """Smoke whisper at enc_seq 37, float32, parameters made on the card
    and copied to the CPU: the prefill with frames and 5 serve steps,
    logits within 1e-3 and the same greedy tokens.  The prefill launches
    the attention once an encoder layer and twice a decoder layer (its
    self-attention and its cross-attention), each decode step once a
    decoder layer (the cross-attention), all on the CUDA-core instance."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train import step
    cfg = dataclasses.replace(configs.get_smoke("whisper_large_v3"),
                              enc_seq=37, param_dtype="float32",
                              compute_dtype="float32")
    pg = transformer.make_params(cfg, torch.Generator(cuda).manual_seed(0),
                                 max_seq=24)
    pc = copy.deepcopy(pg).cpu()
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 12)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32))
    prefill, decode = step.make_prefill(cfg), step.make_serve_step(cfg)
    cc = transformer.init_cache(cfg, 2, 24, device="cpu")
    cg = transformer.init_cache(cfg, 2, 24)
    lc, cc = prefill(pc, toks, cc, frames)
    ops.reset_launch_counts()
    lg, cg = prefill(pg, toks.to(cuda), cg, frames.to(cuda))
    assert flash_attention.INSTANCE_LAUNCHES == {
        flash_attention.TENSOR_CORE: 0,
        flash_attention.CUDA_CORE: cfg.enc_layers + 2 * cfg.n_layers}
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert flash_attention.SHAPE_LAUNCHES == {
        (2, H, KV, 37, 37, hd, False, 0): cfg.enc_layers,
        (2, H, KV, 12, 12, hd, True, 0): cfg.n_layers,
        (2, H, H, 12, 37, hd, False, 0): cfg.n_layers}
    for t in range(12, 17):
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)
        tok = lc.argmax(-1)
        assert torch.equal(lg.argmax(-1).cpu(), tok)
        lc, cc = decode(pc, cc, tok[:, None], t)
        lg, cg = decode(pg, cg, tok[:, None].to(cuda), t)
    assert ops.launch_counts()["flash_attention"] == \
        cfg.enc_layers + 2 * cfg.n_layers + 5 * cfg.n_layers
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=1e-3)


# --------------------------------------------------------------------------
# training: the backward kernels, and a train step card against CPU
# --------------------------------------------------------------------------

FLASH_BWD_CASES = [   # B, H, KV, Sq, Skv, hd, causal, window, softcap, dtype
    (2, 25, 5, 1100, 1100, 64, True, 1024, 0.0, torch.bfloat16),  # hymba
    (1, 16, 8, 300, 300, 256, True, 4096, 50.0, torch.bfloat16),  # gemma2
    (2, 4, 2, 37, 300, 64, True, 0, 0.0, torch.bfloat16),         # ragged
    (2, 8, 8, 224, 1500, 64, False, 0, 0.0, torch.bfloat16),      # cross
    (2, 8, 4, 777, 777, 128, True, 256, 0.0, torch.float32),
] + [c + (torch.bfloat16,) for c in FLASH_TC_EDGES]


def _max_rel(got, exp):
    return float((got.float() - exp.float()).abs().max()) / \
        max(float(exp.float().abs().max()), 1e-30)


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_attention_backward_matches_plain(cuda, case):
    """dq, dk, dv within 2e-2 of each output's largest magnitude in bf16
    and 1e-4 in f32 (the kernel sums in float32 in its own order; bf16
    outputs round once)."""
    B, H, KV, Sq, Skv, hd, causal, window, cap, dt = case
    kw = dict(causal=causal, window=window, softcap=cap)
    q, k, v = (torch.from_numpy(a).to(cuda, dt)
               for a in flash_inputs(B, H, KV, Sq, Skv, hd, 41))
    out = flash_attention.flash_attention(q, k, v, **kw)
    dout = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (B, H, Sq, hd), dtype=np.float32)).to(cuda, dt)
    before = ops.launch_counts(ops.BACKWARD)["flash_attention_backward"]
    got = flash_attention.flash_attention_backward(q, k, v, out, dout, **kw)
    exp = ref.mha_backward_reference(q, k, v, out, None, dout, **kw)
    assert ops.launch_counts(ops.BACKWARD)["flash_attention_backward"] == \
        before + 1
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype and g.shape == e.shape
        assert torch.isfinite(g.float()).all()
        assert _max_rel(g, e) <= tol


@pytest.mark.parametrize("shape", [(3, 37, 200, 16), (2, 300, 500, 16)]
                         + SSM_EDGES)
@pytest.mark.parametrize("with_dh", [False, True])
def test_ssm_scan_backward_matches_plain(cuda, shape, with_dh):
    """ddt, dB, dC, dx and dA within 1e-4 of each output's largest
    magnitude (the kernel sums over the state, the channels and time in
    its own fixed order, the plain version in torch's)."""
    args = torch_args(ssm_inputs(*shape, 43), cuda)
    B, S, D, N = shape
    rng = np.random.default_rng(44)
    dy = torch.from_numpy(rng.standard_normal((B, S, D),
                                              dtype=np.float32)).to(cuda)
    dh = torch.from_numpy(rng.standard_normal(
        (B, D, N), dtype=np.float32)).to(cuda) if with_dh else None
    got = ssm_scan.ssm_scan_backward(*args, dy, dh)
    exp = ref.ssm_scan_backward_reference(*args, dy, dh)
    for g, e in zip(got, exp):
        assert g.shape == e.shape and g.dtype == torch.float32
        assert _max_rel(g, e) <= 1e-4


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_attention_backward_is_deterministic(cuda, case):
    """Two calls on the same inputs give bit-equal dq, dk and dv (no
    atomics in either instance), each counted once under its instance:
    bf16 at hd 16-128 on mma_bf16, f32 and bf16 hd 256 on simt_f32."""
    B, H, KV, Sq, Skv, hd, causal, window, cap, dt = case
    kw = dict(causal=causal, window=window, softcap=cap)
    q, k, v = (torch.from_numpy(a).to(cuda, dt)
               for a in flash_inputs(B, H, KV, Sq, Skv, hd, 45))
    out = flash_attention.flash_attention(q, k, v, **kw)
    dout = torch.from_numpy(np.random.default_rng(46).standard_normal(
        (B, H, Sq, hd), dtype=np.float32)).to(cuda, dt)
    ops.reset_launch_counts()
    first = flash_attention.flash_attention_backward(q, k, v, out, dout, **kw)
    again = flash_attention.flash_attention_backward(q, k, v, out, dout, **kw)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    inst = flash_attention.TENSOR_CORE if dt == torch.bfloat16 and \
        hd <= 128 else flash_attention.CUDA_CORE
    assert flash_attention.LAST_BWD_INSTANCE == inst
    assert flash_attention.BWD_INSTANCE_LAUNCHES == {
        inst: 2, ({flash_attention.TENSOR_CORE, flash_attention.CUDA_CORE}
                  - {inst}).pop(): 0}
    assert ops.launch_counts(ops.BACKWARD)["flash_attention_backward"] == 2


@pytest.mark.parametrize("shape", [(3, 37, 200, 16), (2, 300, 500, 16)]
                         + SSM_EDGES)
def test_ssm_scan_backward_is_deterministic(cuda, shape):
    """Two calls on the same inputs give bit-equal ddt, dB, dC, dx and dA:
    the sums over the channels and over batch and time are per-block
    partials added in a fixed order by a second kernel, no float atomics;
    dB, dC and dA are written whole, with no zeroing launch (two kernels a
    call in a CUDA graph, nothing else)."""
    args = torch_args(ssm_inputs(*shape, 47), cuda)
    B, S, D, N = shape
    rng = np.random.default_rng(48)
    dy = torch.from_numpy(rng.standard_normal((B, S, D),
                                              dtype=np.float32)).to(cuda)
    dh = torch.from_numpy(rng.standard_normal(
        (B, D, N), dtype=np.float32)).to(cuda)
    for h in (None, dh):
        first = ssm_scan.ssm_scan_backward(*args, dy, h)
        again = ssm_scan.ssm_scan_backward(*args, dy, h)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    G, E = ssm_scan.backward_lanes(N)
    assert ssm_scan.LAST_BWD_INSTANCE == f"lanes{G}x{E}"
    got = graph_ops(lambda: ssm_scan.ssm_scan_backward(*args, dy, dh))
    assert sum(got.values()) == 2
    assert all("ssm_scan_bwd" in k for k in got)


def test_train_step_launches_the_tensor_core_backward(cuda):
    """One train step of the 2-layer smoke hymba (bf16, hd 16) on the card
    runs the attention's backward once a layer, every time on its
    tensor-core instance, with finite metrics."""
    from repro_torch import configs
    from repro_torch.train import optim, step
    cfg = configs.get_smoke("hymba_1_5b")
    assert cfg.compute_dtype == "bfloat16"
    state = step.init_state(cfg, torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 40))).to(cuda)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    ts = step.make_train_step(cfg, opt_cfg=optim.AdamWConfig(warmup_steps=0))
    ops.reset_launch_counts()
    state, m = ts(state, batch)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert flash_attention.BWD_INSTANCE_LAUNCHES == {
        flash_attention.TENSOR_CORE: cfg.n_layers,
        flash_attention.CUDA_CORE: 0}
    assert ops.launch_counts(ops.BACKWARD) == {
        "flash_attention_backward": cfg.n_layers,
        "ssm_scan_backward": cfg.n_layers}


def test_train_step_on_card_matches_cpu(cuda):
    """Smoke hymba in float32 under remat "dots": two train steps on the
    card against the CPU from the same parameters, the loss and grad_norm
    within 1e-5 relative, the parameters within 1e-4; each step launches
    the forward kernels twice a layer (the forward, then its recompute)
    and each backward kernel once."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train import optim, step
    cfg = dataclasses.replace(configs.get_smoke("hymba_1_5b"),
                              param_dtype="float32", compute_dtype="float32",
                              remat="dots")
    p = transformer.make_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    sc = step.train_state(p)
    sg = step.train_state(copy.deepcopy(p).to(cuda))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 40)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    ts = step.make_train_step(cfg, opt_cfg=optim.AdamWConfig(warmup_steps=0))
    for _ in range(2):
        sc, mc = ts(sc, batch)
        ops.reset_launch_counts()
        sg, mg = ts(sg, {k: v.to(cuda) for k, v in batch.items()})
        assert ops.launch_counts(ops.FORWARD + ops.BACKWARD) == {
            "dcsim_advance": 0, "telemetry_accum": 0,
            "flash_attention": 2 * cfg.n_layers,
            "ssm_scan": 2 * cfg.n_layers,
            "flash_attention_backward": cfg.n_layers,
            "ssm_scan_backward": cfg.n_layers}
        for k in ("loss", "grad_norm"):
            assert abs(float(mg[k]) - float(mc[k])) <= 1e-5 * abs(float(mc[k]))
    for (n, a), (_, b) in zip(sg["params"].named_parameters(),
                              sc["params"].named_parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-4,
                                   rtol=1e-4, msg=n)
