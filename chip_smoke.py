#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from src/repro_torch/kernels/csrc
     (one nvcc per source, all started together); count the LM kernels'
     tensor-core (HMMA) and asynchronous-copy (LDGSTS) instructions;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (the network main run's farm among them), at
     ragged ones and at the edges of the attention's
     tensor-core instance and of the scan's lane splits
     (tests/torch_kernel_inputs.py); the engine kernels also at both of the
     binning's paths and their boundary, ten calls in a row (their
     in-kernel reduction's scratch must return to empty) and one call
     captured in a CUDA graph and replayed on new inputs; the advance's
     float64-clock instance, exactly, on the same farms; [mc-kernels]:
     both kernels' batched launches (a leading replica axis, one launch
     for the batch) bitwise equal to their plain versions, the advance at
     R = 1, 3 x 300, 1,024 x 16 and 4 x 65,536 on both clocks (an
     all-INF replica among them), the binning at 1,024 x 128 and 8 x 600;
  4. parity of the port on the card against the port on the CPU: two
     discrete-event scenarios, with the engine kernels' launch counters
     checked against the engine's step count; network mode on case study
     D's k=4 fat-tree under ROUND_ROBIN and NETWORK_AWARE and on a star
     whose two flow slots run out; and hymba-1.5b serving at full width
     cut to 2 layers in float32 (prefill and decode logits, greedy tokens,
     one launch of each LM kernel per layer, attention on its float32
     CUDA-core instance); [thermal-parity]: the thermal main configuration
     at 512 servers and 300 jobs (throttling must engage and deferral must
     park jobs), examples/thermal_case.py's THERMAL_AWARE scenario behind
     its throttle guard, and one_farm at 512 servers on a float64 clock
     (the advance's float64 instance launched K times a step); the flight
     recorder is on in the case D ROUND_ROBIN run (flow records) and in
     the 512-server thermal run (crossing bursts, releases, controller
     ticks), and
     [trace-parity] runs tests/test_trace.py's rich scenario (sleep
     timers, throttling) at the default capacity and at 64 slots, where
     the ring wraps; every ring is compared record for record, and those
     of [trace-parity] must be bit-equal; [mc-parity]: the reference's
     replica batches (tests/torch_kernel_inputs.py mc_scenario) through
     montecarlo.run_replicas, card against CPU, and each replica of the
     card's batch against a solo run of its inputs on the card;
  5. the discrete-event main run: farm.simulate on a 65,536-server x
     4-core farm (the largest farm benchmarks/bench_engine.py records)
     under 600 Poisson jobs at 50% utilisation; every job must finish;
     then the network main run: farm.simulate with topo= on a k=16
     fat-tree (1,024 servers, 320 switches, two line cards each) under
     case study D's workload scaled to that width (300 two-task chains
     with 100 MB edges, round-robin placement, so every chain ships one
     flow); every job must finish, no flow may be dropped, and the
     switch-power windows must integrate to the switch energy; then the
     thermal main run ([thermal-main]): farm.simulate on 65,536 servers x
     4 cores with the thermal subsystem and its whole control plane
     (benchmarks/bench_engine.py control_plane_farm with throttling armed):
     all 600 jobs finish, jobs are deferred, servers throttle, the
     setpoint controller moves the setpoints, and the cooling-power windows
     integrate to the cooling energy; then the same run with the flight
     recorder on ([trace-main], a 2^21-slot ring): the ring must hold the
     whole stream, count every arrival, admission, release, start and
     finish, record crossings and controller ticks, leave every result of
     the untraced run as it was, and export to a Chrome trace that passes
     benchmarks/trace_smoke.py's schema check; its overhead is also
     measured in turns with the untraced run, 10 macro-steps a window;
     then the replica main run ([mc-main]): montecarlo.run_replicas on
     benchmarks/bench_engine.py replica_throughput's two largest points
     (1,024 replicas x 16 servers x 100 jobs, 64 x 64 x 200): every job of
     every replica finishes, K advance launches and one binning launch a
     macro-step, and a batched macro-step within 3% of the launches of a
     single run of one replica; then the graph audit
     (src/repro_torch/analysis/): [simlint] records one macro-step of
     every single-device case of its matrix on the card, and every rule of
     ``python -m repro_torch.analysis.simlint`` must hold (no host sync in
     the step, the cheap core's scatter budget, no op of a disabled
     subsystem, the clock-dtype policy; the histogram's drift against the
     committed baseline advisory under another torch), each kernel one
     ``repro_torch::`` op node a launch, and the card's per-region op
     histogram equal to the CPU's once the CPU's plain versions are folded
     into their nodes; then its rebuild sentinel, in a spawned process
     (farm.simulate twice plain and twice with mesh=): each kernel library
     loaded once;
  6. the serving main run: ServeEngine.generate on hymba-1.5b (32 layers,
     bf16, seeded random weights) for 4 prompts of 1,536 tokens and 32 new
     tokens, greedy; exactly one launch of each LM kernel per layer, the
     attention on its bf16 tensor-core instance.
  Each kernel is then timed at its main path's shapes beside its bound
  (the largest of its bytes, its flops and its exponentials at their peak
  rates), its plain version and, where one exists, the library call
  computing the same function; an engine kernel's device time counts
  every device operation of its call (kernels, copies, fills), and each
  must be one.  Profiler breakdowns of both main paths follow, and
  [simlint-main]: one macro-step of the engine main configuration
  recorded on the card, its ops, scatters and host syncs, the cost
  model's bytes and operations and their bound on the H100 against the
  profiled macro-step's device time, and the state footprint predicted
  on fake tensors against the allocator's rise across init_state.
  7. rack sharding, last, so that its process group and profiler windows
     come after every earlier timing: [shard-parity] runs
     tests/test_sharding.py's four pinned configurations
     (tests/torch_kernel_inputs.py shard_scenario) unsharded on the card
     against the CPU, then through shard_sim.run_sharded on a mesh of 1
     over NCCL in this process and on two spawned ranks (NCCL with a card
     a rank where there are two cards, else gloo with both ranks on card
     0: NCCL refuses two ranks on one card), each bit-equal to the
     unsharded card run with one gather per sharded leaf a macro-step and
     no other collective, and on every rank shard_sim.sharded_step_graph
     must record one all_gather per sharded leaf, no other collective and
     no host sync; [shard-main] runs the engine main
     configuration through run_sharded (bit-equal to engine.run) and
     farm.simulate(mesh=) on both meshes: results equal to [main]'s,
     every rank's launches, wall, events/s, the bytes gathered a
     macro-step and the gathers' share of its device time; [shard-mc]
     runs [mc-parity]'s replicas_r3 batch at R = 4 on a (2, 1)
     ("replicas", "racks") mesh of the two ranks, equal to run_replicas
     without a mesh.

    python3 chip_smoke.py --engine-calls ROOT

times the two engine kernels' calls for the checkout at ROOT (its src/,
built there), as the full run does and through kernels.ops (the engine's
entry), and 10 macro-steps of [main]'s and [net-main]'s configurations:
launches, device busy and wall under the profiler, and wall without it,
in turns with the kernels' wrappers called directly and the engine's
regions stubbed out where the checkout has those; run it on an older
checkout and on . in turns in one call to compare the two on one card.

The second-to-last line is a JSON object describing each kernel (its
stream time "ms" and profiler time "device_ms" among the keys); the last
line is {"ok": true, "device": {...}}.  Without a card, or outside a
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "tests"))      # torch_kernel_inputs

# H100 SXM peaks (NVIDIA data sheet), one copy shared with the cost model:
# HBM3 bytes/s, f32 non-tensor ops/s and dense bf16 tensor-core flop/s;
# exponentials per SM per clock on the special-function units (one
# MUFU.EX2 per expf, 16 per SM per clock)
from repro_torch.analysis.costmodel import (  # noqa: E402
    H100_BF16_FLOP_S as PEAK_BF16_FLOP_S,
    H100_EXP_PER_SM_CLOCK as EXP_PER_SM_CLOCK,
    H100_F32_OPS_S as PEAK_F32_OPS_S, H100_HBM_BYTES_S as PEAK_BYTES_S)
N_MAIN, C_MAIN, JOBS_MAIN = 65_536, 4, 600
# the traced thermal main run's ring: 40 MB of float32 records
TRACE_CAP = 1 << 21
# [thermal-parity]'s run of the thermal main configuration at 512 servers,
# cut from the main run's 600 jobs so the whole script stays within 800 s
# (it still throttles, defers and ticks the controller)
TH_PAR_JOBS = 300
# the network main run: case study D (benchmarks/case_d_network.py) on a
# k=16 fat-tree, its 30 jobs/s over 16 servers scaled to 1,024 servers
NET_K, NET_JOBS, NET_LAM = 16, 300, 1920.0
NET_SERVERS = NET_K ** 3 // 4           # a k-ary fat-tree's servers
# [mc-main]: benchmarks/bench_engine.py replica_throughput's two largest
# points, (replicas, servers, jobs a replica, max_jobs)
MC_POINTS = ((1024, 16, 100, 128), (64, 64, 200, 256))
# [mc-parity]: the reference's replica scenarios (tests/torch_kernel_inputs
# mc_scenario): test_montecarlo's R = 3 batch, tau sweep and k = 4
# fat-tree ROUND_ROBIN batch, test_thermal's replica sweep, test_telemetry's
# zero-finish batch, and test_trace's rich scenario at R = 2, 64 slots
MC_PARITY = ("replicas_r3", "tau_sweep_r", "fat_tree_rr", "thermal_sweep",
             "telemetry_empty", "traced_rich_cap64")
# [mc-kernels]: the batched instances' shapes, (R, N) for the advance and
# (R, J = J*T) for the binning
MC_ADVANCE = ((1, 1000), (3, 300), (1024, 16), (4, 65_536))
MC_BINNING = ((1024, 128), (8, 600))
# [shard-mc]: [mc-parity]'s replicas_r3 batch at this many arrival seeds,
# split over two ranks
SHARD_MC_R = 4
# the serving main run and the card-vs-CPU serving parity run
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "hymba_1_5b", 4, 1536, 32
LM_MAX_SEQ = 2048
PAR_LAYERS, PAR_BATCH, PAR_PROMPT, PAR_NEW = 2, 2, 1100, 4


T_START = time.perf_counter()           # the script's start, for [elapsed]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def time_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Median time of one call on the current stream, from CUDA events
    recorded around each call (the stream's time, so a call whose host
    side is slower than its device work is charged for the gap)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def device_kernels(fn):
    """Run ``fn`` under torch.profiler and return ({kernel name: (calls,
    device us)}, host wall seconds); the dict is empty when the profiler
    recorded no device activity.  The device records are read as the
    profiler collected them: ``key_averages()`` would first build a Python
    event (and a tree) of every host and device record, which took tens of
    seconds a 10-macro-step window of an engine run."""
    from torch.autograd.profiler_util import _rewrite_name
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            key = _rewrite_name(e.name(), with_wildcard=True)
            calls, us = out.get(key, (0, 0.0))
            out[key] = (calls + 1, us + e.duration_ns() / 1e3)
    return out, wall


def profiled_us(fn, reps: int = 100, names=None):
    """(device us per operation, records seen per call) of ``fn`` over
    ``reps`` calls under torch.profiler: the device time of the operations
    (those whose names contain one of ``names``, else all) over the number
    the profiler recorded.  The profiler loses records now and then, most
    often the first ones of a window, so the count of operations a call
    comes from ``graph_ops``, not from here.  (None, 0.0) when it records
    no device time."""
    def many():
        for _ in range(reps):
            fn()
    ks, _ = device_kernels(many)
    hits = [(c, t) for k, (c, t) in ks.items()
            if names is None or any(n in k for n in names)]
    count, us = sum(c for c, _ in hits), sum(t for _, t in hits)
    if us <= 0 or count == 0:
        return None, 0.0
    return us / count, count / reps


def kernel_device_us(fn, names, reps: int = 100):
    """Device time of one call of ``fn`` (the kernels whose names contain
    one of ``names``): the profiler's mean time of one such kernel, times
    the number one call launches (``graph_ops``); None when the profiler
    sees no device time."""
    from torch_kernel_inputs import graph_ops
    per_op, _ = profiled_us(fn, reps, names)
    n = sum(c for k, c in graph_ops(fn).items()
            if any(m in k for m in names))
    return None if per_op is None else per_op * n


def call_device(fn, reps: int = 100):
    """(device us, device operations, {operation: count}, profiler records
    seen per call) of one call of ``fn``: the operations, exact, from
    ``graph_ops``; the device time from the profiler's mean time of an
    operation times their number (None when it records no device
    time)."""
    from torch_kernel_inputs import graph_ops
    ops = graph_ops(fn)
    n_ops = sum(ops.values())
    per_op, seen = profiled_us(fn, reps)
    return (None if per_op is None else per_op * n_ops), n_ops, ops, seen


def exp_per_s() -> float:
    """Exponentials per second on the special-function units: 16 per SM per
    clock at the SM clock nvidia-smi reports as the card's maximum."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXP_PER_SM_CLOCK * sms * mhz * 1e6


def bound_ms(n_bytes: float, ops: dict):
    """The least time the card could take: the largest of the bytes at the
    memory rate and of each kind of operation, ``ops`` = {kind: (count,
    per second)}, at its peak rate.  Returns (ms, "bytes" or "operations",
    the kind that bounds it)."""
    best = (n_bytes / PEAK_BYTES_S * 1e3, "bytes", "bytes")
    for kind, (n, rate) in ops.items():
        if n / rate * 1e3 > best[0]:
            best = (n / rate * 1e3, "operations", kind)
    return best


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def ulp_err(got: torch.Tensor, exp: torch.Tensor) -> float:
    """Largest |got - exp| in units of exp's last place."""
    up = torch.nextafter(exp, torch.full_like(exp, math.inf)) - exp
    return float(((got - exp).abs() / up).max())


def ptxas_entries(report: str) -> dict:
    """{kernel or kernel<template args>: "R registers, S bytes spilled"}
    from an ``nvcc -Xptxas -v`` report (empty when the library was
    cached)."""
    out, name, spill = {}, None, "0"
    for ln in report.splitlines():
        m = re.search(r"entry function '_Z(\d+)(\w+)'", ln)
        if m:
            name, rest = m[2][:int(m[1])], m[2][int(m[1]):]
            targs = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
            if targs:
                name += f"<{','.join(re.findall(r'L[a-z](\d+)E', targs[1]))}>"
            elif re.match(r"I[fd]E", rest):          # the clock's type
                name += "<float>" if rest[1] == "f" else "<double>"
            spill = "0"
        elif name and "spill stores" in ln:
            spill = re.search(r"(\d+) bytes spill stores", ln)[1]
        elif name and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln)[1]
            out[name] = f"{regs} registers, {spill} bytes spilled"
    return out


def sass_census(built) -> None:
    """What the kernels were compiled to (cuobjdump -sass): for the LM
    kernels tensor-core instructions (HMMA) and asynchronous
    global-to-shared copies (LDGSTS, from cp.async), which the attention
    library must hold; for the binning its shared-memory atomics (the
    counts' ATOMS.POPC.INC, the float parts' compare-and-swap loop
    ATOMS.CAST.SPIN)."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        fail(f"{tool} not found: the attention's SASS cannot be inspected")
    for name, ops in (("flash_attention", ("HMMA", "LDGSTS")),
                      ("ssm_scan", ("HMMA", "LDGSTS")),
                      ("telemetry_bin", ("ATOMS.POPC.INC",
                                         "ATOMS.CAST.SPIN"))):
        sass = subprocess.run([str(tool), "-sass", str(built[name][0])],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
        n = {op: sum(op in ln for ln in sass) for op in ops}
        log(f"[build] {name}: SASS holds "
            + " and ".join(f"{c} {op}" for op, c in n.items())
            + " instructions")
        if name == "flash_attention" and not (n["HMMA"] and n["LDGSTS"]):
            fail("flash_attention was not compiled to tensor-core "
                 "instructions fed by asynchronous copies")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def check_dcsim(n, c, seed, dev, scale=0.6, clock=np.float32):
    """Every server state, ~30% throttled, half the cores busy, some slots
    finishing exactly at t_next (tests/torch_kernel_inputs.py);
    ``clock=np.float64`` takes the float64 instance around t = 86,400 s,
    which must match exactly."""
    from repro_torch.kernels import dcsim_step, ref
    from torch_kernel_inputs import dcsim_inputs, torch_args
    args = torch_args(dcsim_inputs(n, c, seed, clock=clock), dev)
    got = dcsim_step.dcsim_advance(*args, throttle_power_scale=scale)
    exp = ref.dcsim_advance_reference(*args, throttle_power_scale=scale)
    torch.cuda.synchronize()
    names = ("new_busy", "done", "energy", "busy_seconds", "candidate")
    err = 0.0
    for name, g, e in zip(names, got, exp):
        if g.shape != e.shape or g.dtype != e.dtype:
            fail(f"dcsim_advance n={n} c={c}: {name} is {g.dtype}"
                 f"{tuple(g.shape)}, plain {e.dtype}{tuple(e.shape)}")
        if name in ("energy", "busy_seconds") and clock == np.float32:
            # exact or <= 1 ulp (the kernel rounds each op as PyTorch
            # does; a contracted FMA would be within one ulp)
            u = ulp_err(g, e)
            if u > 1.0:
                fail(f"dcsim_advance n={n} c={c}: {name} off by {u} ulp")
            err = max(err, float((g - e).abs().max()))
        elif not torch.equal(g, e):
            fail(f"dcsim_advance n={n} c={c}: {name} differs from the "
                 f"plain version")
    inst = "" if clock == np.float32 else " (float64 clock, exact)"
    log(f"[kernels] dcsim_advance n={n} c={c}{inst}: matches the plain "
        f"version (max abs err {err})")
    return args, err


def check_telemetry(J, M, W, K, seed, dev, unit=True):
    """Log-uniform latencies off the bin edges with both clamps hit, 0/1
    weights (or, not ``unit``, weights from {0, 0.5, 1, 2}),
    integer-valued histograms (the tests' builder)."""
    from repro_torch.kernels import ref, telemetry_bin
    from torch_kernel_inputs import tb_inputs, torch_args
    args = torch_args(tb_inputs(J, M, 64, W, K, seed, unit), dev)
    got = telemetry_bin.telemetry_accum(*args)
    exp = ref.telemetry_accum_reference(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, e in zip(("job_hist", "task_hist", "win"), got, exp):
        d = float((g - e).abs().max())
        # 0/1 (or dyadic) weights: every partial sum is exact, so the
        # atomics' order cannot show -- bitwise equality is required
        if not torch.equal(g, e):
            fail(f"telemetry_accum J={J} M={M}: {name} differs from the "
                 f"plain version (max abs err {d})")
        err = max(err, d)
    if float(got[0].sum() - args[4].sum()) != float(args[1].sum()):
        fail("telemetry_accum: job histogram mass not conserved")
    path = telemetry_bin.plan(J, M, 64, W, K).path
    log(f"[kernels] telemetry_accum J={J} M={M} win=({W},{K}) ({path} "
        f"path, {'0/1' if unit else '0, 0.5, 1, 2'} weights): bitwise "
        f"equal to the plain version (max abs err {err})")
    return args, err


def dcsim_call(args):
    from repro_torch.kernels import dcsim_step
    return dcsim_step.dcsim_advance(*args, throttle_power_scale=0.6)


def telemetry_call(args):
    from repro_torch.kernels import telemetry_bin
    return telemetry_bin.telemetry_accum(*args)


def engine_inputs(name, seed, dev):
    """The engine kernels' inputs at a main path's shape
    (tests/torch_kernel_inputs.py): the advance at N_MAIN x C_MAIN (both
    clocks) and at the network run's NET_SERVERS x C_MAIN, the binning at
    the engine's J = J*T = JOBS_MAIN (one block) or at 100,003 / 300,009
    (across blocks)."""
    from torch_kernel_inputs import (dcsim_inputs, dcsim_inputs_batched,
                                     tb_inputs, tb_inputs_batched,
                                     torch_args)
    R, n, nj, mj = MC_POINTS[0]
    if name == "dcsim_advance replicas":
        return torch_args(dcsim_inputs_batched(R, n, C_MAIN, seed), dev)
    if name == "telemetry_accum replicas":
        return torch_args(tb_inputs_batched(R, mj, mj, 64, 1, 19, seed),
                          dev)
    if name == "dcsim_advance":
        return torch_args(dcsim_inputs(N_MAIN, C_MAIN, seed), dev)
    if name == "dcsim_advance f64":
        return torch_args(dcsim_inputs(N_MAIN, C_MAIN, seed,
                                       clock=np.float64), dev)
    if name == "dcsim_advance 1024":
        return torch_args(dcsim_inputs(NET_SERVERS, C_MAIN, seed), dev)
    J, M, W = {"telemetry_accum": (JOBS_MAIN, JOBS_MAIN, 1),
               "telemetry_accum large": (100_003, 300_009, 256)}[name]
    return torch_args(tb_inputs(J, M, 64, W, 19, seed), dev)


def engine_repeat_and_graph(name, dev) -> None:
    """Ten calls in a row on the same inputs, every output kept (so no call
    can find an earlier result in reused memory), all bitwise equal to the
    plain version and the reduction's scratch back to empty; then one call
    captured with torch.cuda.graph, replayed on new inputs copied into the
    captured ones, bitwise equal to the eager call on those inputs."""
    from repro_torch.kernels import dcsim_step, ref, telemetry_bin
    dc = name.startswith("dcsim_advance")
    call = dcsim_call if dc else telemetry_call
    args = engine_inputs(name, 21, dev)
    outs = [call(args) for _ in range(10)]
    exp = ref.dcsim_advance_reference(*args, throttle_power_scale=0.6) \
        if dc else ref.telemetry_accum_reference(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, e) for out in outs for g, e in zip(out, exp)):
        fail(f"{name}: ten calls in a row do not all equal the plain version")
    # (ticket, minimum image) must read (0, empty); the binning's ticket 0
    words = dcsim_step.scratch(dev, args[0].dtype).tolist() if dc else \
        [int(telemetry_bin.scratch(dev, 64)[1])]
    if words != ([0, -1] if dc else [0]):
        fail(f"{name}: the reduction's scratch reads {words} after a call, "
             f"not empty")
    fresh = engine_inputs(name, 22, dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call(args)
    for s, f in zip(args, fresh):
        if torch.is_tensor(s):
            s.copy_(f)
    graph.replay()
    eager = call(fresh)
    torch.cuda.synchronize()
    if not all(torch.equal(g, e) for g, e in zip(captured, eager)):
        fail(f"{name}: the CUDA graph's replay differs from the eager call")
    log(f"[kernels] {name}: ten calls in a row bitwise equal to the plain "
        f"version, scratch back to empty; a CUDA-graph capture replayed on "
        f"new inputs equals the eager call bit for bit")


# the engine kernels' timed calls and the seeds of their phase-3 checks
ENGINE_TIMED = {"dcsim_advance": 1, "telemetry_accum": 4,
                "telemetry_accum large": 5}
# the advance's float64 instance at the main farm and the float32 one at
# the network run's farm, and both kernels' batched launches at [mc-main]'s
# 1,024-replica point, timed in a full run only (an older checkout's
# --engine-calls has neither a float64 instance nor a replica axis)
ENGINE_TIMED_MORE = {"dcsim_advance f64": 1, "dcsim_advance 1024": 9,
                     "dcsim_advance replicas": 12,
                     "telemetry_accum replicas": 13}


def engine_call_times(dev, timed=ENGINE_TIMED) -> dict:
    """Each engine kernel's call at its main path's shape (and the binning
    at its cross-block check shape): stream ms (CUDA events), device
    operations per call (exact, from a CUDA graph of one call), device us
    (profiler), the plain version's ms and the bound.  Uses the wrappers'
    signatures and the plain versions only, so an older checkout's package
    runs it as well (--engine-calls)."""
    from repro_torch.kernels import ref
    out = {}
    for name, seed in timed.items():
        a = engine_inputs(name, seed, dev)
        if name.startswith("dcsim_advance"):
            call = dcsim_call
            plain = lambda: ref.dcsim_advance_reference(   # noqa: E731
                *a, throttle_power_scale=0.6)
            res = call(a)
            n_bytes = nbytes(*[x for x in a if torch.is_tensor(x)], *res)
            # per server: C compares, C adds, C selects, ~12 flops of
            # power and accrual, 3 mins (float64 compares and mins on the
            # float64 clock, counted at the f32 rate: a lower bound); a
            # replica batch counts the servers of every replica
            n_srv = a[0].numel() // a[0].shape[-1]
            ops = {"f32 operations": (n_srv * (3 * C_MAIN + 15),
                                      PEAK_F32_OPS_S)}
        else:
            call = telemetry_call
            plain = lambda: ref.telemetry_accum_reference(*a)  # noqa: E731
            res = call(a)
            nnz = int((a[1] != 0).sum() + (a[3] != 0).sum())
            # every weight read, a value only where its weight is not 0
            n_bytes = nbytes(a[1], a[3], *a[4:9], *res) + 4 * nnz
            # per weighted value: max, divide, log (~20 flops), multiply,
            # clamp, add; plus the window row
            ops = {"f32 operations": (nnz * 25 + a[8].numel(),
                                      PEAK_F32_OPS_S)}
        bound, by, op = bound_ms(n_bytes, ops)
        us, n_ops, names, seen = call_device(lambda: call(a))
        out[name] = {"ms": time_ms(lambda: call(a)),
                     "plain_ms": time_ms(plain), "device_us": us,
                     "ops": n_ops, "op_names": names, "seen": seen,
                     "bound_ms": bound,
                     "bound_by": by, "bound_op": op}
    return out


def log_engine_time(name, tm, tail="", tag="[time]") -> None:
    d = tm["device_us"]
    graph = ", ".join(f"{k} x{c}" for k, c in tm["op_names"].items())
    dev = "device time not measured" if d is None else (
        f"{d:.2f} us of device time (profiler, which recorded "
        f"{tm['seen']:g} operations a call), host share "
        f"{tm['ms'] * 1e3 - d:.1f} us")
    log(f"{tag} {name}: {tm['ms'] * 1e3:.1f} us per call on the stream, "
        f"{tm['ops']} device operations per call ({graph}; CUDA graph), "
        f"{dev}; bound {tm['bound_ms'] * 1e3:.4f} us by {tm['bound_op']}; "
        f"plain version {tm['plain_ms'] * 1e3:.1f} us{tail}")


def use_checkout(root: str) -> None:
    """Import the package from the checkout at ``root`` from now on (the
    H100 constants above stay this checkout's)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    sys.path.insert(0, str(pathlib.Path(root).resolve() / "src"))
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]


def engine_calls_of(root: str) -> None:
    """--engine-calls: the engine kernels' calls of the checkout at
    ``root`` (its package and its kernel sources, built under it): each
    call as the full run times it (the kernel's wrapper) and through
    ``kernels.ops``, the engine's entry (a ``torch.library`` op since the
    graph audit); then 10 macro-steps (after 20) of [main]'s and
    [net-main]'s configurations under the profiler (launches, device busy
    and wall a macro-step) and timed in turns without it
    (``dispatch_turns``)."""
    use_checkout(root)
    from repro_torch.core.types import SchedPolicy
    from repro_torch.kernels import build, ops
    build.build_all(("dcsim_step", "telemetry_bin"))
    dev = torch.device("cuda", 0)
    log(f"[calls] package {pathlib.Path(build.__file__).parents[2]}")
    for name, tm in engine_call_times(dev).items():
        log_engine_time(name, tm, tag="[calls]")
    for name, seed in (("dcsim_advance", 1), ("telemetry_accum", 4)):
        a = engine_inputs(name, seed, dev)
        kw = {"throttle_power_scale": 0.6} if name == "dcsim_advance" \
            else {}
        fn = getattr(ops, name)
        log(f"[calls] {name} through kernels.ops: "
            f"{time_ms(lambda: fn(*a, **kw)) * 1e3:.1f} us per call on the "
            f"stream")
    cfg, arr, specs, _ = one_farm_cfg(N_MAIN, JOBS_MAIN)
    runs = [("[main]", cfg, arr, specs, None, None)]
    cfg, arr, specs, tau, topo, _ = case_d_cfg(SchedPolicy.ROUND_ROBIN,
                                                NET_K, NET_JOBS, NET_LAM)
    runs.append(("[net-main]", cfg, arr, specs, topo, tau))
    for tag, cfg, arr, specs, topo, tau in runs:
        prof = profile_window(cfg, arr, specs, dev, topo=topo, tau=tau,
                              tag=tag)
        turns = dispatch_turns(cfg, arr, specs, dev, topo=topo, tau=tau)
        log(f"[calls] {tag}: wall {prof['wall_ms']:.3f} ms a macro-step "
            f"under the profiler; without it, in turns, "
            + "; ".join(f"{v} " + ", ".join(f"{ms:.3f}" for ms in t)
                        + f" ms (median {statistics.median(t):.3f})"
                        for v, t in turns.items()))


def dispatch_turns(cfg, arr, specs, dev, topo=None, tau=None, warm=20,
                   steps=10, rounds=3) -> dict:
    """{variant: [wall ms a macro-step, a round]}: ``steps`` macro-steps
    from one state (after ``warm``; each run on a copy of it), timed on
    the host (ending in a synchronize) in turns, each round starting one
    variant later than the last: "shipped" as the package
    runs them and, where its kernels are ``torch.library`` ops, "direct"
    with ``kernels.ops``' entry points bound to the kernels' wrappers (no
    dispatcher) and "bare" with the engine's regions stubbed out as well
    (the path before the graph audit)."""
    from repro_torch.core import engine
    from repro_torch.kernels import dcsim_step, ops, telemetry_bin
    state, tc = warmed_state(cfg, arr, specs, dev, warm, topo, tau)
    shipped = {n: getattr(ops, n) for n in ("dcsim_advance",
                                            "telemetry_accum")}
    wrappers = {"dcsim_advance": dcsim_step.dcsim_advance,
                "telemetry_accum": telemetry_bin.telemetry_accum}
    region = getattr(engine, "region", None)

    class bare:                              # a region that does nothing
        def __init__(self, name):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    variants = {"shipped": (shipped, region)}
    if hasattr(ops, "NAMESPACE"):
        variants.update(direct=(wrappers, region), bare=(wrappers, bare))
    out = {v: [] for v in variants}
    try:
        names = list(variants)
        for r in range(rounds):
            for v in names[r % len(names):] + names[:r % len(names)]:
                fns, reg = variants[v]
                for n, f in fns.items():
                    setattr(ops, n, f)
                if reg is not None:
                    engine.region = reg
                st = copy.deepcopy(state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    st = engine._step(st, cfg, tc)
                torch.cuda.synchronize()
                out[v].append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        for n, f in shipped.items():
            setattr(ops, n, f)
        if region is not None:
            engine.region = region
    return out




# --------------------------------------------------------------------------
# phases 4-5: the engine
# --------------------------------------------------------------------------

def one_farm_cfg(n_servers, n_jobs, seed=0):
    """benchmarks/bench_engine.py one_farm: Poisson jobs at 50% utilisation,
    10 ms mean service, single-task jobs, ALWAYS_ON, telemetry on."""
    from repro_torch.core import jobs, workload
    from repro_torch.core.types import SimConfig, SleepPolicy, \
        TelemetryConfig
    cfg = SimConfig(n_servers=n_servers, n_cores=4, local_q=64,
                    max_jobs=max(n_jobs, 16), tasks_per_job=1,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=20_000,
                    telemetry=TelemetryConfig(enabled=True))
    rng = np.random.default_rng(seed)
    lam = workload.utilization_to_rate(0.5, 0.01, n_servers, 4)
    arr = workload.poisson_arrivals(lam, n_jobs, seed=seed)
    specs = [jobs.dag_single(rng.exponential(0.01)) for _ in range(n_jobs)]
    return cfg, arr, specs, None


def dag_chain_cfg():
    """A 3-task-chain SINGLE_TIMER scenario (tests/test_engine_oracle.py's
    dag_chain workload with delay timers into S3)."""
    from repro_torch.core import jobs, workload
    from repro_torch.core.types import (SchedPolicy, SimConfig,
                                        SleepPolicy, SrvState)
    cfg = SimConfig(n_servers=4, n_cores=2, max_jobs=128, tasks_per_job=3,
                    sched_policy=SchedPolicy.LOAD_BALANCE,
                    sleep_policy=SleepPolicy.SINGLE_TIMER,
                    sleep_state=SrvState.S3, max_events=50_000)
    rng = np.random.default_rng(13)
    arr = workload.poisson_arrivals(40.0, 80, seed=6)
    specs = [jobs.dag_chain(rng.exponential(0.01, size=3))
             for _ in range(80)]
    return cfg, arr, specs, 0.05


def case_d_cfg(policy, k, n_jobs, lam):
    """benchmarks/case_d_network.py at a fat-tree of arity k, n_jobs jobs
    arriving at ``lam`` a second (made by tests/torch_kernel_inputs.py).
    Returns (cfg, arr, specs, tau, topology, seconds the scenario took to
    build on the host, nearly all of it the topology's routes)."""
    from repro_torch.core import jobs, topology
    from repro_torch.core.types import SimConfig
    from torch_kernel_inputs import case_d_scenario
    t0 = time.perf_counter()
    kw, arr, specs, tau, topo = case_d_scenario(jobs, topology, policy, k,
                                                n_jobs, lam)
    return SimConfig(**kw), arr, specs, tau, topo, time.perf_counter() - t0


def star_cfg(max_flows):
    """tests/test_network_flows.py's star (made by
    tests/torch_kernel_inputs.py); ``max_flows=2`` runs out of flow slots
    and drop-resolves edges."""
    from repro_torch.core import jobs, topology
    from repro_torch.core.types import SimConfig
    from torch_kernel_inputs import star_scenario
    kw, arr, specs, tau, topo = star_scenario(jobs, topology, max_flows)
    return SimConfig(**kw), arr, specs, tau, topo


def thermal_main_cfg(n_servers, n_jobs=JOBS_MAIN):
    """The thermal slice's main configuration (tests/torch_kernel_inputs.py
    thermal_main_scenario: bench_engine.control_plane_farm with throttling
    armed), with telemetry windows of 1 s so that the 256 windows cover
    the run's ~88 simulated seconds."""
    from repro_torch.core import jobs, workload
    from repro_torch.core.types import (SimConfig, TelemetryConfig,
                                        ThermalConfig)
    from torch_kernel_inputs import thermal_main_scenario
    kw, th, arr, specs = thermal_main_scenario(jobs, workload, n_servers,
                                               n_jobs)
    return SimConfig(**kw, thermal=ThermalConfig(**th),
                     telemetry=TelemetryConfig(window_dt=1.0)), arr, specs, \
        None


def thermal_case_cfg():
    """examples/thermal_case.py's THERMAL_AWARE scenario behind its throttle
    guard, 500 jobs, trace off (tests/torch_kernel_inputs.py)."""
    from repro_torch.core import jobs, workload
    from repro_torch.core.types import (SimConfig, TelemetryConfig,
                                        ThermalConfig)
    from torch_kernel_inputs import thermal_case_scenario
    kw, th, tel, arr, specs, tau = thermal_case_scenario(jobs, workload)
    return SimConfig(**kw, thermal=ThermalConfig(**th),
                     telemetry=TelemetryConfig(**tel)), arr, specs, tau


def rich_trace_cfg(capacity):
    """tests/test_trace.py's rich scenario: 6 servers x 2 cores, delay
    timers (tau = 0.05 s) into S3, throttling at 50/45 C, K=8, the
    flight recorder on with ``capacity`` slots."""
    from repro_torch.core.types import (SimConfig, SleepPolicy, SrvState,
                                        ThermalConfig, TraceConfig)
    th = ThermalConfig(enabled=True, r_th=0.5, tau_th=2.0, t_inlet=22.0,
                       recirc=0.2, rack_size=3, t_throttle=50.0,
                       t_release=45.0, throttle_freq=0.5,
                       throttle_power_scale=0.6, carbon_period=600.0,
                       price_period=600.0)
    return SimConfig(n_servers=6, n_cores=2, max_jobs=256, tasks_per_job=1,
                     sleep_policy=SleepPolicy.SINGLE_TIMER,
                     sleep_state=SrvState.S3, max_events=60_000, thermal=th,
                     trace=TraceConfig(enabled=True, capacity=capacity))


def rich_trace_inputs():
    """The rich scenario's 150 Poisson jobs (60/s, 20 ms mean service) and
    its timer: (arr, specs, tau)."""
    from repro_torch.core import jobs, workload
    rng = np.random.default_rng(7)
    arr = workload.poisson_arrivals(60.0, 150, seed=3)
    return arr, [jobs.dag_single(s) for s in rng.exponential(0.02, 150)], \
        0.05


def run_engine(cfg, arr, specs, tau, dev, topo=None):
    from repro_torch.core import engine, jobs
    jt = jobs.build_jobs(cfg, np.asarray(arr), specs, device=dev)
    state, tc = engine.init_state(cfg, jt, topo)
    if tau is not None:
        state.farm.srv_tau = torch.full_like(state.farm.srv_tau, tau)
    return engine.run(state, cfg, tc)


def ring_diff(name, g, c, exact: bool) -> str:
    """Two rings (card, CPU) record for record: kind, server and tid
    exactly; time and aux exactly (``exact``) or within rtol 1e-5, as
    every float leaf.  Returns a note for the parity line."""
    if not torch.equal(g[:, [0, 2, 3]], c[:, [0, 2, 3]]):
        fail(f"parity {name}: the rings' kind/server/tid differ")
    if torch.equal(g, c):
        return "bit-equal"
    if exact:
        fail(f"parity {name}: the rings' time/aux columns differ")
    if not torch.allclose(g, c, rtol=1e-5, atol=0.0):
        fail(f"parity {name}: the rings' time/aux beyond rtol 1e-5")
    rel = ((g - c).abs() / c.abs().clamp(min=1e-30)).max()
    return f"time/aux within rel {float(rel):.3g}"


def parity(name, cfg, arr, specs, tau, dev, topo=None, tag="[parity]",
           ring_exact=False):
    from repro_torch.core import traceio
    from repro_torch.core.types import TraceKind, tree_leaves
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    cpu = run_engine(cfg, arr, specs, tau, "cpu", topo)
    t_cpu = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gpu = run_engine(cfg, arr, specs, tau, dev, topo)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    counts = ops.launch_counts()
    worst, ring = 0.0, ""
    for (path, g), (_, c) in zip(tree_leaves(gpu), tree_leaves(cpu)):
        g = g.cpu()
        if path == "trace.buf":
            ring = ring_diff(name, g, c, ring_exact)
        elif g.dtype.is_floating_point and path not in ("telem.job_hist",
                                                        "telem.task_hist"):
            # float reductions (window power sums) run in another order
            # on the card; everything else repeats the CPU's arithmetic
            if not torch.allclose(g, c, rtol=1e-5, atol=0.0):
                fail(f"parity {name}: {path} beyond rtol 1e-5")
            if g.numel():
                rel = ((g - c).abs() / c.abs().clamp(min=1e-30)).max()
                worst = max(worst, float(rel))
        elif not torch.equal(g, c):
            # discrete state, and histograms of exact integer counts
            fail(f"parity {name}: {path} differs between card and CPU")
    steps, events = int(gpu.steps), int(gpu.events)
    clock = str(cfg.time_dtype).removeprefix("torch.")
    from repro_torch.kernels import dcsim_step
    if dcsim_step.CLOCK_LAUNCHES[clock] != counts["dcsim_advance"]:
        fail(f"parity {name}: the advance's {clock} instance launched "
             f"{dcsim_step.CLOCK_LAUNCHES[clock]} of "
             f"{counts['dcsim_advance']} times")
    if counts["telemetry_accum"] != steps:
        fail(f"parity {name}: telemetry_accum launched "
             f"{counts['telemetry_accum']} times in {steps} steps")
    if counts["dcsim_advance"] != steps * cfg.events_per_step:
        fail(f"parity {name}: dcsim_advance launched "
             f"{counts['dcsim_advance']} times, expected steps x K = "
             f"{steps} x {cfg.events_per_step}")
    if not bool(gpu.done):
        fail(f"parity {name}: the run did not finish")
    net = ""
    if cfg.has_network:
        net = (f"; flows dropped {int(gpu.flows.flows_dropped)}, switch "
               f"energy {float(gpu.net.sw_energy.sum()):.4f} J")
    if cfg.thermal.enabled:
        th = gpu.thermal
        net += (f"; throttle seconds {float(th.throttle_seconds.sum()):.3f}"
                f", jobs deferred {int(th.defer_count)}, peak "
                f"{float(th.t_peak.max()):.4f} C, setpoints "
                f"{sorted(set(th.t_set.cpu().tolist()))[:6]}")
    if clock != "float32":
        net += f"; {clock} clock"
    if cfg.trace.enabled:
        ev, n_drop = traceio.decode(gpu.trace, cfg)
        kinds = np.bincount(ev["kind"], minlength=TraceKind.NUM)
        net += (f"; ring {int(gpu.trace.ptr)} records ({ring}), {n_drop} "
                f"dropped, by kind " + ", ".join(
                    f"{TraceKind.NAMES[k]} {n}" for k, n in enumerate(kinds)
                    if n))
    log(f"{tag} {name}: card == CPU (discrete exact, floats max rel err "
        f"{worst:.3g}); events {events}, steps {steps}, advance launches "
        f"{counts['dcsim_advance']} (steps x K), telemetry launches "
        f"{counts['telemetry_accum']}; CPU {t_cpu:.2f} s, card "
        f"{t_gpu:.2f} s{net}")
    return gpu


def report_profile(tag, ks, wall, ours, steps=1, unit="macro-step"):
    """Print a profiler window: device busy share of the wall clock,
    launches, the top kernels and the share of the hand-written kernels
    whose names contain one of ``ours``.  Returns {"busy_us", "launches"}
    a ``unit`` (None when the profiler recorded no device time) and
    "wall_ms" a ``unit`` under the profiler."""
    busy_us = sum(t for _, t in ks.values())
    out = {"busy_us": None, "launches": None, "wall_ms": wall * 1e3 / steps}
    if busy_us <= 0:
        log(f"[profile] {tag}: the profiler recorded no device time: "
            f"device busy share not measured")
        return out
    n_launch = sum(c for c, _ in ks.values())
    mine = sum(t for k, (_, t) in ks.items() if any(n in k for n in ours))
    log(f"[profile] {tag}: wall {wall * 1e3:.1f} ms under the profiler, "
        f"device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / 1e3 / (wall * 1e3):.1f}% of wall), {n_launch} "
        f"kernel launches ({n_launch / steps:.0f} per {unit}); the "
        f"hand-written kernels take {100 * mine / busy_us:.1f}% of the "
        f"device time")
    for k, (c, t) in sorted(ks.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[profile]   {t / 1e3:8.3f} ms {c:6d} calls  {k[:90]}")
    out.update(busy_us=busy_us / steps, launches=n_launch / steps)
    return out


def warmed_state(cfg, arr, specs, dev, warm, topo=None, tau=None):
    """(state, engine constants) of a main run after ``warm`` macro-steps,
    each the step ``engine.run`` takes."""
    from repro_torch.core import engine, jobs, trace
    jt = jobs.build_jobs(cfg, np.asarray(arr), specs, device=dev)
    state, tc = engine.init_state(cfg, jt, topo)
    if tau is not None:
        state.farm.srv_tau = torch.full_like(state.farm.srv_tau, tau)
    if cfg.trace.enabled:
        state.trace = trace.own(state.trace, cfg)
    for _ in range(warm):
        state = engine._step(state, cfg, tc)
    return state, tc


def profile_window(cfg, arr, specs, dev, warm: int = 20, steps: int = 10,
                   topo=None, tau=None, tag="main run"):
    """Where a macro-step's time goes: ``steps`` macro-steps of a main
    run (after ``warm``) under torch.profiler, each the step
    ``engine.run`` takes (a traced step writes the ring in place, with no
    copy of it).  Returns report_profile's dict."""
    from repro_torch.core import engine
    box = list(warmed_state(cfg, arr, specs, dev, warm, topo, tau))

    def window():
        for _ in range(steps):
            box[0] = engine._step(box[0], cfg, box[1])

    ks, wall = device_kernels(window)
    return report_profile(f"{tag}, {steps} macro-steps after {warm}", ks,
                          wall, ("dcsim", "telemetry_bin"), steps)


def net_main(dev):
    """The network main run through the user's entry point:
    farm.simulate(cfg, arr, specs, topo=fat_tree(16), tau=0.2) on the card.
    The flows are counted where the engine completes them: a wrapper of
    network.complete_flows adds up its ``fin`` mask on the device.  Only
    the full step, which is never discarded, completes flows (a cheap
    pass may compute a spawn and be thrown away), and a run ends with no
    flow in flight, so the count is the flows spawned and delivered.
    Returns (launch counts, cfg, arr, specs, topology)."""
    from repro_torch.core import farm, network
    from repro_torch.core.types import SchedPolicy
    from repro_torch.kernels import ops
    cfg, arr, specs, tau, topo, t_topo = case_d_cfg(
        SchedPolicy.ROUND_ROBIN, NET_K, NET_JOBS, NET_LAM)
    log(f"[net-main] fat_tree k={NET_K}: {topo.n_servers} servers, "
        f"{topo.n_switches} switches, {topo.n_links} links, {topo.n_ports} "
        f"ports and {topo.n_linecards} line cards a switch, routes "
        f"{(topo.routes.nbytes + topo.route_sw.nbytes) / 2**20:.1f} MiB; "
        f"scenario (routes, job specs) built on the host in {t_topo:.2f} "
        f"s")
    if topo.n_servers != NET_SERVERS or cfg.n_cores != C_MAIN:
        fail(f"net-main: {topo.n_servers} x {cfg.n_cores}, but phase 3 "
             f"checks the advance at {NET_SERVERS} x {C_MAIN}")
    n_fin, complete = [], network.complete_flows

    def counted_complete(*a, **k):
        flows, fin = complete(*a, **k)
        n_fin.append(fin.sum(dtype=torch.int32))
        return flows, fin

    network.complete_flows = counted_complete
    ops.reset_launch_counts()
    try:
        res = farm.simulate(cfg, arr, specs, topo=topo, tau=tau)
    finally:
        network.complete_flows = complete
    counts = ops.launch_counts()
    ri = res.run_info
    if res.n_finished != NET_JOBS:
        fail(f"net-main finished {res.n_finished} of {NET_JOBS} jobs")
    if res.flows_dropped != 0:
        fail(f"net-main dropped {res.flows_dropped} flows")
    lat = res.latencies
    # round-robin splits every chain: each ships 100 MB at 1.25 GB/s
    if not (np.isfinite(lat).all() and (lat >= 100e6 / 1.25e9).all()
            and np.isfinite(res.server_energy) and res.server_energy > 0
            and np.isfinite(res.switch_energy) and res.switch_energy > 0):
        fail("net-main produced non-finite or impossible results")
    if res.telemetry.jobs_binned != NET_JOBS:
        fail(f"net-main binned {res.telemetry.jobs_binned} job latencies")
    if counts["telemetry_accum"] != ri.steps or \
            counts["dcsim_advance"] != ri.steps * cfg.events_per_step:
        fail(f"net-main launch counts {counts} for {ri.steps} steps")
    # round-robin places a chain's two tasks on two servers: one flow each
    spawned = int(torch.stack(n_fin).sum())
    if spawned != NET_JOBS:
        fail(f"net-main delivered {spawned} flows for {NET_JOBS} chains")
    tel = res.telemetry
    win_j = float(np.nansum(tel.switch_power * tel.occupancy))
    rel = abs(win_j - res.switch_energy) / res.switch_energy
    if rel > 1e-4:
        fail(f"net-main: switch-power windows integrate to {win_j} J, the "
             f"switch energy is {res.switch_energy} J (rel {rel:.3g})")
    log(f"[net-main] case D round-robin, {NET_JOBS} jobs at {NET_LAM:g}/s: "
        f"wall {ri.wall_s:.3f} s, events {ri.events}, steps {ri.steps}, "
        f"{ri.events_per_s:.1f} events/s; flows spawned and delivered "
        f"{spawned} (counted as they complete), dropped "
        f"{res.flows_dropped}; mean latency {res.mean_latency * 1e3:.3f} "
        f"ms, p99 {res.p99_latency * 1e3:.3f} ms; server energy "
        f"{res.server_energy:.1f} J, switch energy "
        f"{res.switch_energy:.4f} J, windows integrate to {win_j:.4f} J "
        f"(rel {rel:.3g}); sim time {res.sim_time:.4f} s; launches "
        f"{counts}")
    return counts, cfg, arr, specs, tau, topo


def thermal_main(dev):
    """The thermal main run through the user's entry point: farm.simulate
    of thermal_main_cfg(N_MAIN) on the card.  Returns (launch counts, cfg,
    arr, specs, result)."""
    from repro_torch.core import farm
    from repro_torch.kernels import ops
    cfg, arr, specs, _ = thermal_main_cfg(N_MAIN)
    ops.reset_launch_counts()
    res = farm.simulate(cfg, arr, specs)
    counts = ops.launch_counts()
    ri = res.run_info
    if res.n_finished != JOBS_MAIN:
        fail(f"thermal-main finished {res.n_finished} of {JOBS_MAIN} jobs")
    if not res.deferred_jobs > 0:
        fail("thermal-main deferred no job")
    if not res.throttle_seconds > 0:
        fail("thermal-main throttled no server")
    if np.all(res.setpoints == cfg.thermal.t_setpoint):
        fail("thermal-main: the setpoint controller left every setpoint at "
             f"{cfg.thermal.t_setpoint} C")
    lat = res.latencies
    if not (np.isfinite(lat).all() and (lat > 0).all()
            and np.isfinite(res.temps).all() and res.cooling_energy > 0
            and res.carbon_g > 0 and res.energy_cost > 0):
        fail("thermal-main produced non-finite or impossible results")
    tel = res.telemetry
    if tel.win_overflow > 0:
        fail(f"thermal-main outlived its telemetry windows by "
             f"{tel.win_overflow} s")
    win_j = float(np.nansum(tel.cooling_power * tel.occupancy))
    rel = abs(win_j - res.cooling_energy) / res.cooling_energy
    if rel > 1e-4:
        fail(f"thermal-main: cooling-power windows integrate to {win_j} J, "
             f"the cooling energy is {res.cooling_energy} J (rel {rel:.3g})")
    if counts["telemetry_accum"] != ri.steps or \
            counts["dcsim_advance"] != ri.steps * cfg.events_per_step:
        fail(f"thermal-main launch counts {counts} for {ri.steps} steps")
    n_thr = int((res.peak_temps >= cfg.thermal.t_throttle - 1e-3).sum())
    log(f"[thermal-main] {N_MAIN} servers x {C_MAIN} cores, {JOBS_MAIN} jobs "
        f"(every second one deferrable), CARBON_AWARE, throttling at "
        f"{cfg.thermal.t_throttle}/{cfg.thermal.t_release} C: wall "
        f"{ri.wall_s:.3f} s, events {ri.events}, steps {ri.steps}, "
        f"{ri.events_per_s:.1f} events/s; sim time {res.sim_time:.4f} s; "
        f"jobs deferred {res.deferred_jobs} for {res.deferred_seconds:.2f} "
        f"s in all; throttle {res.throttle_seconds:.1f} server-seconds, "
        f"{n_thr} servers reached the threshold; peak {res.peak_temp:.4f} "
        f"C, final mean {res.mean_temp:.4f} C; setpoints "
        f"{res.setpoints.min():g}..{res.setpoints.max():g} C; cooling "
        f"{res.cooling_energy:.1f} J, windows integrate to {win_j:.1f} J "
        f"(rel {rel:.3g}); server energy {res.server_energy:.1f} J, carbon "
        f"{res.carbon_g:.2f} g, cost ${res.energy_cost:.5f}; mean latency "
        f"{res.mean_latency:.3f} s; launches {counts}")
    return counts, cfg, arr, specs, res


# benchmarks/trace_smoke.py's schema check (that file imports the JAX
# package): the fields each phase of an entry must carry
TRACE_PHASES = {"X": ("name", "ts", "dur", "pid", "tid"),
                "i": ("name", "ts", "pid", "tid"),
                "C": ("name", "ts", "args"),
                "M": ("name", "args")}


def chrome_schema_errors(doc, ev) -> list:
    """benchmarks/trace_smoke.py validate(), plus its check that the task
    spans cover every FINISH record of the ring."""
    from repro_torch.core.types import TraceKind
    if not isinstance(doc, dict) or not doc.get("traceEvents"):
        return ["the document is not an object with a non-empty traceEvents"]
    errors, n_by_phase = [], {}
    for i, e in enumerate(doc["traceEvents"]):
        ph = e.get("ph")
        if ph is None:
            errors.append(f"entry {i}: missing 'ph'")
            continue
        n_by_phase[ph] = n_by_phase.get(ph, 0) + 1
        errors += [f"entry {i} (ph={ph}): missing '{f}'"
                   for f in TRACE_PHASES.get(ph, ()) if f not in e]
        if ph == "X" and e.get("dur", 0) < 0:
            errors.append(f"entry {i}: negative duration {e['dur']}")
    errors += [f"no '{ph}' entries" for ph in ("M", "X")
               if not n_by_phase.get(ph)]
    n_fin = int((ev["kind"] == TraceKind.FINISH).sum())
    if n_by_phase.get("X", 0) < n_fin:
        errors.append(f"{n_by_phase.get('X', 0)} task spans < {n_fin} "
                      f"FINISH records")
    return errors


def windows_in_turns(cfgs, arr, specs, dev, warm=20, steps=10, rounds=4):
    """Host wall (ending in a synchronize) of ``steps`` macro-steps of
    each configuration in ``cfgs`` ({name: cfg}), in turns (a b b a a b b
    a ...), each from its own state after ``warm`` steps, so the k-th
    window of every configuration covers the same macro-steps: two
    versions compared inside one call on one card.  Each step is the one
    ``engine.run`` takes.  Returns {name: [seconds a window]}."""
    from repro_torch.core import engine, jobs, trace
    boxes = {}
    for name, cfg in cfgs.items():
        jt = jobs.build_jobs(cfg, np.asarray(arr), specs, device=dev)
        st, tc = engine.init_state(cfg, jt)
        if cfg.trace.enabled:
            st.trace = trace.own(st.trace, cfg)
        for _ in range(warm):
            st = engine._step(st, cfg, tc)
        boxes[name] = [st, tc, cfg]
    names = list(cfgs)
    secs = {n: [] for n in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            st, tc, cfg = boxes[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                st = engine._step(st, cfg, tc)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            boxes[name][0] = st
    return secs


def trace_main(dev, th):
    """[trace-main]: the thermal main run through farm.simulate with the
    flight recorder on.  ``th`` is [thermal-main]'s (launch counts, cfg,
    arr, specs, result); the traced run must leave every result of it as
    it was.  Returns (launch counts, cfg)."""
    import tempfile
    from repro_torch.core import engine, farm, traceio
    from repro_torch.core.types import TraceConfig, TraceKind
    from repro_torch.kernels import ops
    _, th_cfg, arr, specs, off = th
    cap = TRACE_CAP
    finals, run = [], engine.run

    def caught_run(*a, **k):
        finals.append(run(*a, **k))
        return finals[-1]

    while True:
        cfg = dataclasses.replace(th_cfg, trace=TraceConfig(enabled=True,
                                                            capacity=cap))
        engine.run = caught_run
        ops.reset_launch_counts()
        try:
            res = farm.simulate(cfg, arr, specs)
        finally:
            engine.run = run
        counts = ops.launch_counts()
        ptr = int(finals[-1].trace.ptr)
        if res.trace_dropped == 0:
            break
        cap = 1 << (ptr - 1).bit_length()
        log(f"[trace-main] {ptr} records overflowed a {cfg.trace.capacity}-"
            f"slot ring; rerunning with {cap} slots")
    final, ri = finals[-1], res.run_info
    ev = res.trace_events
    kinds = np.bincount(ev["kind"], minlength=TraceKind.NUM)
    K = TraceKind
    want = {K.ARRIVAL: JOBS_MAIN, K.ADMIT: JOBS_MAIN,
            K.RELEASE: res.deferred_jobs, K.START: JOBS_MAIN,
            K.FINISH: JOBS_MAIN, K.JOB_FINISH: JOBS_MAIN}
    if res.n_finished != JOBS_MAIN:
        fail(f"trace-main finished {res.n_finished} of {JOBS_MAIN} jobs")
    if ptr != len(ev):
        fail(f"trace-main: ptr {ptr} but {len(ev)} decoded records")
    for k, n in want.items():
        if kinds[k] != n:
            fail(f"trace-main: {kinds[k]} {K.NAMES[k]} records, expected {n}")
    if not (kinds[K.THROTTLE_CROSSING] > 0 and kinds[K.CTRL_TICK] > 0):
        fail("trace-main recorded no throttle crossing or no controller tick")
    if counts["telemetry_accum"] != ri.steps or \
            counts["dcsim_advance"] != ri.steps * cfg.events_per_step:
        fail(f"trace-main launch counts {counts} for {ri.steps} steps")
    same = {f: (getattr(res, f), getattr(off, f)) for f in (
        "events", "server_energy", "cooling_energy", "carbon_g",
        "energy_cost", "throttle_seconds", "deferred_jobs", "sim_time")}
    same["steps"] = (ri.steps, off.run_info.steps)
    same["setpoints"] = (res.setpoints.tolist(), off.setpoints.tolist())
    bad = [f for f, (a, b) in same.items() if a != b]
    if bad:
        # is the untraced run itself repeatable on the card?
        again = farm.simulate(th_cfg, arr, specs)
        rep = all(getattr(again, f) == getattr(off, f) for f in (
            "events", "server_energy", "cooling_energy", "throttle_seconds"))
        fail(f"trace-main: {bad} differ from [thermal-main]'s "
             f"({ {f: same[f] for f in bad} }); a second untraced run "
             f"{'repeats' if rep else 'does not repeat'} [thermal-main]")
    t0 = time.perf_counter()
    ev2, n_drop = traceio.decode(final.trace, cfg)
    t_dec = time.perf_counter() - t0
    if not np.array_equal(ev2, ev):
        fail("trace-main: decode is not repeatable")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        t0 = time.perf_counter()
        traceio.save_chrome_trace(str(path), ev, cfg, state=final,
                                  n_dropped=n_drop)
        t_exp = time.perf_counter() - t0
        mb = path.stat().st_size / 2**20
        t0 = time.perf_counter()
        doc = json.loads(path.read_text())
        t_load = time.perf_counter() - t0
    errors = chrome_schema_errors(doc, ev)
    if errors:
        fail(f"trace-main: the Chrome export breaks the schema: {errors[:5]}")
    n_x = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
    ow = off.run_info
    buf = final.trace.buf
    log(f"[trace-main] the thermal main run with a {cfg.trace.capacity}-slot "
        f"ring ({buf.numel() * buf.element_size() / 2**20:.1f} MiB): "
        f"wall {ri.wall_s:.3f} s, events {ri.events}, steps {ri.steps}, "
        f"{ri.events_per_s:.1f} events/s; overhead against "
        f"[thermal-main] ({ow.wall_s:.3f} s, {ow.events_per_s:.1f} events/s): "
        f"wall {100 * (ri.wall_s / ow.wall_s - 1):+.1f}%, events/s "
        f"{100 * (ri.events_per_s / ow.events_per_s - 1):+.1f}%; every "
        f"result equal to [thermal-main]'s ({', '.join(same)})")
    log(f"[trace-main] ring: {ptr} records, {n_drop} dropped, by kind " +
        ", ".join(f"{K.NAMES[k]} {n}" for k, n in enumerate(kinds) if n))
    log(f"[trace-main] host: decode {t_dec:.3f} s; Chrome export "
        f"{t_exp:.3f} s ({len(doc['traceEvents'])} entries, {n_x} task "
        f"spans, {mb:.1f} MiB), reloaded in {t_load:.3f} s, schema valid; "
        f"launches {counts}")
    # the two whole runs above ran one after the other, and this host's
    # wall clock wanders between runs: the overhead in turns, on the same
    # macro-steps
    secs = windows_in_turns({"off": th_cfg, "on": cfg}, arr, specs, dev)
    ratio = [b / a for a, b in zip(secs["off"], secs["on"])]
    log(f"[trace-main] in turns, 10 macro-steps a window from step 20: "
        f"untraced {[round(x, 4) for x in secs['off']]} s, traced "
        f"{[round(x, 4) for x in secs['on']]} s; traced/untraced per "
        f"window {[round(x, 4) for x in ratio]}, median "
        f"{statistics.median(ratio):.4f} "
        f"({100 * (statistics.median(ratio) - 1):+.1f}%)")
    return counts, cfg


# --------------------------------------------------------------------------
# replica sweeps (core/montecarlo.py): batched kernels, card vs CPU, the
# replica main run
# --------------------------------------------------------------------------

ADVANCE_OUT = ("new_busy", "done", "energy", "busy_seconds", "candidate")


def mc_kernels(dev) -> dict:
    """[mc-kernels]: each kernel's batched launch against its plain version
    on the card, bitwise, at MC_ADVANCE on both clocks (replica 1 of every
    batch an all-INF farm, whose candidate is INF) and at MC_BINNING;
    one launch a call whatever R, the advance's per-replica scratch back
    to empty after it.  Returns {kernel: largest abs error} (0.0)."""
    from repro_torch.kernels import dcsim_step, ref, telemetry_bin
    from torch_kernel_inputs import (dcsim_inputs_batched, tb_inputs_batched,
                                     torch_args)
    sms = dcsim_step.sm_count(dev)
    for R, n in MC_ADVANCE:
        for clock in (np.float32, np.float64):
            a = torch_args(dcsim_inputs_batched(
                R, n, C_MAIN, 40 + R, clock=clock,
                inf_replica=1 if R > 1 else None), dev)
            before = dcsim_step.LAUNCHES
            got = dcsim_step.dcsim_advance(*a, throttle_power_scale=0.6)
            launches = dcsim_step.LAUNCHES - before
            exp = ref.dcsim_advance_reference(*a, throttle_power_scale=0.6)
            torch.cuda.synchronize()
            for name, g, e in zip(ADVANCE_OUT, got, exp):
                if g.shape != e.shape or g.dtype != e.dtype \
                        or not torch.equal(g, e):
                    fail(f"mc-kernels: dcsim_advance R={R} N={n} "
                         f"{clock.__name__}: {name} differs from the plain "
                         f"version")
            words = dcsim_step.scratch(dev, a[0].dtype, R).tolist()
            if launches != 1 or words != [0] * R + [-1] * R:
                fail(f"mc-kernels: dcsim_advance R={R} N={n}: {launches} "
                     f"launches, scratch {words[:4]}...")
            p = dcsim_step.plan(n, C_MAIN, sms=sms, replicas=R,
                                f64=clock == np.float64)
            inf = "" if R == 1 else (
                f"; replica 1's candidate {float(got[4][1]):.3g} (all INF)")
            log(f"[mc-kernels] dcsim_advance R={R} x N={n} x C={C_MAIN} "
                f"({clock.__name__} clock): one launch of {p.grid} x {R} "
                f"blocks of {p.block} threads, bitwise equal to the plain "
                f"version{inf}")
    for R, J in MC_BINNING:
        a = torch_args(tb_inputs_batched(R, J, J, 64, 1, 19, 50 + R), dev)
        before = telemetry_bin.LAUNCHES
        got = telemetry_bin.telemetry_accum(*a)
        launches = telemetry_bin.LAUNCHES - before
        exp = ref.telemetry_accum_reference(*a)
        torch.cuda.synchronize()
        for name, g, e in zip(("job_hist", "task_hist", "win"), got, exp):
            if g.shape != e.shape or not torch.equal(g, e):
                fail(f"mc-kernels: telemetry_accum R={R} J={J}: {name} "
                     f"differs from the plain version")
        if launches != 1:
            fail(f"mc-kernels: telemetry_accum R={R}: {launches} launches")
        p = telemetry_bin.plan(J, J, 64, 1, 19, sms=sms, replicas=R)
        log(f"[mc-kernels] telemetry_accum R={R} x J={J} (J*T={J}): one "
            f"launch of {p.grid} x {R} blocks of {p.block} threads "
            f"({p.path} path), bitwise equal to the plain version")
    return {"dcsim_advance": 0.0, "telemetry_accum": 0.0}


def ulps(got: torch.Tensor, exp: torch.Tensor) -> float:
    """Largest |got - exp| in units of exp's last place (0 where equal)."""
    if got.numel() == 0:
        return 0.0
    e = exp.abs()
    up = (torch.nextafter(e, torch.full_like(e, math.inf)) - e).double()
    return float(((got.double() - exp.double()).abs() / up).max())


def mc_parity(name, dev) -> None:
    """[mc-parity]: a replica scenario on the card against the CPU (the
    engine's limits: discrete state and histograms exact, floats rtol
    1e-5; every replica's ring bit-equal), and each replica of the card's
    batch against a solo run of its inputs on the card (discrete exact,
    floats rtol 1e-5, the largest ulp difference printed)."""
    from repro_torch.core import engine, jobs, montecarlo, topology, types
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import ops
    from torch_kernel_inputs import mc_config, mc_scenario
    kw, nested, arrs, specs, taus, net = mc_scenario(name, jobs)
    cfg = mc_config(types, kw, nested)
    topo = topology.fat_tree(4, link_cap=1.25e9) if net else None
    runs = {}
    for d in ("cpu", dev):
        sb, tc = montecarlo.batched_state(cfg, arrs, specs, taus=taus,
                                          topo=topo, device=d)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = montecarlo.run_replicas(cfg, sb, tc)
        if d != "cpu":
            torch.cuda.synchronize()
        runs[str(d)] = (sb, tc, out, ops.launch_counts(),
                        time.perf_counter() - t0)
    sb, tc, gpu, counts, t_gpu = runs[str(dev)]
    cpu, t_cpu = runs["cpu"][2], runs["cpu"][4]
    R = arrs.shape[0]
    worst, ring = 0.0, ""
    for (path, g), (_, c) in zip(tree_leaves(gpu), tree_leaves(cpu)):
        g = g.cpu()
        if path == "trace.buf" and cfg.trace.enabled:
            ring = ", ".join(ring_diff(f"{name} replica {r}", g[r], c[r],
                                       True) for r in range(R))
        elif g.dtype.is_floating_point and path not in ("telem.job_hist",
                                                        "telem.task_hist"):
            if not torch.allclose(g, c, rtol=1e-5, atol=0.0):
                fail(f"mc-parity {name}: {path} beyond rtol 1e-5")
            if g.numel():
                rel = ((g - c).abs() / c.abs().clamp(min=1e-30)).max()
                worst = max(worst, float(rel))
        elif not torch.equal(g, c):
            fail(f"mc-parity {name}: {path} differs between card and CPU")
    steps = int(gpu.steps.max())
    if counts["dcsim_advance"] != steps * cfg.events_per_step or (
            cfg.telemetry.enabled and counts["telemetry_accum"] != steps):
        fail(f"mc-parity {name}: launches {counts} for {steps} macro-steps")
    solo_ulp = 0.0
    for r in range(R):
        solo = engine.run(montecarlo.replica_state(sb, r), cfg, tc)
        rep = montecarlo.replica_state(gpu, r)
        for (path, g), (_, s) in zip(tree_leaves(rep), tree_leaves(solo)):
            if g.dtype.is_floating_point:
                if not torch.allclose(g, s, rtol=1e-5, atol=0.0):
                    fail(f"mc-parity {name}: replica {r} {path} beyond rtol "
                         f"1e-5 of its solo run")
                solo_ulp = max(solo_ulp, ulps(g, s))
            elif not torch.equal(g, s):
                fail(f"mc-parity {name}: replica {r} {path} differs from "
                     f"its solo run")
    st = montecarlo.replica_stats(gpu, cfg)
    more = f"; rings {ring}" if ring else ""
    if cfg.thermal.enabled:
        more += (f"; throttle seconds {np.round(st['throttle_seconds'], 3)}"
                 f", peak {np.round(st['peak_temp'], 3)} C")
    if cfg.has_network:
        more += f"; flows dropped {st['flows_dropped']}"
    log(f"[mc-parity] {name}, R={R}: card == CPU (discrete exact, floats "
        f"max rel err {worst:.3g}); every replica == its solo run on the "
        f"card (discrete exact, floats within {solo_ulp:g} ulp); events "
        f"{gpu.events.tolist()}, steps {gpu.steps.tolist()}, finished "
        f"{st['finished'].tolist()}, mean latency "
        f"{np.round(st['mean_latency'], 6).tolist()}; launches {counts} "
        f"({steps} macro-steps x K={cfg.events_per_step}); CPU {t_cpu:.2f} "
        f"s, card {t_gpu:.2f} s{more}")


def mc_point(R, n_servers, n_jobs, max_jobs):
    """benchmarks/bench_engine.py replica_throughput: R farms of n_servers
    x 4 cores, n_jobs Poisson jobs each at 50% utilisation (arrival seeds
    0..R-1), 10 ms mean exponential service (specs from default_rng(1)),
    ALWAYS_ON, LOAD_BALANCE, telemetry on, K=8, max_events=10,000."""
    from repro_torch.core import jobs, workload
    from repro_torch.core.types import SimConfig, SleepPolicy
    cfg = SimConfig(n_servers=n_servers, n_cores=4, local_q=64,
                    max_jobs=max_jobs, tasks_per_job=1,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=10_000)
    rng = np.random.default_rng(1)
    lam = workload.utilization_to_rate(0.5, 0.01, n_servers, 4)
    arrs = np.stack([workload.poisson_arrivals(lam, n_jobs, seed=s)
                     for s in range(R)])
    specs = [jobs.dag_single(rng.exponential(0.01)) for _ in range(n_jobs)]
    return cfg, arrs, specs


def run_loop_steps(state, cfg, tc, n):
    """``n`` iterations of engine.run's loop body: the active mask, its one
    host read, the masked macro-step (unmasked for a single run)."""
    from repro_torch.core import engine
    for _ in range(n):
        active = ~state.done & (state.events < cfg.max_events)
        bool(active.any())
        state = engine._step(state, cfg, tc,
                             active if active.dim() else None)
    return state


class OpCount:
    """PyTorch operations dispatched (views, which launch nothing, left
    out): the host's count of what a stretch of code sends to the card."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not func.is_view:
                    Mode.n += 1
                return func(*args, **(kwargs or {}))
        self.mode = Mode

    def __call__(self, fn):
        self.mode.n = 0
        with self.mode():
            fn()
        return self.mode.n


def mc_launches(cfg, arrs, specs, dev, warm=3, steps=5):
    """Launches per macro-step of the batch and of a single run of
    replica 0, ``steps`` loop iterations after ``warm``: kernels and
    copies the profiler records (0 when it records no device activity,
    which ``mc_main`` refuses) and the operations dispatched.  Returns
    {"batch"/"single": (profile, wall, launches a step, operations a
    step)}."""
    from repro_torch.core import engine, jobs, montecarlo
    sb, tc = montecarlo.batched_state(cfg, arrs, specs)
    jt = jobs.build_jobs(cfg, arrs[0], specs)
    st, tc1 = engine.init_state(cfg, jt)
    out, count = {}, OpCount()
    for key, s, c in (("batch", sb, tc), ("single", st, tc1)):
        box = [run_loop_steps(s, cfg, c, warm)]

        def window():
            box[0] = run_loop_steps(box[0], cfg, c, steps)
        ks, wall = device_kernels(window)
        n_ops = count(window)
        out[key] = (ks, wall, sum(n for n, _ in ks.values()) / steps,
                    n_ops / steps)
    return out


def mc_main(dev) -> list:
    """[mc-main]: montecarlo.run_replicas on MC_POINTS through the user's
    entry points (batched_state, run_replicas, replica_stats) on the card.
    Every job of every replica must finish, the advance launch K times a
    macro-step and the binning once, and a macro-step of the batch take
    within 3% of the launches of a single run of one replica.  Returns
    one dict a point."""
    from repro_torch.core import montecarlo
    from repro_torch.kernels import ops
    rows = []
    for R, n, nj, mj in MC_POINTS:
        cfg, arrs, specs = mc_point(R, n, nj, mj)
        t0 = time.perf_counter()
        sb, tc = montecarlo.batched_state(cfg, arrs, specs)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = montecarlo.run_replicas(cfg, sb, tc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        st = montecarlo.replica_stats(out, cfg)
        events, steps = int(out.events.sum()), int(out.steps.max())
        K = cfg.events_per_step
        if int(st["finished"].sum()) != R * nj:
            fail(f"mc-main R={R}: {int(st['finished'].sum())} of {R * nj} "
                 f"jobs finished")
        if counts["dcsim_advance"] != K * steps or \
                counts["telemetry_accum"] != steps:
            fail(f"mc-main R={R}: launches {counts} for {steps} macro-steps")
        if not (np.isfinite(st["mean_latency"]).all()
                and (st["energy"] > 0).all()
                and np.isfinite(st["p99_latency"]).all()):
            fail(f"mc-main R={R}: non-finite or impossible statistics")
        prof = mc_launches(cfg, arrs, specs, dev)
        per_b, per_s = prof["batch"][2], prof["single"][2]
        op_b, op_s = prof["batch"][3], prof["single"][3]
        if per_b == 0 or per_s == 0:
            fail(f"mc-main R={R}: the profiler recorded no device activity "
                 f"(batch {per_b:.0f}, replica 0 alone {per_s:.0f} a "
                 f"macro-step)")
        if per_b > 1.03 * per_s:
            fail(f"mc-main R={R}: {per_b:.0f} launches (profiler) a "
                 f"macro-step against {per_s:.0f} for one replica alone")
        if op_b > 1.03 * op_s:
            fail(f"mc-main R={R}: {op_b:.0f} PyTorch operations dispatched "
                 f"a macro-step against {op_s:.0f} for one replica alone")
        log(f"[mc-main] {R} replicas x {n} servers x 4 cores, {nj} jobs "
            f"each: batched_state {t_build:.3f} s; run_replicas wall "
            f"{wall:.3f} s, events {events}, macro-steps {steps}, "
            f"{events / wall:.1f} aggregate events/s; jobs finished "
            f"{int(st['finished'].sum())} of {R * nj}; mean latency over "
            f"replicas {float(st['mean_latency'].mean()) * 1e3:.4f} ms, p99 "
            f"(histograms) {float(np.median(st['p99_latency'])) * 1e3:.4f} "
            f"ms median; energy {float(st['energy'].sum()):.1f} J; "
            f"launches {counts} (advance {counts['dcsim_advance'] / steps:g} "
            f"and binning {counts['telemetry_accum'] / steps:g} a "
            f"macro-step); launches a macro-step (profiler) {per_b:.0f} "
            f"batched against {per_s:.0f} for replica 0 alone "
            f"({100 * (per_b / per_s - 1):+.2f}%), PyTorch operations "
            f"dispatched {op_b:.0f} against {op_s:.0f} "
            f"({100 * (op_b / op_s - 1):+.2f}%)")
        ks, pwall, _, _ = prof["batch"]
        report_profile(f"replica run R={R} x N={n}, 5 macro-steps after 3",
                       ks, pwall, ("dcsim", "telemetry_bin"), 5)
        rows.append(dict(R=R, n=n, counts=counts, steps=steps,
                         events=events, wall=wall))
    return rows


# --------------------------------------------------------------------------
# the graph audit (src/repro_torch/analysis/): [simlint], [simlint-main]
# --------------------------------------------------------------------------

def histogram_diff(a: dict, b: dict) -> list:
    """[(region, op, count in a, count in b)] where two per-region op
    histograms differ."""
    out = []
    for region in sorted(set(a) | set(b)):
        ra, rb = a.get(region, {}), b.get(region, {})
        for op in sorted(set(ra) | set(rb)):
            if ra.get(op, 0) != rb.get(op, 0):
                out.append((region, op, ra.get(op, 0), rb.get(op, 0)))
    return out


def simlint_phase() -> None:
    """[simlint]: every single-device case of the audit matrix
    (src/repro_torch/analysis/matrix.py) recorded on the card, one
    macro-step each: every rule of ``python -m repro_torch.analysis.simlint``
    holds (the histogram's drift against the committed baseline advisory
    under another torch than the baseline's), no host sync in the step,
    each kernel one op node a launch, and the card's per-region histogram
    equal to the CPU's once the CPU's plain versions are folded into their
    nodes.  Then the rebuild sentinel, in a spawned
    process: farm.simulate twice on the plain path and twice with mesh= (K
    = 1 over NCCL), each kernel library loaded once."""
    from repro_torch.analysis import matrix, rules, simlint
    baseline = rules.load_baseline(simlint.DEFAULT_BASELINE)
    advisory = baseline["torch"] != torch.__version__
    t0 = time.perf_counter()
    for name in matrix.SINGLE_DEVICE:
        violations, report, inv = simlint.audit_case(
            matrix.build_case(name), baseline["cases"][name], advisory,
            on_card=True)
        hard = [v for v in violations
                if not (advisory and v.rule == "no-new-ops")]
        if hard:
            fail(f"simlint {name}:\n" + "\n".join(v.render() for v in hard))
        (_, cpu_inv, _, _, _), = simlint.record_case(
            matrix.build_case(name, "cpu"))
        diff = histogram_diff(inv.histogram(), cpu_inv.histogram())
        if diff:
            fail(f"simlint {name}: the card's histogram differs from the "
                 f"CPU's, folded, at (region, op, card, CPU) {diff[:12]}")
        s = report["summary"]
        drift = len(violations) - len(hard)
        log(f"[simlint] {name}: {s['ops']} ops, {s['scatter']} scatters "
            f"({s['scatter_cheap_core']} in cheap_core), kernels "
            f"{s['kernels']} (== launches), {s['host_syncs']} host syncs, "
            f"{s['host_to_device']} host-to-card copies; every rule holds"
            + (f" ({drift} advisory histogram drifts: torch "
               f"{torch.__version__} here, {baseline['torch']} in the "
               f"baseline)" if drift else "")
            + "; card == CPU folded")
    violations, rep = simlint.rebuild_check(None)
    if violations:
        fail("simlint rebuild sentinel:\n"
             + "\n".join(v.render() for v in violations))
    builds = ", ".join(f"{e['tag']} {e['key']} x{e['builds']}"
                       for e in rep["builds"])
    log(f"[simlint] rebuild sentinel (a spawned process; farm.simulate "
        f"twice plain, twice with mesh= over NCCL): {builds}; each built "
        f"once; the phase took {time.perf_counter() - t0:.1f} s")


def simlint_main(dev, main_prof) -> None:
    """[simlint-main]: one macro-step of [main]'s configuration (65,536 x
    4, 600 jobs) recorded on the card: its ops, scatters and host syncs,
    each kernel one node a launch, the cost model's bytes and operations
    and its bound on the H100, against the device time of a macro-step in
    [main]'s profiler window (``main_prof``); and the state footprint the
    cost model predicts on fake tensors against the rise of
    torch.cuda.memory_allocated() across building the job table and
    init_state."""
    from repro_torch.analysis import costmodel, graph_audit, matrix, simlint
    from repro_torch.core import engine, jobs
    from repro_torch.kernels import ops
    cfg, arr, specs, _ = one_farm_cfg(N_MAIN, JOBS_MAIN)
    torch.cuda.synchronize(dev)
    m0 = torch.cuda.memory_allocated(dev)
    jt = jobs.build_jobs(cfg, np.asarray(arr), specs, device=dev)
    state, tc = engine.init_state(cfg, jt)
    torch.cuda.synchronize(dev)
    rise = torch.cuda.memory_allocated(dev) - m0
    fp = matrix.footprint_of(cfg)
    # what the allocator holds for them: each storage rounded up to 512 B
    storages = {x.untyped_storage().data_ptr():
                x.untyped_storage().nbytes()
                for _, x in graph_audit.leaves(state) + [("", tc.state_power)]}
    rounded = sum(-(-n // 512) * 512 for n in storages.values())
    before = ops.launch_counts()
    t0 = time.perf_counter()
    inv = graph_audit.record(lambda st: engine._step(st, cfg, tc), state)
    torch.cuda.synchronize(dev)
    t_rec = time.perf_counter() - t0
    launched = {ops.OPS[k]: n - before[k]
                for k, n in ops.launch_counts().items() if n > before[k]}
    bad = simlint.kernels_single_nodes("simlint-main", inv, launched)
    syncs = inv.sites_of(graph_audit.HOST_SYNC_OPS)
    if bad or syncs:
        fail("simlint-main:\n" + "\n".join(
            [v.render() for v in bad] + [f"host sync {x.op} at {x.src}"
                                        for x in syncs]))
    s = inv.summary()
    cost = costmodel.cost_of(inv)
    regions = ", ".join(f"{r or '<outer>'} {v['bytes'] / 2**20:.2f} MiB"
                        for r, v in sorted(cost.by_region.items(),
                                           key=lambda kv: -kv[1]["bytes"])
                        [:4])
    busy = main_prof.get("busy_us")
    ratio = "not measured (the profiler recorded no device time)" \
        if busy is None else (f"{busy / 1e3:.3f} ms, the bound "
                              f"{100 * cost.bound_s * 1e6 / busy:.2f}% of it")
    log(f"[simlint-main] one macro-step of [main]'s configuration on the "
        f"card: {s['ops']} ops, {s['scatter']} scatters "
        f"({s['scatter_cheap_core']} in cheap_core), {s['gather']} gathers, "
        f"{s['host_syncs']} host syncs, {s['host_to_device']} host-to-card "
        f"copies, kernels {s['kernels']} (== launches); recorded in "
        f"{t_rec:.2f} s")
    log(f"[simlint-main] cost model: {cost.total_bytes} bytes "
        f"({cost.total_bytes / 2**20:.2f} MiB; by region {regions}), "
        f"{cost.total_ops} operations; bound {cost.bound_s * 1e3:.4f} ms by "
        f"{cost.bound_by} at {costmodel.H100_HBM_BYTES_S:.3g} B/s and "
        f"{costmodel.H100_F32_OPS_S:.3g} f32 ops/s; device time of a "
        f"macro-step in [main]'s profiler window {ratio}")
    log(f"[simlint-main] state footprint (fake tensors) "
        f"{fp['total_bytes']} bytes, by field {fp['by_field']}; "
        f"torch.cuda.memory_allocated() rose {rise} bytes across "
        f"build_jobs and init_state: {rise - fp['total_bytes']:+d} bytes "
        f"against the footprint, {rise - rounded:+d} against its "
        f"{len(storages)} storages (the state power table among them) "
        f"rounded up to 512 bytes each ({rounded} bytes); HBM "
        f"{costmodel.hbm_capacity():.4g} bytes, the state "
        f"{100 * fp['total_bytes'] / costmodel.hbm_capacity():.4f}% of it")


def shard_graph(cfg, state, tc, mesh, n) -> tuple:
    """shard_sim.sharded_step_graph on this rank (every rank of the mesh
    calls it) and the reference's collective rules on it: one all_gather
    per sharded leaf (``n``), no other collective, no host sync, each
    kernel one node a launch.  Returns ({"gathers", "collectives",
    "syncs", "ops", "kernels"}, [rendered violations])."""
    from repro_torch.analysis import graph_audit as ga, rules, simlint
    from repro_torch.core import shard_sim
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    inv = shard_sim.sharded_step_graph(state, cfg, tc, mesh)
    torch.cuda.synchronize()
    launched = {ops.OPS[k]: c - before[k]
                for k, c in ops.launch_counts().items() if c > before[k]}
    checks = [
        rules.ExactCount(name="one-all-gather-per-sharded-leaf",
                         ops=ga.ALL_GATHER_OPS, expect=n),
        rules.ForbidOp(name="no-other-collectives",
                       ops=ga.COLLECTIVE_OPS - ga.ALL_GATHER_OPS),
        rules.ForbidOp(name="no-host-sync-in-step", ops=ga.HOST_SYNC_OPS)]
    bad = [v for rule in checks for v in rule.check("sharded", inv, None)]
    bad += simlint.kernels_single_nodes("sharded", inv, launched)
    s = inv.summary()
    return ({"gathers": inv.count(ga.ALL_GATHER_OPS),
             "collectives": s["collectives"], "syncs": s["host_syncs"],
             "ops": s["ops"], "kernels": s["kernels"]},
            [v.render() for v in bad])


def log_shard_graph(tag, got) -> None:
    summary, bad = got
    if bad:
        fail(f"{tag} sharded_step_graph:\n" + "\n".join(bad))
    log(f"{tag} sharded_step_graph: {summary['ops']} ops, "
        f"{summary['collectives']} ({summary['gathers']} all_gathers, one "
        f"a sharded leaf, no other collective), {summary['syncs']} host "
        f"syncs, kernels {summary['kernels']} (== launches)")


# --------------------------------------------------------------------------
# rack sharding: [shard-parity], [shard-main], [shard-mc]
# --------------------------------------------------------------------------

def state_cpu(obj):
    """A state (or batch) with every leaf copied to the host."""
    from repro_torch.core.types import tree_map
    return tree_map(lambda x: x.cpu(), obj)


def differing_leaves(got, exp) -> list:
    """The leaves of two states (or batches) that are not bit-equal."""
    from repro_torch.core.types import tree_leaves
    return [p for (p, a), (_, b) in zip(tree_leaves(got), tree_leaves(exp))
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b.cpu())]


def shard_mc_inputs():
    """[shard-mc]'s batch: [mc-parity]'s replicas_r3 (4 servers x 2 cores,
    80 Poisson jobs at 150/s, 10 ms mean service) at R = 4 arrival seeds.
    Returns (cfg, arrs, specs)."""
    from repro_torch.core import jobs, types, workload
    from torch_kernel_inputs import mc_config, mc_scenario
    kw, nested, _, specs, _, _ = mc_scenario("replicas_r3", jobs)
    arrs = np.stack([workload.poisson_arrivals(150.0, 80, seed=s)
                     for s in range(SHARD_MC_R)])
    return mc_config(types, kw, nested), arrs, specs


def shard_profile(cfg, state, tc, mesh, profiled, warm=20, steps=10):
    """Device time of ``steps`` sharded macro-steps (gather, step, slice,
    as run_sharded's loop body) after ``warm``, and of ``steps`` gather
    phases alone on the same blocks.  Every rank calls it (the gathers are
    collectives); only a rank with ``profiled`` traces, and returns
    {"step_us", "gather_us" (device us a macro-step, None when the
    profiler recorded none), "step_ms", "gather_ms" (host wall a
    macro-step under the profiler)}."""
    from repro_torch.core import engine, shard_sim
    axis = cfg.partition.axis
    group, k, idx = shard_sim._axis_of(mesh, axis)
    flags = shard_sim._sharded_flags(state, cfg, mesh, axis)
    box = [state]

    def blocks():
        return shard_sim._slice_leaves(box[0], flags, idx, k)

    def macro_steps(n):
        for _ in range(n):
            full = shard_sim._gather_leaves(blocks(), flags, group, k)
            box[0] = engine._step(full, cfg, tc)

    def gathers():
        local = blocks()
        for _ in range(steps):
            shard_sim._gather_leaves(local, flags, group, k)

    macro_steps(warm)
    out = {}
    for key, fn in (("step", lambda: macro_steps(steps)),
                    ("gather", gathers)):
        if profiled:
            ks, wall = device_kernels(fn)
            us = sum(t for _, t in ks.values())
            out[f"{key}_us"] = us / steps if us > 0 else None
            out[f"{key}_ms"] = wall * 1e3 / steps
        else:
            fn()
            torch.cuda.synchronize()
    return out


def shard_main_runs(dev, mesh, profiled):
    """[shard-main] on one rank: the engine main configuration through
    run_sharded (its final state, the collectives it called) and through
    farm.simulate(mesh=), the user's entry point, with the kernels'
    launch counts set to 0 just before it and read just after; then the
    profile of shard_profile.  Returns a dict."""
    from repro_torch.core import engine, farm, jobs, shard_sim
    from repro_torch.kernels import ops
    from torch_spmd import count_collectives
    cfg, arr, specs, _ = one_farm_cfg(N_MAIN, JOBS_MAIN)
    jt = jobs.build_jobs(cfg, np.asarray(arr), specs, device=dev)
    state, tc = engine.init_state(cfg, jt)
    n = shard_sim.n_sharded_leaves(state, cfg, mesh)
    with count_collectives() as calls:
        final = shard_sim.run_sharded(state, cfg, tc, mesh)
    ops.reset_launch_counts()
    res = farm.simulate(cfg, arr, specs, device=dev, mesh=mesh)
    counts = ops.launch_counts()
    prof = shard_profile(cfg, state, tc, mesh, profiled)
    return dict(final=state_cpu(final), calls=dict(calls), n_sharded=n,
                result=res, counts=counts, prof=prof)


def shard_rank(rank, world, route):
    """One rank of the two-rank card runs (shard_sim.spawn launches
    it): [shard-parity]'s four configurations through run_sharded,
    [shard-main] and [shard-mc]'s batch on a (2, 1) ("replicas", "racks")
    mesh.  ``route`` "gloo": both ranks on card 0, the collectives staged
    through the host; "nccl": card ``rank``."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import montecarlo, shard_sim
    from repro_torch.kernels import ops
    from torch_kernel_inputs import SHARD_SCENARIOS
    from torch_spmd import count_collectives, shard_initial
    dev = torch.device("cuda", rank if route == "nccl" else 0)
    torch.cuda.set_device(dev)
    mesh = shard_sim.make_mesh(world, device=dev)
    out = {"parity": {}}
    for name in SHARD_SCENARIOS:
        cfg, state, tc = shard_initial(name, dev)
        ops.reset_launch_counts()
        with count_collectives() as calls:
            final = shard_sim.run_sharded(state, cfg, tc, mesh)
        out["parity"][name] = (state_cpu(final), dict(calls),
                               ops.launch_counts())
        cfg, state, tc = shard_initial(name, dev)
        out.setdefault("graph", {})[name] = shard_graph(
            cfg, state, tc, mesh,
            shard_sim.n_sharded_leaves(state, cfg, mesh))
    out["main"] = shard_main_runs(dev, mesh, profiled=rank == 0)
    cfg, arrs, specs = shard_mc_inputs()
    mesh2 = init_device_mesh("cuda", (world, 1),
                             mesh_dim_names=("replicas", cfg.partition.axis))
    sb, tc = montecarlo.batched_state(cfg, arrs, specs, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = montecarlo.run_replicas(cfg, sb, tc, mesh=mesh2)
    torch.cuda.synchronize()
    out["mc"] = (state_cpu(got), ops.launch_counts(),
                 time.perf_counter() - t0)
    return out


def check_gathers(tag, calls, n, steps):
    """A sharded run called one gather per sharded leaf a macro-step, one
    set more for the final state, and no other collective."""
    from torch_spmd import GATHERS
    gathers = sum(calls.get(g, 0) for g in GATHERS)
    if gathers != n * (steps + 1) or sum(calls.values()) != gathers:
        fail(f"{tag}: collectives {calls} for {n} sharded leaves and "
             f"{steps} macro-steps; expected {n * (steps + 1)} gathers and "
             f"nothing else")


def shard_phases(dev, main_res) -> dict:
    """[shard-parity], [shard-main] and [shard-mc]: rack-sharded runs on
    the card.  A mesh of 1 over NCCL in this process; then two ranks,
    spawned, over NCCL with one card a rank where there are two cards,
    else over gloo with both ranks' tensors on card 0 (NCCL refuses two
    ranks on one card).  Every sharded run must equal the unsharded run on
    the card bit for bit; the unsharded runs of [shard-parity] equal the
    CPU's as parity() holds them.  ``main_res`` is [main]'s SimResult.
    Returns {"K=1": launches, "K=2": [launches of each rank]} of the
    [shard-main] runs."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import (engine, jobs, montecarlo, shard_sim,
                                  topology, types)
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import ops
    from torch_kernel_inputs import SHARD_SCENARIOS, shard_scenario
    from torch_spmd import count_collectives, shard_initial

    # the reference runs: the unsharded engine on the card (against the
    # CPU for the four configurations)
    unsharded = {}
    for name in SHARD_SCENARIOS:
        cfg, arr, specs, topo, tau = shard_scenario(name, jobs, topology,
                                                    types)
        unsharded[name] = parity(name, cfg, arr, specs, tau, dev, topo,
                                 tag="[shard-parity]")
    cfg_main, arr_main, specs_main, _ = one_farm_cfg(N_MAIN, JOBS_MAIN)
    jt = jobs.build_jobs(cfg_main, np.asarray(arr_main), specs_main,
                         device=dev)
    st_main, tc_main = engine.init_state(cfg_main, jt)
    ref_main = engine.run(st_main, cfg_main, tc_main)
    cfg_mc, arrs_mc, specs_mc = shard_mc_inputs()
    sb, tc_mc = montecarlo.batched_state(cfg_mc, arrs_mc, specs_mc,
                                         device=dev)
    ref_mc = montecarlo.run_replicas(cfg_mc, sb, tc_mc)
    launches, gathered, n_sharded = {}, {}, {}

    def report_main(k, rk, got):
        tag = f"[shard-main] K={k}" + (f" rank {rk}" if k > 1 else "")
        bad = differing_leaves(got["final"], ref_main)
        if bad:
            fail(f"{tag}: run_sharded differs from engine.run on the card "
                 f"in {bad}")
        steps = int(got["final"].steps)
        check_gathers(tag, got["calls"], got["n_sharded"], steps)
        res, counts, ri = got["result"], got["counts"], got["result"].run_info
        for f in ("events", "n_finished", "server_energy", "mean_latency",
                  "p99_latency", "sim_time"):
            if getattr(res, f) != getattr(main_res, f):
                fail(f"{tag}: farm.simulate(mesh=) {f} {getattr(res, f)} "
                     f"against {getattr(main_res, f)} unsharded")
        if not np.array_equal(res.latencies, main_res.latencies):
            fail(f"{tag}: farm.simulate(mesh=) latencies differ")
        if (ri.devices, ri.mesh_shape, ri.mesh_axes, ri.sharding) != \
                (k, (k,), ("racks",), "P('racks',)") or \
                ri.config_digest != main_res.run_info.config_digest:
            fail(f"{tag}: run_info {ri.devices} {ri.mesh_shape} "
                 f"{ri.mesh_axes} {ri.sharding} {ri.config_digest}")
        if counts["dcsim_advance"] != ri.steps * cfg_main.events_per_step \
                or counts["telemetry_accum"] != ri.steps:
            fail(f"{tag}: launches {counts} for {ri.steps} macro-steps")
        p = got["prof"]
        share = "not measured (the profiler recorded no device time)"
        if p.get("step_us") and p.get("gather_us") is not None:
            share = (f"{p['gather_us']:.1f} of {p['step_us']:.1f} us of "
                     f"device time a macro-step "
                     f"({100 * p['gather_us'] / p['step_us']:.2f}%), host "
                     f"wall {p['gather_ms']:.3f} of {p['step_ms']:.3f} ms "
                     f"under the profiler")
        elif k > 1 and rk > 0:
            share = "profiled on rank 0"
        log(f"{tag}: one_farm {N_MAIN} servers x {C_MAIN} cores, "
            f"{JOBS_MAIN} jobs: run_sharded == engine.run on the card (every "
            f"leaf bit-equal); farm.simulate(mesh=) wall {ri.wall_s:.3f} s, "
            f"{ri.events_per_s:.1f} events/s (unsharded [main] "
            f"{main_res.run_info.wall_s:.3f} s, "
            f"{main_res.run_info.events_per_s:.1f} "
            f"events/s), events {ri.events}, steps {ri.steps}, results == "
            f"[main]'s; {got['n_sharded']} sharded leaves, "
            f"{gathered['bytes'] / 2**20:.3f} MiB gathered a macro-step, "
            f"{sum(got['calls'].values())} gathers in run_sharded; the "
            f"gathers {share}; launches {counts}")
        return counts

    # a mesh of 1 over NCCL, in this process
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = shard_sim.make_mesh(1, device=dev)
            flags = shard_sim._sharded_flags(st_main, cfg_main, mesh,
                                             "racks")
            gathered["bytes"] = sum(
                v.numel() * v.element_size()
                for (_, v), (_, s) in zip(tree_leaves(st_main),
                                          tree_leaves(flags)) if s)
            for name in SHARD_SCENARIOS:
                cfg, state, tc = shard_initial(name, dev)
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                with count_collectives() as calls:
                    got = shard_sim.run_sharded(state, cfg, tc, mesh)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                bad = differing_leaves(got, unsharded[name])
                if bad:
                    fail(f"shard-parity {name} K=1: differs from the "
                         f"unsharded run on the card in {bad}")
                n = n_sharded[name] = shard_sim.n_sharded_leaves(state, cfg,
                                                                 mesh)
                check_gathers(f"shard-parity {name} K=1", calls, n,
                              int(got.steps))
                log(f"[shard-parity] {name} K=1 (NCCL): run_sharded == "
                    f"engine.run on the card, every leaf bit-equal, ring "
                    f"{int(got.trace.ptr)} records; {n} sharded leaves, "
                    f"{dict(calls)} in {int(got.steps)} macro-steps; "
                    f"launches {ops.launch_counts()}; {wall:.2f} s")
                cfg, state, tc = shard_initial(name, dev)
                log_shard_graph(f"[shard-parity] {name} K=1 (NCCL):",
                                shard_graph(cfg, state, tc, mesh, n))
            got = shard_main_runs(dev, mesh, profiled=True)
            launches["K=1"] = report_main(1, 0, got)
        finally:
            dist.destroy_process_group()

    # two ranks
    route = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    log(f"[shard] two ranks over {route}: " + (
        "one card a rank" if route == "nccl" else
        f"{torch.cuda.device_count()} card, so both ranks hold their "
        f"tensors on card 0 and gloo stages each gather through host "
        f"memory (NCCL refuses two ranks on one card)"))
    t0 = time.perf_counter()
    log(f"[elapsed] the two-rank spawn starts {t0 - T_START:.1f} s in")
    ranks = shard_sim.spawn(shard_rank, 2, (route,), backend=route)
    t_spawn = time.perf_counter() - t0
    launches["K=2"] = []
    for rk, out in enumerate(ranks):
        for name in SHARD_SCENARIOS:
            got, calls, counts = out["parity"][name]
            bad = differing_leaves(got, unsharded[name])
            if bad:
                fail(f"shard-parity {name} K=2 rank {rk}: differs from the "
                     f"unsharded run on the card in {bad}")
            check_gathers(f"shard-parity {name} K=2 rank {rk}", calls,
                          n_sharded[name], int(got.steps))
            log(f"[shard-parity] {name} K=2 ({route}) rank {rk}: == "
                f"engine.run on the card, every leaf bit-equal; {calls} in "
                f"{int(got.steps)} macro-steps; launches {counts}")
            summary, bad = out["graph"][name]
            if summary["gathers"] != n_sharded[name]:
                bad = bad + [f"{summary['gathers']} all_gathers, "
                             f"{n_sharded[name]} sharded leaves"]
            log_shard_graph(f"[shard-parity] {name} K=2 ({route}) rank "
                            f"{rk}:", (summary, bad))
        launches["K=2"].append(report_main(2, rk, out["main"]))
        got, counts, wall = out["mc"]
        bad = differing_leaves(got, ref_mc)
        if bad:
            fail(f"shard-mc rank {rk}: differs from run_replicas without a "
                 f"mesh in {bad}")
        log(f"[shard-mc] R={SHARD_MC_R} on a (2, 1) (replicas, racks) mesh "
            f"({route}), rank {rk}: == run_replicas without a mesh on the "
            f"card, every leaf bit-equal; its {SHARD_MC_R // 2} replicas' "
            f"events {got.events.tolist()[rk * 2:rk * 2 + 2]}; launches "
            f"{counts}; {wall:.2f} s")
    log(f"[shard] the two-rank spawn took {t_spawn:.1f} s wall, the ranks' "
        f"start-up included")
    return launches


# --------------------------------------------------------------------------
# LM substrate: kernels, card-vs-CPU serving parity, serving main run
# --------------------------------------------------------------------------

# B, H, KV, Sq, Skv, hd, causal, window, softcap, dtype
FLASH_MAIN = (LM_BATCH, 25, 5, LM_PROMPT, LM_PROMPT, 64, True, 1024, 0.0,
              "bfloat16")                       # hymba-1.5b's prefill
FLASH_RAGGED = [
    (LM_BATCH, 25, 5, 1000, 1000, 64, True, 1024, 0.0, "bfloat16"),
    (2, 16, 8, 1000, 1000, 64, True, 0, 50.0, "bfloat16"),  # softcap
    (2, 8, 2, 700, 1300, 64, False, 0, 0.0, "bfloat16"),    # Sq != Skv
    (2, 8, 4, 777, 777, 128, True, 256, 0.0, "float32"),    # hd 128, f32
]
# a bf16 output row's largest relative error against the plain version:
# P and the output rounded to bf16 give a few 1e-3; a faulty key tile
# reads far above (flash_row_controls)
FA_ROW_TOL = 0.03
SSM_MAIN = (LM_BATCH, LM_PROMPT, 3200, 16)      # hymba-1.5b's prefill
SSM_RAGGED = [(3, 37, 200, 16)]


def flash_args(case, dev, seed=31):
    """The tests' builder; q/k/v stored as the model stores them, (B, S,
    H, hd), and seen as (B, H, S, hd), as the serving path hands them to
    the kernel."""
    from torch_kernel_inputs import flash_inputs
    B, H, KV, Sq, Skv, hd, causal, window, cap, dt = case
    qkv = tuple(torch.from_numpy(a).to(dev, getattr(torch, dt))
                .transpose(1, 2).contiguous().transpose(1, 2)
                for a in flash_inputs(B, H, KV, Sq, Skv, hd, seed))
    return qkv, dict(causal=causal, window=window, softcap=cap)


def attn_pairs(Sq, Skv, causal, window) -> int:
    """Unmasked (query, key) pairs of one head."""
    q = np.arange(Sq)
    hi = np.minimum(q, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def row_err(got, exp) -> float:
    """The largest row's relative error ||got - exp|| / ||exp|| (norms
    over the head dim)."""
    g, e = got.float(), exp.float()
    return float(((g - e).norm(dim=-1) / e.norm(dim=-1)).max())


def check_flash(case, dev):
    """Tolerances of tests/test_kernels.py: 2e-2 in bf16, 2e-5 in f32 (the
    kernel sums q.k and p.v in its own order).  A bf16 output is also held
    row by row to FA_ROW_TOL of the plain version."""
    from repro_torch.kernels import flash_attention, ref
    args, kw = flash_args(case, dev)
    got = flash_attention.flash_attention(*args, **kw)
    exp = ref.mha_reference(*args, **kw)
    torch.cuda.synchronize()
    bf16 = case[-1] == "bfloat16"
    tol = 2e-2 if bf16 else 2e-5
    g, e = got.float(), exp.float()
    err = float((g - e).abs().max())
    if got.shape != exp.shape or got.dtype != exp.dtype:
        fail(f"flash_attention {case}: {got.dtype}{tuple(got.shape)}, plain "
             f"{exp.dtype}{tuple(exp.shape)}")
    if not torch.isfinite(g).all() or \
            ((g - e).abs() > tol + tol * e.abs()).any():
        fail(f"flash_attention {case}: beyond tolerance {tol} of the plain "
             f"version (max abs err {err})")
    rows = ""
    if bf16:
        rel = row_err(got, exp)
        if rel > FA_ROW_TOL:
            fail(f"flash_attention {case}: a row's relative error {rel} "
                 f"exceeds {FA_ROW_TOL}")
        rows = f"; largest row error {rel:.5f} (limit {FA_ROW_TOL})"
    log(f"[kernels] flash_attention B,H,KV,Sq,Skv,hd={case[:6]} causal="
        f"{case[6]} window={case[7]} softcap={case[8]} {case[9]} "
        f"({flash_attention.LAST_INSTANCE}): within {tol} of the plain "
        f"version (max abs err {err}){rows}")
    return args, kw, err


def flash_row_controls(dev) -> None:
    """What the row check reads for a faulty key tile at the serving
    prefill's shape: the plain version with one 64-key tile in the middle
    of the sequence (in rows of ~800 keys) replaced by the tile before it
    (a stale ring stage) or with its values zero (a copy that did not
    land), against the plain version.  Each must read above FA_ROW_TOL."""
    from repro_torch.kernels import ref
    (q, k, v), kw = flash_args(FLASH_MAIN, dev)
    exp = ref.mha_reference(q, k, v, **kw)
    t = FLASH_MAIN[3] // 128
    tile, prev = slice(64 * t, 64 * t + 64), slice(64 * t - 64, 64 * t)
    stale_k, stale_v, zero_v = k.clone(), v.clone(), v.clone()
    stale_k[:, :, tile] = k[:, :, prev]
    stale_v[:, :, tile] = v[:, :, prev]
    zero_v[:, :, tile] = 0
    reads = {"stale stage": row_err(ref.mha_reference(q, stale_k, stale_v,
                                                      **kw), exp),
             "zero-filled values": row_err(ref.mha_reference(q, k, zero_v,
                                                             **kw), exp)}
    if min(reads.values()) <= FA_ROW_TOL:
        fail(f"flash_attention row check: a faulty tile reads {reads}, not "
             f"above the limit {FA_ROW_TOL}")
    log(f"[kernels] flash_attention row check controls (keys "
        f"{64 * t}..{64 * t + 63} faulty, plain version): "
        + ", ".join(f"{n} {r:.4f}" for n, r in reads.items())
        + f", all above the limit {FA_ROW_TOL}")


def check_ssm(B, S, Dss, N, dev, seed=33):
    """y and h within rtol/atol 1e-5 (the plain version sums over the state
    in another order)."""
    from repro_torch.kernels import ref, ssm_scan
    from torch_kernel_inputs import ssm_inputs, torch_args
    args = torch_args(ssm_inputs(B, S, Dss, N, seed), dev)
    got = ssm_scan.ssm_scan(*args)
    exp = ref.ssm_scan_reference(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, e in zip(("y", "h_final"), got, exp):
        if g.shape != e.shape or g.dtype != e.dtype:
            fail(f"ssm_scan {(B, S, Dss, N)}: {name} is {g.dtype}"
                 f"{tuple(g.shape)}, plain {e.dtype}{tuple(e.shape)}")
        if not torch.allclose(g, e, rtol=1e-5, atol=1e-5):
            fail(f"ssm_scan {(B, S, Dss, N)}: {name} beyond 1e-5 of the "
                 f"plain version (max abs err {float((g - e).abs().max())})")
        err = max(err, float((g - e).abs().max()))
    log(f"[kernels] ssm_scan B,S,Dss,N={(B, S, Dss, N)} "
        f"({ssm_scan.LAST_INSTANCE}): y and h_final within 1e-5 of the "
        f"plain version (max abs err {err})")
    return args, err


def lm_parity(dev):
    """hymba-1.5b at full width cut to PAR_LAYERS layers, float32, on the
    card against the CPU: prompts of PAR_PROMPT tokens (past the 1,024
    window, so the prefill's ring roll runs), the step functions fed the
    same tokens, then ServeEngine.generate on both."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    full = configs.get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=PAR_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    log(f"[lm-parity] {cfg.name} at full width cut to {PAR_LAYERS} of "
        f"{full.n_layers} layers (the one cut), float32; B={PAR_BATCH}, "
        f"prompts of {PAR_PROMPT} tokens, {PAR_NEW} new tokens")
    p_cpu = transformer.make_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (PAR_BATCH, PAR_PROMPT)))
    prefill, decode = step.make_prefill(cfg), step.make_serve_step(cfg)
    worst = 0.0

    def agree(what, g, c):
        nonlocal worst
        g = g.cpu()
        if not torch.isfinite(g).all() or \
                not torch.allclose(g, c, rtol=1e-3, atol=1e-3):
            fail(f"lm-parity: {what} logits differ between card and CPU "
                 f"(max abs err {float((g - c).abs().max())})")
        worst = max(worst, float((g - c).abs().max()))

    t0 = time.perf_counter()
    with torch.inference_mode():
        c_cpu = transformer.init_cache(cfg, PAR_BATCH, LM_MAX_SEQ,
                                       device="cpu")
        c_gpu = transformer.init_cache(cfg, PAR_BATCH, LM_MAX_SEQ,
                                       device=dev)
        l_cpu, c_cpu = prefill(p_cpu, toks, c_cpu)
        l_gpu, c_gpu = prefill(p_gpu, toks.to(dev), c_gpu)
        agree("prefill", l_gpu, l_cpu)
        for i in range(PAR_NEW):
            tok = l_cpu.argmax(-1)[:, None]
            l_cpu, c_cpu = decode(p_cpu, c_cpu, tok, PAR_PROMPT + i)
            l_gpu, c_gpu = decode(p_gpu, c_gpu, tok.to(dev), PAR_PROMPT + i)
            agree(f"decode step {i}", l_gpu, l_cpu)
    prompts = toks.tolist()
    r_cpu = ServeEngine(cfg, p_cpu, max_batch=PAR_BATCH,
                        max_seq=LM_MAX_SEQ, device="cpu").generate(
        prompts, max_new=PAR_NEW)
    ops.reset_launch_counts()
    r_gpu = ServeEngine(cfg, p_gpu, max_batch=PAR_BATCH,
                        max_seq=LM_MAX_SEQ, device=dev).generate(
        prompts, max_new=PAR_NEW)
    counts = ops.launch_counts()
    inst = dict(flash_attention.INSTANCE_LAUNCHES)
    if inst != {flash_attention.TENSOR_CORE: 0,
                flash_attention.CUDA_CORE: PAR_LAYERS}:
        fail(f"lm-parity: float32 attention ran on instances {inst}, "
             f"expected the CUDA-core one once per layer")
    if [r.tokens for r in r_gpu] != [r.tokens for r in r_cpu]:
        fail("lm-parity: generate gave other greedy tokens on the card: "
             f"{[r.tokens[PAR_PROMPT:] for r in r_gpu]} against "
             f"{[r.tokens[PAR_PROMPT:] for r in r_cpu]}")
    if counts["flash_attention"] != PAR_LAYERS or \
            counts["ssm_scan"] != PAR_LAYERS:
        fail(f"lm-parity: launch counts {counts}, expected one of each LM "
             f"kernel per layer ({PAR_LAYERS})")
    log(f"[lm-parity] card == CPU: prefill and {PAR_NEW} decode steps' "
        f"logits within 1e-3 (max abs err {worst:.3g}); generate gave the "
        f"same greedy tokens {[r.tokens[PAR_PROMPT:] for r in r_gpu]}; "
        f"launches {counts}, attention instances {inst}; "
        f"{time.perf_counter() - t0:.1f} s")


def lm_main(dev):
    """The serving main run through the user's entry points: hymba-1.5b's
    full config with the port's seeded random weights on the card,
    ServeEngine(max_batch=4, max_seq=2048).generate of 4 prompts of 1,536
    tokens, 32 new tokens, greedy."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ops, ssm_scan
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    cfg = configs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = transformer.make_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[lm-main] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters "
        f"({cfg.param_dtype}), random init on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = ServeEngine(cfg, params, max_batch=LM_BATCH, max_seq=LM_MAX_SEQ)
    prompts = np.random.default_rng(7).integers(
        1, cfg.vocab, (LM_BATCH, LM_PROMPT)).tolist()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new=LM_NEW)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    inst = dict(flash_attention.INSTANCE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if counts["flash_attention"] != cfg.n_layers or \
            counts["ssm_scan"] != cfg.n_layers:
        fail(f"lm-main: launch counts {counts}, expected {cfg.n_layers} "
             f"of each LM kernel (one per layer of the one prefill)")
    if inst != {flash_attention.TENSOR_CORE: cfg.n_layers,
                flash_attention.CUDA_CORE: 0}:
        fail(f"lm-main: bf16 attention ran on instances {inst}, expected "
             f"the tensor-core one once per layer")
    for r, p in zip(res, prompts):
        new = r.tokens[len(p):]
        if r.tokens[:len(p)] != p or len(new) != LM_NEW or \
                not all(0 <= t < cfg.vocab for t in new):
            fail(f"lm-main: bad generation {new}")
    tm = engine.timings
    with torch.inference_mode():           # logits finite (not counted)
        toks = torch.tensor(prompts, device=dev)
        cache = transformer.init_cache(cfg, LM_BATCH, LM_MAX_SEQ)
        lg, cache = step.make_prefill(cfg)(params, toks, cache)
        lg2, _ = step.make_serve_step(cfg)(params, cache,
                                           lg.argmax(-1)[:, None], LM_PROMPT)
        if not (torch.isfinite(lg).all() and torch.isfinite(lg2).all()):
            fail("lm-main: non-finite logits")
    log(f"[lm-main] generate: {LM_BATCH} x {LM_PROMPT} prompt tokens, "
        f"{LM_NEW} new each: wall {wall:.3f} s; first token (prefill) "
        f"{tm['first_token_s'] * 1e3:.1f} ms; decode "
        f"{tm['decode_s'] / tm['decode_steps'] * 1e3:.2f} ms per step over "
        f"{tm['decode_steps']} steps; {LM_BATCH * LM_NEW / wall:.1f} "
        f"generated tokens/s; prefill "
        f"{LM_BATCH * LM_PROMPT / tm['first_token_s']:.0f} tokens/s; "
        f"peak memory {peak / 2**30:.2f} GiB; launches {counts}, "
        f"attention instances {inst}, scan {ssm_scan.LAST_INSTANCE}; "
        f"first new tokens {[r.tokens[LM_PROMPT:LM_PROMPT + 4] for r in res]}")
    return cfg, params, toks, counts


def profile_serving(cfg, params, toks, dev):
    """Where the serving time goes: one prefill and one decode step of the
    main run under torch.profiler."""
    from repro_torch.models import transformer
    from repro_torch.train import step
    prefill, decode = step.make_prefill(cfg), step.make_serve_step(cfg)
    box = {}

    def run_prefill():
        with torch.inference_mode():
            cache = transformer.init_cache(cfg, LM_BATCH, LM_MAX_SEQ)
            box["lg"], box["cache"] = prefill(params, toks, cache)

    ks, wall = device_kernels(run_prefill)
    report_profile("serving prefill (4 x 1,536 tokens)", ks, wall,
                   ("flash_attention", "ssm_scan"), 1, "prefill")
    tok = box["lg"].argmax(-1)[:, None]

    def run_decode():
        with torch.inference_mode():
            decode(params, box["cache"], tok, LM_PROMPT)

    ks, wall = device_kernels(run_decode)
    report_profile("serving decode step", ks, wall, ("flash_attention",
                   "ssm_scan"), 1, "step")


def lm_kernel_entries(flash_main, ssm_main, counts, fa_err, ss_err, dev):
    """Time both LM kernels at the serving prefill's shapes beside their
    bounds, plain versions and (attention) the library call."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    (q, k, v), kw = flash_main
    B, H, KV, S, _, hd, causal, W, _, _ = FLASH_MAIN
    fa_ms = time_ms(lambda: flash_attention.flash_attention(q, k, v, **kw),
                    reps=50, warmup=5)
    fa_plain = time_ms(lambda: ref.mha_reference(q, k, v, **kw), reps=10,
                       warmup=2)
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    fa_lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), reps=50, warmup=5)
    out = flash_attention.flash_attention(q, k, v, **kw)
    fa_inst = flash_attention.LAST_INSTANCE
    pairs = attn_pairs(S, S, causal, W) * B * H
    sfu = exp_per_s()
    # per unmasked (q, k) pair: 2 hd flops of q.k, 2 hd of p.v, one exp
    fa_bound, fa_by, fa_op = bound_ms(
        nbytes(q, k, v, out), {"bf16 tensor-core flops":
                               (4 * hd * pairs, PEAK_BF16_FLOP_S),
                               "exponentials": (pairs, sfu)})
    ss_ms = time_ms(lambda: ssm_scan.ssm_scan(*ssm_main), reps=50, warmup=5)
    ss_plain = time_ms(lambda: ref.ssm_scan_reference(*ssm_main), reps=3,
                       warmup=1)
    y, h = ssm_scan.ssm_scan(*ssm_main)
    ss_inst = ssm_scan.LAST_INSTANCE
    Bs, Ss, Dss, N = SSM_MAIN
    # per state element and step: dt*A, exp, da*h, u*B, add, h*C, add
    elems = Bs * Ss * Dss * N
    ss_bound, ss_by, ss_op = bound_ms(
        nbytes(*ssm_main, y, h), {"f32 operations": (7 * elems,
                                                     PEAK_F32_OPS_S),
                                  "exponentials": (elems, sfu)})
    entries = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:83",
         "launches": counts["flash_attention"], "max_abs_err": fa_err,
         "ms": fa_ms, "plain_ms": fa_plain, "bound_ms": fa_bound,
         "bound_by": fa_by, "bound_op": fa_op, "library_ms": fa_lib,
         "instance": fa_inst},
        {"name": "ssm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:52",
         "launches": counts["ssm_scan"], "max_abs_err": ss_err,
         "ms": ss_ms, "plain_ms": ss_plain, "bound_ms": ss_bound,
         "bound_by": ss_by, "bound_op": ss_op, "library_ms": None,
         "instance": ss_inst},
    ]
    dev_us = {
        "flash_attention": kernel_device_us(
            lambda: flash_attention.flash_attention(q, k, v, **kw),
            ["flash_attention_bf16_kernel"], reps=20),
        "ssm_scan": kernel_device_us(lambda: ssm_scan.ssm_scan(*ssm_main),
                                     ["ssm_scan_kernel"], reps=20)}
    return entries, dev_us


# --------------------------------------------------------------------------

def main() -> None:
    t_start = T_START
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs "
             "an NVIDIA GPU")
    from repro_torch.core import farm
    from repro_torch.kernels import build, ops
    from torch_kernel_inputs import FLASH_TC_EDGES, SSM_EDGES

    # float32 products in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    # phase 2: build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s wall")
    for name, (path, secs, report) in built.items():
        log(f"[build] {name}: {path.name} ({secs:.1f} s) " + " | ".join(
            f"{k}: {v}" for k, v in ptxas_entries(report).items()))
    sass_census(built)

    log(f"[elapsed] phase 3 starts at {time.perf_counter() - t_start:.1f} s")
    # phase 3: kernels vs plain versions
    _, dc_err = check_dcsim(N_MAIN, C_MAIN, 1, dev)
    # ragged farms about the 256-thread blocks; C = 3 takes the scalar
    # (non-float4) path; the network main run's farm
    farms = [(1000, 4), (1000, 3), (1, 4), (255, 4), (257, 4),
             (N_MAIN + 1, 4), (NET_SERVERS, C_MAIN)]
    for seed, (n, c) in enumerate(farms, start=2):
        dc_err = max(dc_err, check_dcsim(n, c, seed, dev)[1])
    # the float64-clock instance on the same farms and the main one
    for seed, (n, c) in enumerate([(N_MAIN, C_MAIN)] + farms, start=30):
        check_dcsim(n, c, seed, dev, clock=np.float64)
    _, tb_err = check_telemetry(JOBS_MAIN, JOBS_MAIN, 1, 19, 4, dev)
    # the cross-block path, and both sides of the paths' boundary
    from repro_torch.kernels.telemetry_bin import SMALL_MAX
    for seed, (J, M, W) in enumerate([(100_003, 300_009, 256),
                                      (SMALL_MAX, SMALL_MAX, 2),
                                      (SMALL_MAX + 1, SMALL_MAX + 1, 3)],
                                     start=5):
        tb_err = max(tb_err, check_telemetry(J, M, W, 19, seed, dev)[1])
    for J, M, W in ((JOBS_MAIN, JOBS_MAIN, 1), (100_003, 300_009, 256)):
        # weights other than 1 take the float atomics
        tb_err = max(tb_err, check_telemetry(J, M, W, 19, 8, dev,
                                             unit=False)[1])
    for name in ("dcsim_advance", "dcsim_advance f64", "telemetry_accum",
                 "telemetry_accum large"):
        engine_repeat_and_graph(name, dev)
    fa_q, fa_kw, fa_err = check_flash(FLASH_MAIN, dev)
    for case in FLASH_RAGGED:
        fa_err = max(fa_err, check_flash(case, dev)[2])
    for case in FLASH_TC_EDGES:         # the tensor-core instance's edges
        fa_err = max(fa_err, check_flash(case + ("bfloat16",), dev)[2])
    flash_row_controls(dev)
    ss_main, ss_err = check_ssm(*SSM_MAIN, dev)
    for case in SSM_RAGGED + SSM_EDGES:
        ss_err = max(ss_err, check_ssm(*case, dev)[1])
    mc_err = mc_kernels(dev)

    log(f"[elapsed] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
    # phase 4: card vs CPU
    parity("one_farm n512 j600", *one_farm_cfg(512, 600), dev)
    parity("dag_chain SINGLE_TIMER", *dag_chain_cfg(), dev)
    from repro_torch.core.types import SchedPolicy, TraceConfig, TraceKind
    traced = TraceConfig(enabled=True)
    for pol in ("ROUND_ROBIN", "NETWORK_AWARE"):
        c, a, sp, tau, topo, _ = case_d_cfg(getattr(SchedPolicy, pol), 4,
                                            100, 30.0)
        if pol == "ROUND_ROBIN":
            c = dataclasses.replace(c, trace=traced)
        g = parity(f"case D fat_tree k=4 {pol} 100 jobs", c, a, sp, tau,
                   dev, topo, tag="[net-parity]")
        if c.trace.enabled and not {TraceKind.FLOW_SPAWN,
                                    TraceKind.FLOW_FINISH} <= set(
                g.trace.buf[:int(g.trace.ptr), 0].int().tolist()):
            fail("net-parity: the traced case D run recorded no flows")
    c, a, sp, tau, topo = star_cfg(2)
    g = parity("star max_flows=2", c, a, sp, tau, dev, topo,
               tag="[net-parity]")
    if int(g.flows.flows_dropped) == 0:
        fail("net-parity: the star with two flow slots dropped no flow")
    c, a, sp, tau = thermal_main_cfg(512, TH_PAR_JOBS)
    g = parity(f"thermal main config n512 j{TH_PAR_JOBS}",
               dataclasses.replace(c, trace=traced), a, sp, tau, dev,
               tag="[thermal-parity]")
    if not (float(g.thermal.throttle_seconds.sum()) > 0
            and int(g.thermal.defer_count) > 0):
        fail("thermal-parity: the main configuration at 512 servers did "
             "not both throttle and defer")
    if not {TraceKind.THROTTLE_CROSSING, TraceKind.RELEASE,
            TraceKind.CTRL_TICK} <= set(
            g.trace.buf[:int(g.trace.ptr), 0].int().tolist()):
        fail("thermal-parity: the traced run recorded no crossing, release "
             "or controller tick")
    g = parity("thermal_case THERMAL_AWARE guard 500 jobs",
               *thermal_case_cfg(), dev, tag="[thermal-parity]")
    if not float(g.thermal.throttle_seconds.sum()) > 0:
        fail("thermal-parity: thermal_case's guard never throttled")
    c, a, sp, tau = one_farm_cfg(512, 600)
    from repro_torch.kernels import dcsim_step
    parity("one_farm n512 j600 float64 clock",
           dataclasses.replace(c, time_dtype=torch.float64), a, sp, tau, dev,
           tag="[thermal-parity]")
    f64_launches = dcsim_step.CLOCK_LAUNCHES["float64"]
    for cap in (65536, 64):
        g = parity(f"rich scenario capacity {cap}", rich_trace_cfg(cap),
                   *rich_trace_inputs(), dev, tag="[trace-parity]",
                   ring_exact=True)
        if (int(g.trace.dropped) > 0) != (cap == 64):
            fail(f"trace-parity: {int(g.trace.dropped)} records dropped at "
                 f"capacity {cap}")
    for name in MC_PARITY:
        mc_parity(name, dev)
    lm_parity(dev)

    log(f"[elapsed] phase 5 starts at {time.perf_counter() - t_start:.1f} s")
    # phase 5: the discrete-event main run through the user's entry point
    cfg, arr, specs, _ = one_farm_cfg(N_MAIN, JOBS_MAIN)
    ops.reset_launch_counts()
    res = farm.simulate(cfg, arr, specs)
    counts = ops.launch_counts()
    ri = res.run_info
    if res.n_finished != JOBS_MAIN:
        fail(f"main run finished {res.n_finished} of {JOBS_MAIN} jobs")
    lat = res.latencies
    if not (np.isfinite(lat).all() and (lat > 0).all()
            and np.isfinite(res.server_energy) and res.server_energy > 0):
        fail("main run produced non-finite or non-positive results")
    if res.telemetry.jobs_binned != JOBS_MAIN:
        fail(f"main run binned {res.telemetry.jobs_binned} job latencies")
    if counts["telemetry_accum"] != ri.steps or \
            counts["dcsim_advance"] != ri.steps * cfg.events_per_step:
        fail(f"main run launch counts {counts} for {ri.steps} steps")
    log(f"[main] one_farm {N_MAIN} servers x {C_MAIN} cores, {JOBS_MAIN} "
        f"jobs: wall {ri.wall_s:.3f} s, events {ri.events}, steps "
        f"{ri.steps}, {ri.events_per_s:.1f} events/s; mean latency "
        f"{res.mean_latency * 1e3:.3f} ms, p99 {res.p99_latency * 1e3:.3f} "
        f"ms, energy {res.server_energy:.1f} J; launches {counts}")
    net_counts, net_cfg, net_arr, net_specs, net_tau, net_topo = \
        net_main(dev)
    th = thermal_main(dev)
    th_counts, th_cfg, th_arr, th_specs, _ = th
    tr_counts, tr_cfg = trace_main(dev, th)
    mc_rows = mc_main(dev)
    # the graph audit of every engine path's step, on the card
    log(f"[elapsed] [simlint] starts at {time.perf_counter() - t_start:.1f} s")
    simlint_phase()

    log(f"[elapsed] phase 6 starts at {time.perf_counter() - t_start:.1f} s")
    # phase 6: the serving main run through the user's entry point
    lm_cfg, lm_params, lm_toks, lm_counts = lm_main(dev)

    # kernel times at the main paths' shapes
    log(f"[elapsed] kernel times start at "
        f"{time.perf_counter() - t_start:.1f} s")
    times = engine_call_times(dev, ENGINE_TIMED | ENGINE_TIMED_MORE)
    for name, tm in times.items():
        if tm["ops"] != 1 or set(tm["op_names"]) & {"memcpy", "memset"}:
            fail(f"{name}: {tm['ops']} device operations per call "
                 f"({tm['op_names']}), not one")
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}.cu",
         "replaces": replaces, "launches": counts[name],
         "max_abs_err": err, "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "bound_op": times[name]["bound_op"], "library_ms": None,
         "device_ops": times[name]["ops"], "net_launches": net_counts[name],
         "thermal_launches": th_counts[name]}
        for name, src, replaces, err in (
            ("dcsim_advance", "dcsim_step",
             "src/repro/kernels/dcsim_step.py:68", dc_err),
            ("telemetry_accum", "telemetry_bin",
             "src/repro/kernels/telemetry_bin.py:51", tb_err))]
    dev_us = {name: times[name]["device_us"]
              for name in ("dcsim_advance", "telemetry_accum")}
    # the advance's float64 instance (its launches: the float64 parity
    # run) and its float32 instance at the network run's farm
    for key, name, launches in (("f64", "dcsim_advance f64", f64_launches),
                                ("n1024", "dcsim_advance 1024",
                                 net_counts["dcsim_advance"])):
        tm = times[name]
        kernels[0][key] = {
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "device_ms": None if tm["device_us"] is None
            else tm["device_us"] / 1e3, "device_ops": tm["ops"],
            "launches": launches}
    # the batched launches, rows of their own: timed at [mc-main]'s
    # 1,024-replica point, their launches there (and at the 64-replica one)
    for name, src, replaces in (
            ("dcsim_advance", "dcsim_step",
             "src/repro/kernels/dcsim_step.py:68"),
            ("telemetry_accum", "telemetry_bin",
             "src/repro/kernels/telemetry_bin.py:51")):
        tm = times[f"{name} replicas"]
        kernels.append({
            "name": f"{name} (replicas)", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": replaces, "launches": mc_rows[0]["counts"][name],
            "max_abs_err": mc_err[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "bound_op": tm["bound_op"],
            "library_ms": None, "device_ops": tm["ops"],
            "device_ms": None if tm["device_us"] is None
            else tm["device_us"] / 1e3,
            "replicas": MC_POINTS[0][0],
            "launches_r64": mc_rows[1]["counts"][name]})
        dev_us[f"{name} (replicas)"] = tm["device_us"]
    lm_entries, lm_dev_us = lm_kernel_entries(
        (fa_q, fa_kw), ss_main, lm_counts, fa_err, ss_err, dev)
    kernels += lm_entries
    dev_us |= lm_dev_us
    for k in kernels:
        d = dev_us[k["name"]]
        k["device_ms"] = None if d is None else d / 1e3
        if "replicas" in k:
            R, n, nj, mj = MC_POINTS[0]
            size = f"N={n}" if "advance" in k["name"] else f"J={mj}"
            log_engine_time(k["name"], times[k["name"].split(" (")[0]
                                             + " replicas"],
                            f"; the batched launch at R={R} x {size}; "
                            f"{k['launches']} launches in [mc-main] R={R}, "
                            f"{k['launches_r64']} at R=64")
            continue
        if "device_ops" in k:
            log_engine_time(k["name"], times[k["name"]],
                            f"; {k['launches']} launches in its main run, "
                            f"{k['net_launches']} in the network main run, "
                            f"{k['thermal_launches']} in the thermal main "
                            f"run")
            continue
        lib = "" if k["library_ms"] is None else \
            f"; library call {k['library_ms'] * 1e3:.1f} us"
        inst = f" ({k['instance']})" if "instance" in k else ""
        log(f"[time] {k['name']}{inst}: {k['ms'] * 1e3:.1f} us per call on "
            f"the stream, {'not measured' if d is None else f'{d:.2f} us'} of "
            f"device time (profiler); bound {k['bound_ms'] * 1e3:.3f} us by "
            f"{k['bound_op']}; plain version {k['plain_ms'] * 1e3:.1f} us"
            f"{lib}; {k['launches']} launches in its main run")
    log_engine_time("telemetry_accum large", times["telemetry_accum large"],
                    " (the cross-block path; not on the main path)")
    log_engine_time("dcsim_advance f64", times["dcsim_advance f64"],
                    f" (the float64-clock instance at {N_MAIN} x {C_MAIN}; "
                    f"{f64_launches} launches in the float64 parity run)")
    log_engine_time("dcsim_advance 1024", times["dcsim_advance 1024"],
                    f" (at the network run's {NET_SERVERS} x {C_MAIN}; "
                    f"{net_counts['dcsim_advance']} launches there)")
    log(f"[elapsed] profiles start at {time.perf_counter() - t_start:.1f} s")
    main_prof = profile_window(cfg, arr, specs, dev)
    simlint_main(dev, main_prof)
    profile_window(net_cfg, net_arr, net_specs, dev, topo=net_topo,
                   tau=net_tau, tag="network run")
    profile_window(th_cfg, th_arr, th_specs, dev, tag="thermal run")
    profile_window(tr_cfg, th_arr, th_specs, dev, tag="traced thermal run")
    profile_serving(lm_cfg, lm_params, lm_toks, dev)

    # rack sharding last: its process group and profiler windows come
    # after every kernel timing and profile of the earlier paths
    log(f"[elapsed] phase 7 starts at {time.perf_counter() - t_start:.1f} s")
    shard_counts = shard_phases(dev, res)
    for k in kernels[:2]:
        k["shard_launches"] = {
            "K=1": shard_counts["K=1"][k["name"]],
            "K=2": [c[k["name"]] for c in shard_counts["K=2"]]}
        log(f"[shard] {k['name']}: {k['shard_launches']['K=1']} launches in "
            f"[shard-main] K=1, {k['shard_launches']['K=2']} a rank at K=2")

    log(f"[total] chip_smoke.py wall {time.perf_counter() - t_start:.1f} s, "
        f"the kernels' builds included")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--engine-calls"] and len(sys.argv) == 3:
        engine_calls_of(sys.argv[2])
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--engine-calls ROOT]")
    else:
        main()
