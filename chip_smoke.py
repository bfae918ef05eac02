#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the main path from src/repro_torch/kernels/
     csrc (one nvcc per source, started together);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at ragged ones;
  4. parity of the port on the card against the port on the CPU for two
     scenarios, with the kernels' launch counters checked against the
     engine's step count;
  5. the main run: farm.simulate on a 65,536-server x 4-core farm (the
     largest farm benchmarks/bench_engine.py records) under 600 Poisson
     jobs at 50% utilisation; every job must finish.  Each kernel is timed
     at this size beside its bound and its plain version.

The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Without a card, or outside a
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "tests"))      # torch_kernel_inputs

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 non-tensor ops/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
N_MAIN, C_MAIN, JOBS_MAIN = 65_536, 4, 600


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
    recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (e.count, e.self_device_time_total)
    return out, wall


def kernel_device_us(fn, names, reps: int = 100):
    """Device time of one call of ``fn`` (the kernels whose names contain
    one of ``names``), from the profiler over ``reps`` calls; None when the
    profiler sees no device time."""
    def many():
        for _ in range(reps):
            fn()
    ks, _ = device_kernels(many)
    us = sum(t for k, (_, t) in ks.items() if any(n in k for n in names))
    return us / reps if us > 0 else None


def bound_ms(n_bytes: float, n_ops: float):
    tb, to = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def ulp_err(got: torch.Tensor, exp: torch.Tensor) -> float:
    """Largest |got - exp| in units of exp's last place."""
    up = torch.nextafter(exp, torch.full_like(exp, math.inf)) - exp
    return float(((got - exp).abs() / up).max())


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def check_dcsim(n, c, seed, dev, scale=0.6):
    """Every server state, ~30% throttled, half the cores busy, some slots
    finishing exactly at t_next (the tests' builder)."""
    from repro_torch.kernels import dcsim_step, ref
    from torch_kernel_inputs import dcsim_inputs, torch_args
    args = torch_args(dcsim_inputs(n, c, seed), dev)
    got = dcsim_step.dcsim_advance(*args, throttle_power_scale=scale)
    exp = ref.dcsim_advance_reference(*args, throttle_power_scale=scale)
    torch.cuda.synchronize()
    names = ("new_busy", "done", "energy", "busy_seconds", "candidate")
    err = 0.0
    for name, g, e in zip(names, got, exp):
        if g.shape != e.shape or g.dtype != e.dtype:
            fail(f"dcsim_advance n={n} c={c}: {name} is {g.dtype}"
                 f"{tuple(g.shape)}, plain {e.dtype}{tuple(e.shape)}")
        if name in ("energy", "busy_seconds"):
            # exact or <= 1 ulp (the kernel rounds each op as PyTorch
            # does; a contracted FMA would be within one ulp)
            u = ulp_err(g, e)
            if u > 1.0:
                fail(f"dcsim_advance n={n} c={c}: {name} off by {u} ulp")
            err = max(err, float((g - e).abs().max()))
        elif not torch.equal(g, e):
            fail(f"dcsim_advance n={n} c={c}: {name} differs from the "
                 f"plain version")
    log(f"[kernels] dcsim_advance n={n} c={c}: matches the plain version "
        f"(max abs err {err})")
    return args, err


def check_telemetry(J, M, W, K, seed, dev):
    """Log-uniform latencies off the bin edges with both clamps hit, 0/1
    weights, integer-valued histograms (the tests' builder)."""
    from repro_torch.kernels import ref, telemetry_bin
    from torch_kernel_inputs import tb_inputs, torch_args
    args = torch_args(tb_inputs(J, M, 64, W, K, seed), dev)
    got = telemetry_bin.telemetry_accum(*args)
    exp = ref.telemetry_accum_reference(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, e in zip(("job_hist", "task_hist", "win"), got, exp):
        d = float((g - e).abs().max())
        # 0/1 weights: every partial sum is an exact integer, so the
        # atomics' order cannot show -- bitwise equality is required
        if not torch.equal(g, e):
            fail(f"telemetry_accum J={J} M={M}: {name} differs from the "
                 f"plain version (max abs err {d})")
        err = max(err, d)
    if float(got[0].sum() - args[4].sum()) != float(args[1].sum()):
        fail("telemetry_accum: job histogram mass not conserved")
    log(f"[kernels] telemetry_accum J={J} M={M} win=({W},{K}): bitwise "
        f"equal to the plain version (max abs err {err})")
    return args, err


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


def run_engine(cfg, arr, specs, tau, dev):
    from repro_torch.core import engine, jobs
    jt = jobs.build_jobs(cfg, np.asarray(arr), specs, device=dev)
    state, tc = engine.init_state(cfg, jt)
    if tau is not None:
        state.farm.srv_tau = torch.full_like(state.farm.srv_tau, tau)
    return engine.run(state, cfg, tc)


def parity(name, cfg, arr, specs, tau, dev):
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    cpu = run_engine(cfg, arr, specs, tau, "cpu")
    t_cpu = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gpu = run_engine(cfg, arr, specs, tau, dev)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    counts = ops.launch_counts()
    worst = 0.0
    for (path, g), (_, c) in zip(tree_leaves(gpu), tree_leaves(cpu)):
        g = g.cpu()
        if g.dtype.is_floating_point and path not in ("telem.job_hist",
                                                      "telem.task_hist"):
            # float reductions (window power sums) run in another order
            # on the card; everything else repeats the CPU's arithmetic
            if not torch.allclose(g, c, rtol=1e-5, atol=0.0):
                fail(f"parity {name}: {path} beyond rtol 1e-5")
            rel = ((g - c).abs() / c.abs().clamp(min=1e-30)).max()
            worst = max(worst, float(rel))
        elif not torch.equal(g, c):
            # discrete state, and histograms of exact integer counts
            fail(f"parity {name}: {path} differs between card and CPU")
    steps, events = int(gpu.steps), int(gpu.events)
    if counts["telemetry_accum"] != steps:
        fail(f"parity {name}: telemetry_accum launched "
             f"{counts['telemetry_accum']} times in {steps} steps")
    if counts["dcsim_advance"] != steps * cfg.events_per_step:
        fail(f"parity {name}: dcsim_advance launched "
             f"{counts['dcsim_advance']} times, expected steps x K = "
             f"{steps} x {cfg.events_per_step}")
    if not bool(gpu.done):
        fail(f"parity {name}: the run did not finish")
    log(f"[parity] {name}: card == CPU (discrete exact, floats max rel err "
        f"{worst:.3g}); events {events}, steps {steps}, advance launches "
        f"{counts['dcsim_advance']} (steps x K), telemetry launches "
        f"{counts['telemetry_accum']}; CPU {t_cpu:.2f} s, card "
        f"{t_gpu:.2f} s")


def profile_window(cfg, arr, specs, dev, warm: int = 20, steps: int = 10):
    """Where a macro-step's time goes: ``steps`` macro-steps of the main
    run (after ``warm``) under torch.profiler -- device busy share of the
    wall clock, kernel launches per step, the kernels that take the most
    device time, and the share of the two hand-written kernels."""
    from repro_torch.core import engine, jobs
    jt = jobs.build_jobs(cfg, np.asarray(arr), specs, device=dev)
    box = list(engine.init_state(cfg, jt))
    for _ in range(warm):
        box[0] = engine.sim_step(box[0], cfg, box[1])

    def window():
        for _ in range(steps):
            box[0] = engine.sim_step(box[0], cfg, box[1])

    ks, wall = device_kernels(window)
    busy_us = sum(t for _, t in ks.values())
    if busy_us <= 0:
        log("[profile] the profiler recorded no device time: device busy "
            "share not measured")
        return
    n_launch = sum(c for c, _ in ks.values())
    ours = sum(t for k, (_, t) in ks.items()
               if "dcsim" in k or "telemetry_bin" in k)
    log(f"[profile] main run, {steps} macro-steps after {warm}: wall "
        f"{wall * 1e3:.1f} ms under the profiler, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e3 / (wall * 1e3):.1f}%"
        f" of wall), {n_launch} kernel launches ({n_launch / steps:.0f} per "
        f"macro-step); the two hand-written kernels take "
        f"{100 * ours / busy_us:.1f}% of the device time")
    for k, (c, t) in sorted(ks.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[profile]   {t / 1e3:8.3f} ms {c:6d} calls  {k[:90]}")


# --------------------------------------------------------------------------

def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs "
             "an NVIDIA GPU")
    from repro_torch.core import farm
    from repro_torch.kernels import build, ops

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
        regs = [ln.strip() for ln in report.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {path.name} ({secs:.1f} s) "
            + " | ".join(regs))

    # phase 3: kernels vs plain versions
    dc_main, dc_err = check_dcsim(N_MAIN, C_MAIN, 1, dev)
    _, e2 = check_dcsim(1000, 4, 2, dev)
    _, e3 = check_dcsim(1000, 3, 3, dev)          # scalar (non-float4) path
    dc_err = max(dc_err, e2, e3)
    tb_main, tb_err = check_telemetry(JOBS_MAIN, JOBS_MAIN, 1, 19, 4, dev)
    _, e4 = check_telemetry(100_003, 300_009, 256, 19, 5, dev)
    tb_err = max(tb_err, e4)

    # phase 4: card vs CPU
    parity("one_farm n512 j600", *one_farm_cfg(512, 600), dev)
    parity("dag_chain SINGLE_TIMER", *dag_chain_cfg(), dev)

    # phase 5: the main run through the user's entry point
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

    # kernel times at the main path's shapes
    from repro_torch.kernels import dcsim_step, ref, telemetry_bin
    dc_kw = {"throttle_power_scale": 0.6}
    dc_ms = time_ms(lambda: dcsim_step.dcsim_advance(*dc_main, **dc_kw))
    dc_plain = time_ms(lambda: ref.dcsim_advance_reference(*dc_main,
                                                           **dc_kw))
    outs = dcsim_step.dcsim_advance(*dc_main, **dc_kw)
    dc_bytes = nbytes(*[a for a in dc_main if torch.is_tensor(a)],
                      *outs)
    # per server: C compares, C adds, C selects, ~12 flops of power and
    # accrual, 3 mins
    dc_bound, dc_by = bound_ms(dc_bytes, N_MAIN * (3 * C_MAIN + 15))
    tb_ms = time_ms(lambda: telemetry_bin.telemetry_accum(*tb_main))
    tb_plain = time_ms(lambda: ref.telemetry_accum_reference(*tb_main))
    touts = telemetry_bin.telemetry_accum(*tb_main)
    nnz = int((tb_main[1] != 0).sum() + (tb_main[3] != 0).sum())
    # the kernel reads every weight but a value only where its weight is
    # non-zero
    tb_bytes = nbytes(tb_main[1], tb_main[3], *tb_main[4:9], *touts) \
        + 4 * nnz
    # per weighted value: max, divide, log (~20 flops), multiply, clamp,
    # add; plus the window row
    tb_bound, tb_by = bound_ms(tb_bytes, nnz * 25 + tb_main[8].numel())
    kernels = [
        {"name": "dcsim_advance", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dcsim_step.cu",
         "replaces": "src/repro/kernels/dcsim_step.py:68",
         "launches": counts["dcsim_advance"], "max_abs_err": dc_err,
         "ms": dc_ms, "plain_ms": dc_plain, "bound_ms": dc_bound,
         "bound_by": dc_by, "library_ms": None},
        {"name": "telemetry_accum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/telemetry_bin.cu",
         "replaces": "src/repro/kernels/telemetry_bin.py:51",
         "launches": counts["telemetry_accum"], "max_abs_err": tb_err,
         "ms": tb_ms, "plain_ms": tb_plain, "bound_ms": tb_bound,
         "bound_by": tb_by, "library_ms": None},
    ]
    dev_us = {
        "dcsim_advance": kernel_device_us(
            lambda: dcsim_step.dcsim_advance(*dc_main, **dc_kw), ["dcsim"]),
        "telemetry_accum": kernel_device_us(
            lambda: telemetry_bin.telemetry_accum(*tb_main),
            ["telemetry_bin"])}
    for k in kernels:
        d = dev_us[k["name"]]
        log(f"[time] {k['name']}: {k['ms'] * 1e3:.1f} us per call on the "
            f"stream, {'not measured' if d is None else f'{d:.2f} us'} of "
            f"device time (profiler); bound {k['bound_ms'] * 1e3:.3f} us by "
            f"{k['bound_by']}; plain version {k['plain_ms'] * 1e3:.1f} us; "
            f"{k['launches']} launches in the main run")
    profile_window(cfg, arr, specs, dev)

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
