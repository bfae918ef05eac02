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
     at 512 servers and 150 jobs (throttling must engage and deferral must
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
     [scalar-parity]: the seed scalar hot loops
     (use_vectorized_hot_loop=False) on dag_chain, one_farm under
     ROUND_ROBIN at 512 servers, the star with two flow slots, case D's
     k=4 ROUND_ROBIN run traced and the replicas_r3 batch, card against
     CPU and each against the card's vectorized run of the same
     configuration (rtol/atol 1e-6, the rings decoding to the same
     stream); the CPU side of every engine run held card against CPU
     here and in phase 7 is computed ahead by a worker process (this
     script with --cpu-sides DIR: no card, one thread) while this
     process runs the card sides;
  5. the discrete-event main run: farm.simulate on a 65,536-server x
     4-core farm (the largest farm benchmarks/bench_engine.py records)
     under 300 Poisson jobs at 50% utilisation; every job must finish;
     then the network main run: farm.simulate with topo= on a k=16
     fat-tree (1,024 servers, 320 switches, two line cards each) under
     case study D's workload scaled to that width (100 two-task chains
     with 100 MB edges, round-robin placement, so every chain ships one
     flow); every job must finish, no flow may be dropped, and the
     switch-power windows must integrate to the switch energy; then the
     thermal main run ([thermal-main]): farm.simulate on 65,536 servers x
     4 cores with the thermal subsystem and its whole control plane
     (benchmarks/bench_engine.py control_plane_farm with throttling armed)
     under 200 jobs: all finish, jobs are deferred, servers throttle, the
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
     single run of one replica; then [scalar-main]: the engine main run
     with use_vectorized_hot_loop=False, every result equal to [main]'s,
     its events/s against [main]'s and its launches a macro-step; then
     the graph audit
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
     attention on its bf16 tensor-core instance.  (Phase 3 also holds the
     attention at moonshot-v1-16b-a3b's prefill shape, hd 128, 16 heads
     over 16, causal, to its plain version.)
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
  [roofline] (on [lm-main]'s weights, at most about 40 s): [skip-attn]
  times hymba's warm prefill of [lm-main]'s prompts with and without
  skip_attention (the roofline probe: projections kept, attention
  dropped), three of each in turns by CUDA events, with the launches of
  each (flash_attention 32 against 0, ssm_scan 32 in both), the
  difference beside flash_attention's own time, and holds the ablated
  prefill of [lm-parity]'s 2-layer float32 cut card against CPU (logits
  1e-3); [dryrun-main] prints the roofline terms and predicted peak of
  the port's dry run (repro_torch.launch.dryrun's lower_cell, a
  subprocess over a fake process group and fake tensors, started with
  the script) of [train-main]'s work on a one-rank mesh; after
  [train-main] the predicted peak must lie within 0.80-1.02 of the
  measured max_memory_allocated, and the measured step over the
  estimate is printed.
  Then MoE serving (models/moe.py), after hymba's weights are freed:
  [moe-layer] runs one MoE layer of moonshot-v1-16b-a3b and of
  qwen3-moe-235b-a22b at full width on B=1 x 1,536 random bf16 hidden
  states (moe_scatter == the einsum oracle on the card within 2e-2, dropped
  equal; moonshot's card == CPU); [moe-parity] runs moonshot at full width
  cut to 2 layers in float32, card against CPU (prefill and 4 decode
  steps' logits within 1e-3, generate's greedy tokens, the attention once
  a layer on its CUDA-core instance); both hold a differing route only at
  a near-tie (the route-flip rule of tests/torch_kernel_inputs.py);
  [moe-main] runs ServeEngine.generate on moonshot's full configuration
  (48 layers, bf16, 28.9 B seeded random parameters) for [lm-main]'s
  traffic: 48 tensor-core attention launches, no scan, first token,
  decode per step, tokens/s, peak memory, a [profile] of one prefill, one
  decode step and one MoE layer at each of their shapes; then the
  attention is timed at moonshot's prefill shape beside SDPA with
  is_causal=True.
  Then recurrent serving (models/ssm.py): [xlstm-parity] runs
  xlstm-350m at full width cut to 2 layers (one mLSTM, one sLSTM) in
  float32 on B=2 x 1,100-token prompts (the mLSTM's parallel form in
  three query chunks of 512, the last ragged), card against CPU (prefill
  and 4 decode steps' logits within 1e-3, generate's greedy tokens, no
  kernel launched), the decode-equals-train law of tests/test_archs.py on
  the card (5e-2), and hymba's full width with block_pattern=("mamba",)
  cut to 2 layers the same way (the CUDA scan once a layer in the
  prefill); [xlstm-main] runs ServeEngine.generate on xlstm-350m's full
  configuration (24 layers, bf16, seeded random weights) for [lm-main]'s
  traffic: valid tokens, finite logits, no kernel launched, first token,
  decode per step, tokens/s, peak memory, and a [profile] of one mLSTM
  and one sLSTM layer's prefill at the main shape and of one decode step,
  scaled to a prefill's launches and device time.
  Then the encoder-decoder and the VQ-token front end: [whisper-parity]
  runs whisper-large-v3 at full width cut to 2 encoder + 2 decoder
  layers in float32 on 2 seeded windows of 1,500 frames and 100-token
  prompts, card against CPU (the encoder output, the prefill's and 3
  decode steps' logits within 1e-3, the same greedy tokens, the
  attention on its CUDA-core instance), then the decode-equals-train law
  on the card; [whisper-main] serves whisper-large-v3's full
  configuration (32 + 32 layers, bf16, seeded random weights) to 4
  requests of 1,500 frames and 224 prompt tokens, 32 new, greedy, through
  make_prefill and make_serve_step in a loop that mirrors generate: the
  encoder, first token, decode per step, tokens/s, peak memory, the
  attention's launches by shape (encoder, decoder prefill, cross prefill,
  cross decode), and a [profile] of one prefill and one decode step;
  [vlm-main] runs ServeEngine.generate on chameleon-34b's full
  configuration (48 layers, 34.3 B parameters, bf16) for [lm-main]'s
  traffic.  Phase 3 holds the attention at these five shapes to its
  plain version (2e-2 and the row check), and each is timed beside its
  bound, its plain version and SDPA at the same mask.
  Training (train/step.py): phase 3 also holds both backward kernels
  (flash_attention_backward, ssm_scan_backward) against their plain
  versions: the attention at hymba-1.5b's training shape (4, 25/5, 4,096,
  hd 64, causal, window 1,024), moonshot's hd 128, gemma2's hd 256 with
  window and softcap 50, whisper's encoder and cross-attention, ragged
  lengths, the float32 instance and the forward's tensor-core edges,
  within 2e-2 of each output's largest magnitude in bf16 and 1e-4 in
  f32; the scan at (4, 4,096, 3,200, 16), (3, 37, 200, 16) and the lane
  edges, with and without a final-state gradient, within 1e-4.  At every
  one of these cases a second call must give bit-equal outputs (neither
  backward kernel adds with atomics), and the [kernels] line names the
  instance that ran (the attention's bf16 head dims 16-128 on the tensor
  cores, mma_bf16; f32 and bf16 hd 256 on the CUDA cores, simt_f32; the
  scan's lane split).
  [train-parity] (after the serving profiles, with hymba's serving
  weights freed; its CPU steps run in the CPU sides' worker, one thread,
  from the script's start) runs two train steps of hymba-1.5b at full
  width cut to 2 layers in float32 on 2 x 1,100 tokens, card against
  CPU: loss, nll, aux, grad_norm (1e-5) and lr (1e-6) at each step, the
  gradients (1e-4 of each leaf's largest magnitude), the moments and the
  parameters (tests/torch_kernel_inputs.py adamw_param_check), and the
  launches of each LM kernel.  [train-main] (next) runs init_state +
  make_train_step on hymba-1.5b's full configuration (32 layers, bf16,
  remat "dots", AdamWConfig(warmup_steps=0)) for 5 steps on one batch of
  4 x 4,096 seeded tokens: finite metrics, the last loss below the first, the
  forward kernels twice a layer a step (the forward and its recompute)
  and each backward kernel once, the attention's on its tensor-core
  instance; step time (median of steps 2-5), tokens/s, peak memory and a
  [profile] of a sixth step with the backward kernels' share; then both
  backward kernels are timed at its shapes (and the attention's at
  moonshot's hd 128, causal, 4 x 16 heads x 1,536) beside their bounds,
  plain versions and (attention) SDPA's backward: stream time from CUDA
  events around each call, device time from CUDA events around 20
  back-to-back calls, the device operations of one call counted in a
  CUDA graph (graph_ops), and the profiler's time of each of the call's
  kernels where it records them.
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
  8. the mesh side of training and the launcher, after phase 7's process
     groups: [launch-train] runs repro_torch.launch.train.main in this
     process with no process group on smollm-360m's full configuration,
     8 x 2,048 tokens: run A 4 steps saving async at step 2 and blocking
     at 4, run B --resume from step 2, whose step 4 must equal A's within
     the train bands (bit-equality printed), the seconds of each save
     and of the restore; [mesh-parity] holds make_train_step(cfg, mesh)
     to the one-rank step on the card in [train-parity]'s bands: hymba
     cut to 2 layers in f32 on 4 x 1,100 tokens of the port's pipeline
     on a (1, 1) mesh over NCCL in this process and on (2, 1) and (1, 2)
     over two gloo ranks on card 0 (and a batch whose halves hold
     different numbers of valid labels; on (1, 2) the compute splits over
     "model", its heads 13 and 12 of 25, and each step starts from the
     one-rank state before it, as [train-parity]'s do), llama3.2-1b cut
     to 2 layers in f32 on (1, 2) (heads, ff and vocab split), moonshot
     cut to 2 layers: the (1, 2) prefill (routes and drops exact, logits
     1e-4) and one train step, the (2, 1) forward's global loss and aux
     (routes under the near-tie rule); [mesh-main] runs hymba cut to 4
     layers in bf16 on (2, 1), 4 steps of 4 x 4,096 tokens, its blocks
     gathered a period at a time: step time, tokens/s, peak memory a rank
     (against 7.13 GiB, the step that gathered the whole model), the
     losses within 5e-2 of one rank's;
     then a fifth step with a card sync and a barrier before each
     collective: the bytes handed to collectives, the calls' seconds and
     the ranks' waits for each other, apart; [tp-main] runs llama3.2-1b
     at full width cut to 4 of its 16 layers in bf16 (remat "dots") the
     same way on (1, 2) over the gloo ranks and then (1, 1) over NCCL in
     this process: the attention at 16 of 32 query heads over 4 kv heads
     a rank, forward and backward, the (1, 2) peak a rank below (1, 1)'s,
     the losses within 5e-2.  Phase 3 holds the kernels at those ranks'
     shapes (llama's 16/4 heads at 4 x 4,096, hymba's 13 heads, the SSM's
     1,600 channels) against their plain versions, and rows of the
     kernels line time them after phase 8.

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

import atexit
import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# the engine main run's jobs: bench_engine.py's sweep point has 600, cut
# to 150 for the script's clock (every [main]-based run follows it; still
# 38 macro-steps, past the profile windows' 20 + 10), then to 120 when the
# decode layouts' phases took their seconds (30 macro-steps)
N_MAIN, C_MAIN, JOBS_MAIN = 65_536, 4, 120
# the macro-steps a profile or timing window of a main run starts after
# (20 until the decode layouts' phases took their seconds)
PROFILE_WARM = 5
# the traced thermal main run's ring: 40 MB of float32 records
TRACE_CAP = 1 << 21
# Depth cuts that keep the whole script within about two thirds of its
# 1,200 s limit on a slow host; each run keeps its width and every check
# still fires at the cut depth:
# the thermal main run ([thermal-main], [trace-main]), cut from the
# reference's 600 jobs (throttle seconds a server do not depend on the
# width: 15.9 at 512 and at 65,536 servers under 300 jobs)
TH_MAIN_JOBS = 120
# [thermal-parity]'s run of the thermal main configuration at 512 servers
# (it still throttles, defers and ticks the controller at 120; at 100 no
# server throttles)
TH_PAR_JOBS = 120
# [parity]'s and [scalar-parity]'s one_farm at 512 servers
FARM_PAR_JOBS = 100
# [net-parity]'s and [scalar-parity]'s case D runs at k=4 (flows recorded)
CASE_D_PAR_JOBS = 10
# [net-parity]'s and [scalar-parity]'s star with two flow slots: the first
# 15 of its 30 jobs (the CPU run drops 5 flows at 15; it must drop some)
STAR_PAR_JOBS = 15
# the network main run: case study D (benchmarks/case_d_network.py) on a
# k=16 fat-tree, its 30 jobs/s over 16 servers scaled to 1,024 servers
NET_K, NET_JOBS, NET_LAM = 16, 20, 1920.0
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
# the seed scalar hot loops ([scalar-parity], [scalar-main])
SCALAR = {"use_vectorized_hot_loop": False}
# the serving main run and the card-vs-CPU serving parity run
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "hymba_1_5b", 4, 1536, 32
LM_MAX_SEQ = 2048
PAR_LAYERS, PAR_BATCH, PAR_PROMPT, PAR_NEW = 2, 2, 1100, 4
# MoE serving: the main run (moonshot at full size, [lm-main]'s traffic),
# its card-vs-CPU parity run cut to 2 layers (B x prompt sized so the CPU
# side takes seconds and still drops tokens) and one full-width layer of
# each MoE configuration on B=1 x 1,536 random hidden states
MOE_ARCH, MOE_LAYER_ARCHS = "moonshot_v1_16b_a3b", ("moonshot_v1_16b_a3b",
                                                    "qwen3_moe_235b_a22b")
MOE_LAYER_S = 1536
MOE_PAR_LAYERS, MOE_PAR_BATCH, MOE_PAR_PROMPT, MOE_PAR_NEW = 2, 2, 512, 4
# recurrent serving: xlstm-350m's main run ([lm-main]'s traffic) and its
# card-vs-CPU parity run, cut to one layer of each kind; the mamba block
# kind at hymba's width, cut the same way ([lm-parity]'s B x prompt)
XLSTM_ARCH, XLSTM_PAR_LAYERS = "xlstm_350m", 2
# the encoder-decoder: whisper-large-v3's main run (30 s windows of 1,500
# frames, a prompt of previous text at half the 448-token text context,
# greedy) and its card-vs-CPU parity run cut to 2 + 2 layers in float32
WH_ARCH, WH_BATCH, WH_PROMPT, WH_NEW, WH_MAX_SEQ = (
    "whisper_large_v3", 4, 224, 32, 448)
WH_PAR_LAYERS, WH_PAR_BATCH, WH_PAR_PROMPT, WH_PAR_NEW = 2, 2, 100, 4
# training: hymba-1.5b at train_4k's sequence length and the batch one
# card holds (its global batch of 256 is a pod's), steps on one batch
TR_BATCH, TR_SEQ, TR_STEPS = 4, 4096, 3
# the VQ-token front end: chameleon-34b at full width on [lm-main]'s
# traffic; its depth is the one thing to cut if the script runs long
VLM_ARCH, VLM_LAYERS = "chameleon_34b", 48


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
                      ("flash_attention_bwd", ("HMMA", "LDGSTS")),
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
        if name.startswith("flash_attention") and not (n["HMMA"]
                                                      and n["LDGSTS"]):
            fail(f"{name} was not compiled to tensor-core instructions fed "
                 f"by asynchronous copies")


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
        prof = profile_window(cfg, arr, specs, dev, warm=20, topo=topo,
                              tau=tau, tag=tag)
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
    tests/torch_kernel_inputs.py), its first STAR_PAR_JOBS jobs;
    ``max_flows=2`` runs out of flow slots and drop-resolves edges."""
    from repro_torch.core import jobs, topology
    from repro_torch.core.types import SimConfig
    from torch_kernel_inputs import star_scenario
    kw, arr, specs, tau, topo = star_scenario(jobs, topology, max_flows,
                                              n_jobs=STAR_PAR_JOBS)
    return SimConfig(**kw), arr, specs, tau, topo


def thermal_main_cfg(n_servers, n_jobs=TH_MAIN_JOBS):
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


def mc_inputs(name, cfg_kw=None):
    """(cfg, arrivals, specs, taus, topology) of a replica scenario
    (tests/torch_kernel_inputs.py mc_scenario), its SimConfig with
    ``cfg_kw`` applied."""
    from repro_torch.core import jobs, topology, types
    from torch_kernel_inputs import mc_config, mc_scenario
    kw, nested, arrs, specs, taus, net = mc_scenario(name, jobs)
    cfg = dataclasses.replace(mc_config(types, kw, nested), **(cfg_kw or {}))
    topo = topology.fat_tree(4, link_cap=1.25e9) if net else None
    return cfg, arrs, specs, taus, topo


def parity_cases() -> dict:
    """Every engine run the script holds card against CPU ([parity],
    [net-parity], [thermal-parity], [trace-parity], [mc-parity],
    [scalar-parity], [shard-parity]), in the order it runs them:
    {"tag name": (kind, build, cfg_kw)}.  ``build()`` gives an "engine"
    run's (cfg, arr, specs, tau, topo) or an "mc" batch's scenario name;
    ``cfg_kw`` is applied to its SimConfig."""
    from repro_torch.core import jobs, topology, types
    from repro_torch.core.types import SchedPolicy, TraceConfig
    from torch_kernel_inputs import SHARD_SCENARIOS, shard_scenario
    traced = TraceConfig(enabled=True)
    rep = dataclasses.replace

    def case_d(pol, trace):
        c, a, sp, tau, topo, _ = case_d_cfg(pol, 4, CASE_D_PAR_JOBS, 30.0)
        return (rep(c, trace=traced) if trace else c), a, sp, tau, topo

    def thermal_main():
        c, a, sp, tau = thermal_main_cfg(512, TH_PAR_JOBS)
        return rep(c, trace=traced), a, sp, tau, None

    def f64_farm():
        c, a, sp, tau = one_farm_cfg(512, FARM_PAR_JOBS)
        return rep(c, time_dtype=torch.float64), a, sp, tau, None

    def one_farm_rr():
        c, a, sp, tau = one_farm_cfg(512, FARM_PAR_JOBS)
        return rep(c, sched_policy=SchedPolicy.ROUND_ROBIN), a, sp, tau, None

    def shard(name):
        cfg, arr, specs, topo, tau = shard_scenario(name, jobs, topology,
                                                    types)
        return cfg, arr, specs, tau, topo

    rr, na = SchedPolicy.ROUND_ROBIN, SchedPolicy.NETWORK_AWARE
    n_d = CASE_D_PAR_JOBS
    engine = [
        ("[parity]", f"one_farm n512 j{FARM_PAR_JOBS}",
         lambda: one_farm_cfg(512, FARM_PAR_JOBS) + (None,)),
        ("[parity]", "dag_chain SINGLE_TIMER",
         lambda: dag_chain_cfg() + (None,)),
        ("[net-parity]", f"case D fat_tree k=4 ROUND_ROBIN {n_d} jobs",
         lambda: case_d(rr, True)),
        ("[net-parity]", f"case D fat_tree k=4 NETWORK_AWARE {n_d} jobs",
         lambda: case_d(na, False)),
        ("[net-parity]", "star max_flows=2", lambda: star_cfg(2)),
        ("[thermal-parity]", f"thermal main config n512 j{TH_PAR_JOBS}",
         thermal_main),
        ("[thermal-parity]", "thermal_case THERMAL_AWARE guard 500 jobs",
         lambda: thermal_case_cfg() + (None,)),
        ("[thermal-parity]", f"one_farm n512 j{FARM_PAR_JOBS} float64 clock",
         f64_farm)]
    out = {f"{t} {n}": ("engine", b, {}) for t, n, b in engine}
    for cap in (65536, 64):
        out[f"[trace-parity] rich scenario capacity {cap}"] = (
            "engine", lambda cap=cap: (rich_trace_cfg(cap),
                                       *rich_trace_inputs(), None), {})
    for name in MC_PARITY:
        out[f"[mc-parity] {name}"] = ("mc", lambda name=name: name, {})
    for n, b in (("dag_chain SINGLE_TIMER", lambda: dag_chain_cfg() + (None,)),
                 (f"one_farm ROUND_ROBIN n512 j{FARM_PAR_JOBS}", one_farm_rr),
                 ("star max_flows=2", lambda: star_cfg(2)),
                 (f"case D fat_tree k=4 ROUND_ROBIN {n_d} jobs",
                  lambda: case_d(rr, True))):
        out[f"[scalar-parity] {n}"] = ("engine", b, SCALAR)
    out["[scalar-parity] replicas_r3"] = ("mc", lambda: "replicas_r3",
                                          SCALAR)
    for name in SHARD_SCENARIOS:
        out[f"[shard-parity] {name}"] = ("engine",
                                         lambda name=name: shard(name), {})
    return out


def case_inputs(key):
    """(cfg, arr, specs, tau, topo) of an "engine" parity_cases() run,
    its cfg_kw applied."""
    kind, build, kw = parity_cases()[key]
    cfg, arr, specs, tau, topo = build()
    return dataclasses.replace(cfg, **kw), arr, specs, tau, topo


TRAIN_PARITY = "[train-parity]"


def cpu_keys() -> list:
    """The CPU runs the worker computes, in order: every parity_cases()
    entry, then [train-parity]'s two steps."""
    return list(parity_cases()) + [TRAIN_PARITY]


def cpu_side(key):
    """The CPU run of one cpu_keys() entry: an engine run's final state, a
    replica batch's, or [train-parity]'s states and metrics."""
    from repro_torch.core import montecarlo
    if key == TRAIN_PARITY:
        return train_cpu_steps()
    kind, build, kw = parity_cases()[key]
    if kind == "engine":
        cfg, arr, specs, tau, topo = case_inputs(key)
        return run_engine(cfg, arr, specs, tau, "cpu", topo)
    cfg, arrs, specs, taus, topo = mc_inputs(build(), kw)
    sb, tc = montecarlo.batched_state(cfg, arrs, specs, taus=taus,
                                      topo=topo, device="cpu")
    return montecarlo.run_replicas(cfg, sb, tc)


def cpu_sides_worker(out_dir: str) -> None:
    """``--cpu-sides DIR``: every cpu_keys() CPU run in order, on one
    thread and no card, each final state saved to DIR/<index>.pt (renamed
    into place when whole) with its seconds; stops when its parent
    does."""
    torch.set_num_threads(1)
    parent = os.getppid()
    out = pathlib.Path(out_dir)
    for i, key in enumerate(cpu_keys()):
        if os.getppid() != parent:
            return
        t0 = time.perf_counter()
        state = cpu_side(key)
        tmp = out / f"{i}.tmp"
        torch.save({"key": key, "state": state,
                    "secs": time.perf_counter() - t0}, tmp)
        os.replace(tmp, out / f"{i}.pt")


class CpuSides:
    """The CPU sides of the parity runs, computed ahead by a worker process
    (this script with ``--cpu-sides``, no card, one thread) while this
    one runs the card sides, which take longer; a run the worker has not
    delivered by the time it exits is computed here."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
        self.keys = cpu_keys()
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--cpu-sides",
             self.dir], env=env)
        atexit.register(self.close)

    def take(self, key, compute):
        """(state, seconds) of ``key``'s CPU run: the worker's, else
        ``compute()``'s here."""
        if key in self.keys:
            path = pathlib.Path(self.dir) / f"{self.keys.index(key)}.pt"
            while not path.exists() and self.proc.poll() is None:
                time.sleep(0.02)
            if path.exists():
                got = torch.load(path, weights_only=False)
                path.unlink()
                if got["key"] != key:
                    fail(f"cpu side {key}: the worker delivered {got['key']}")
                return got["state"], got["secs"]
        t0 = time.perf_counter()
        state = compute()
        return state, time.perf_counter() - t0

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


CPU_SIDES: CpuSides | None = None       # set by main()


def take_cpu_side(key, compute):
    """(state, seconds) of a parity run's CPU side: from the worker where
    main() started one, else computed here."""
    if CPU_SIDES is not None:
        return CPU_SIDES.take(key, compute)
    t0 = time.perf_counter()
    state = compute()
    return state, time.perf_counter() - t0


def parity_case(key, dev, **kw):
    """parity() of one "engine" parity_cases() entry."""
    tag, name = key.split(" ", 1)
    cfg, arr, specs, tau, topo = case_inputs(key)
    return parity(name, cfg, arr, specs, tau, dev, topo, tag=tag, **kw)


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
    cpu, t_cpu = take_cpu_side(
        f"{tag} {name}", lambda: run_engine(cfg, arr, specs, tau, "cpu", topo))
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


def profile_window(cfg, arr, specs, dev, warm: int = PROFILE_WARM,
                   steps: int = 10,
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
    if res.n_finished != TH_MAIN_JOBS:
        fail(f"thermal-main finished {res.n_finished} of {TH_MAIN_JOBS} "
             f"jobs")
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
    log(f"[thermal-main] {N_MAIN} servers x {C_MAIN} cores, {TH_MAIN_JOBS} "
        f"jobs (every second one deferrable), CARBON_AWARE, throttling at "
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


def windows_in_turns(cfgs, arr, specs, dev, warm=PROFILE_WARM, steps=10,
                     rounds=4):
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
    n_jobs = TH_MAIN_JOBS
    want = {K.ARRIVAL: n_jobs, K.ADMIT: n_jobs,
            K.RELEASE: res.deferred_jobs, K.START: n_jobs,
            K.FINISH: n_jobs, K.JOB_FINISH: n_jobs}
    if res.n_finished != n_jobs:
        fail(f"trace-main finished {res.n_finished} of {n_jobs} jobs")
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
    # macro-steps; two rounds (a b b a), since the script runs near its
    # 1,200 s limit on a slow host (PERF.md §4)
    secs = windows_in_turns({"off": th_cfg, "on": cfg}, arr, specs, dev,
                            rounds=2)
    ratio = [b / a for a, b in zip(secs["off"], secs["on"])]
    log(f"[trace-main] in turns, 10 macro-steps a window from step "
        f"{PROFILE_WARM}: "
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


def mc_parity(name, dev, cfg_kw=None, tag="[mc-parity]"):
    """[mc-parity]: a replica scenario (its SimConfig with ``cfg_kw``
    applied) on the card against the CPU (the engine's limits: discrete
    state and histograms exact, floats rtol 1e-5; every replica's ring
    bit-equal), and each replica of the card's batch against a solo run of
    its inputs on the card (discrete exact, floats rtol 1e-5, the largest
    ulp difference printed).  Returns the card's final batch."""
    from repro_torch.core import engine, montecarlo
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import ops
    cfg, arrs, specs, taus, topo = mc_inputs(name, cfg_kw)

    def on_cpu():
        sb, tc = montecarlo.batched_state(cfg, arrs, specs, taus=taus,
                                          topo=topo, device="cpu")
        return montecarlo.run_replicas(cfg, sb, tc)

    cpu, t_cpu = take_cpu_side(f"{tag} {name}", on_cpu)
    sb, tc = montecarlo.batched_state(cfg, arrs, specs, taus=taus,
                                      topo=topo, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gpu = montecarlo.run_replicas(cfg, sb, tc)
    torch.cuda.synchronize()
    counts, t_gpu = ops.launch_counts(), time.perf_counter() - t0
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
    log(f"{tag} {name}, R={R}: card == CPU (discrete exact, floats "
        f"max rel err {worst:.3g}); every replica == its solo run on the "
        f"card (discrete exact, floats within {solo_ulp:g} ulp); events "
        f"{gpu.events.tolist()}, steps {gpu.steps.tolist()}, finished "
        f"{st['finished'].tolist()}, mean latency "
        f"{np.round(st['mean_latency'], 6).tolist()}; launches {counts} "
        f"({steps} macro-steps x K={cfg.events_per_step}); CPU {t_cpu:.2f} "
        f"s, card {t_gpu:.2f} s{more}")
    return gpu


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
# the seed scalar hot loops: [scalar-parity], [scalar-main]
# --------------------------------------------------------------------------

def scalar_vs_vector(name, sca, vec, cfg) -> str:
    """A scalar-mode final state (one run or a replica batch) against the
    vectorized run of the same configuration on the card, leaf for leaf
    within the reference's ``_final_states_equal`` (rtol/atol 1e-6); a
    traced pair's rings also decode to the same stream
    (``traceio.diff_traces``).  Returns "bit-equal" or the largest
    difference."""
    from repro_torch.core import traceio
    from repro_torch.core.types import tree_leaves
    worst, paths = 0.0, []
    for (path, a), (_, b) in zip(tree_leaves(sca), tree_leaves(vec)):
        if torch.equal(a, b):
            continue
        a64, b64 = a.double(), b.double()
        if not torch.allclose(a64, b64, rtol=1e-6, atol=1e-6):
            fail(f"scalar-parity {name}: {path} beyond rtol/atol 1e-6 of "
                 f"the vectorized run")
        worst = max(worst, float((a64 - b64).abs().max()))
        paths.append(path)
    if cfg.trace.enabled:
        ev_s, _ = traceio.decode(sca.trace, cfg)
        ev_v, _ = traceio.decode(vec.trace, cfg)
        msg = traceio.diff_traces(ev_s, ev_v, check_aux=True,
                                  names=("scalar", "vectorized"))
        if msg is not None:
            fail(f"scalar-parity {name}: rings differ: {msg}")
    if not paths:
        return "bit-equal"
    return (f"not bit-equal: {len(paths)} leaves within abs "
            f"{worst:.3g} ({', '.join(paths[:6])})")


def scalar_parity(dev, vec) -> None:
    """[scalar-parity]: the seed scalar loops card vs CPU under parity()'s
    limits, each card run also against the card's vectorized run of the
    same configuration (``vec``: {name: final state} of phase 4's
    vectorized card runs; the ROUND_ROBIN one_farm variant's is made
    here).  A network run's line gives the spawn loop's length: min(JT,
    N*C) * D edges in every full step."""
    t0 = time.perf_counter()
    cases = (("dag_chain", "dag_chain SINGLE_TIMER"),
             ("one_farm_rr", f"one_farm ROUND_ROBIN n512 j{FARM_PAR_JOBS}"),
             ("star", "star max_flows=2"),
             ("case_d_rr", f"case D fat_tree k=4 ROUND_ROBIN "
              f"{CASE_D_PAR_JOBS} jobs"))
    for key, name in cases:
        g = parity_case(f"[scalar-parity] {name}", dev)
        # the same configuration with the vectorized loops
        c, a, sp, tau, topo = parity_cases()[f"[scalar-parity] {name}"][1]()
        v = vec[key] if key in vec else run_engine(c, a, sp, tau, dev, topo)
        note = scalar_vs_vector(name, g, v, c)
        if c.has_network:
            JT = c.max_jobs * c.tasks_per_job
            loop = min(JT, c.n_servers * c.n_cores) * c.max_children
            note += (f"; the spawn loop walks min(JT={JT}, N*C="
                     f"{c.n_servers * c.n_cores}) x D={c.max_children} = "
                     f"{loop} edges in each of the {int(g.steps)} full "
                     f"steps")
        if key == "star" and int(g.flows.flows_dropped) == 0:
            fail("scalar-parity: the star with two flow slots dropped no "
                 "flow")
        log(f"[scalar-parity] {name}: scalar vs vectorized on the card "
            f"{note}")
    g = mc_parity("replicas_r3", dev, SCALAR, tag="[scalar-parity]")
    note = scalar_vs_vector("replicas_r3", g, vec["replicas_r3"],
                            mc_inputs("replicas_r3")[0])
    log(f"[scalar-parity] replicas_r3: scalar vs vectorized batch on the "
        f"card {note}; the phase took {time.perf_counter() - t0:.1f} s")


def scalar_main(dev, main_res) -> dict:
    """[scalar-main]: the engine main configuration (one_farm 65,536 x 4,
    300 jobs, K=8, LOAD_BALANCE) through farm.simulate in the seed scalar
    loops: every job finishes; jobs finished, dropped, wake counts,
    latencies, energy and the telemetry summary equal [main]'s; the
    kernels launch steps x K and steps times; events/s against [main]'s,
    and the launches of a macro-step from a profiled window."""
    from repro_torch.core import farm
    from repro_torch.kernels import ops
    cfg, arr, specs, _ = one_farm_cfg(N_MAIN, JOBS_MAIN)
    cfg = dataclasses.replace(cfg, **SCALAR)
    ops.reset_launch_counts()
    res = farm.simulate(cfg, arr, specs)
    counts = ops.launch_counts()
    ri = res.run_info
    if res.n_finished != JOBS_MAIN:
        fail(f"scalar-main finished {res.n_finished} of {JOBS_MAIN} jobs")
    if counts["telemetry_accum"] != ri.steps or \
            counts["dcsim_advance"] != ri.steps * cfg.events_per_step:
        fail(f"scalar-main launch counts {counts} for {ri.steps} steps")
    for f in ("n_finished", "dropped", "events", "wake_count", "latencies",
              "server_energy", "energy_per_server", "residency",
              "busy_core_seconds"):
        if not np.array_equal(getattr(res, f), getattr(main_res, f)):
            fail(f"scalar-main: {f} differs from [main]'s")
    ts, tm = res.telemetry, main_res.telemetry
    for f in dataclasses.fields(ts):
        a, b = getattr(ts, f.name), getattr(tm, f.name)
        if not (a is None and b is None) and \
                not np.array_equal(a, b, equal_nan=True):
            fail(f"scalar-main: telemetry {f.name} differs from [main]'s")
    if ri.steps != main_res.run_info.steps:
        fail(f"scalar-main took {ri.steps} steps, [main] "
             f"{main_res.run_info.steps}")
    prof = profile_window(cfg, arr, specs, dev, tag="scalar main run")
    per = "not measured" if prof["launches"] is None \
        else f"{prof['launches']:.0f}"
    main_eps = main_res.run_info.events_per_s
    log(f"[scalar-main] one_farm {N_MAIN} servers x {C_MAIN} cores, "
        f"{JOBS_MAIN} jobs, use_vectorized_hot_loop=False: wall "
        f"{ri.wall_s:.3f} s, events {ri.events}, steps {ri.steps}, "
        f"{ri.events_per_s:.1f} events/s ({ri.events_per_s / main_eps:.3f}"
        f" x [main]'s {main_eps:.1f}); {per} launches a "
        f"macro-step (profiled); kernel launches {counts} (steps x K, "
        f"steps); results equal [main]'s (jobs, drops, wakes, latencies, "
        f"energy, telemetry)")
    return counts


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
    4, 300 jobs) recorded on the card: its ops, scatters and host syncs,
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


def shard_profile(cfg, state, tc, mesh, profiled, warm=PROFILE_WARM,
                  steps=10):
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
    import torch.distributed as dist
    from repro_torch.core import engine, jobs, montecarlo, shard_sim
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import ops
    from torch_kernel_inputs import SHARD_SCENARIOS
    from torch_spmd import count_collectives, shard_initial

    # the reference runs: the unsharded engine on the card (against the
    # CPU for the four configurations)
    unsharded = {name: parity_case(f"[shard-parity] {name}", dev)
                 for name in SHARD_SCENARIOS}
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
# the attention at the serving main runs' shapes, each checked in phase 3
# and timed beside SDPA: moonshot-v1-16b-a3b's prefill (hd 128, 16 heads
# over 16, causal, no window: the shape at which SDPA's own flash backend
# applies), the encoder-decoder's ([whisper-main]: 4 windows of 1,500
# frames, 20 heads of 64, prompts of 224 tokens) and chameleon-34b's
# prefill (GQA 64/8, hd 128, causal): name -> case
FLASH_SERVING = {
    "hd 128": (LM_BATCH, 16, 16, LM_PROMPT, LM_PROMPT, 128, True, 0, 0.0,
               "bfloat16"),
    "whisper encoder": (WH_BATCH, 20, 20, 1500, 1500, 64, False, 0, 0.0,
                        "bfloat16"),
    "whisper cross prefill": (WH_BATCH, 20, 20, WH_PROMPT, 1500, 64, False,
                              0, 0.0, "bfloat16"),
    "whisper cross decode": (WH_BATCH, 20, 20, 1, 1500, 64, False, 0, 0.0,
                             "bfloat16"),
    "whisper decoder prefill": (WH_BATCH, 20, 20, WH_PROMPT, WH_PROMPT, 64,
                                True, 0, 0.0, "bfloat16"),
    "chameleon prefill": (LM_BATCH, 64, 8, LM_PROMPT, LM_PROMPT, 128, True,
                          0, 0.0, "bfloat16"),
}


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
# MoE serving (models/moe.py): [moe-layer], [moe-parity], [moe-main]
# --------------------------------------------------------------------------

def flip_note(flips, n_layers) -> str:
    """Where the routes differ: (forward, layer, batch, token, CPU gap),
    a forward being the prefill or one decode step."""
    return ", ".join(f"forward {i // n_layers} layer {i % n_layers} batch "
                     f"{b} token {t} (CPU gap {g:.3g})"
                     for i, b, t, g in flips)


def moe_layer(dev) -> None:
    """[moe-layer]: one MoE layer of each MoE configuration at full width
    (the port's seeded init, bf16 experts, float32 router) on random bf16
    hidden states, B=1 x MOE_LAYER_S: on the card moe_scatter == the
    einsum oracle at 2e-2 with equal dropped; for moonshot also the card
    == the CPU's moe_scatter under the route-flip rule."""
    from repro_torch import configs
    from repro_torch.models import moe, transformer
    from torch_kernel_inputs import ROUTE_GAP, recorded_routes, route_flips
    for arch in MOE_LAYER_ARCHS:
        t0 = time.perf_counter()
        cfg = configs.get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        p = transformer.Params(transformer._moe_params(
            cfg, transformer._Init(cfg, gen, dev)))
        x = torch.randn((1, MOE_LAYER_S, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        C = moe.capacity(cfg, MOE_LAYER_S)
        with torch.inference_mode():
            with recorded_routes(moe) as got:
                out, aux, dropped = moe.moe_scatter(p, x, cfg)
            oe, ae, de = moe.moe_einsum(p, x, cfg)
        torch.cuda.synchronize()
        err = float((out.float() - oe.float()).abs().max())
        if not torch.isfinite(out.float()).all() or not torch.allclose(
                out.float(), oe.float(), atol=2e-2, rtol=2e-2) or \
                int(dropped) != int(de) or \
                abs(float(aux) - float(ae)) > 1e-5 * abs(float(ae)):
            fail(f"moe-layer {arch}: scatter against einsum on the card: max "
                 f"abs err {err}, dropped {int(dropped)} against {int(de)}, "
                 f"aux {float(aux)} against {float(ae)}")
        per_e = torch.bincount(got[0][0].flatten().long(),
                               minlength=cfg.n_experts)
        cpu = ""
        if arch == MOE_ARCH:
            tc0 = time.perf_counter()
            with torch.inference_mode(), recorded_routes(moe) as exp:
                oc, ac, dc = moe.moe_scatter(copy.deepcopy(p).cpu(), x.cpu(),
                                             cfg)
            flips = route_flips(got, exp)
            if flips:
                cpu = (f"; card against CPU: routes differ only at near-ties "
                       f"(CPU gap under {ROUTE_GAP}) at "
                       f"{flip_note(flips, 1)}, outputs not compared")
            else:
                cerr = float((out.cpu().float() - oc.float()).abs().max())
                if not torch.allclose(out.cpu().float(), oc.float(),
                                      atol=2e-2, rtol=2e-2) or \
                        int(dc) != int(dropped) or \
                        abs(float(ac) - float(aux)) > 1e-5 * abs(float(ac)):
                    fail(f"moe-layer {arch}: card against CPU: max abs err "
                         f"{cerr}, dropped {int(dropped)} against {int(dc)}")
                cpu = (f"; card == CPU: routes equal (route-flip bound "
                       f"{ROUTE_GAP}), dropped equal, output within 2e-2 "
                       f"(max abs err {cerr:.3g}), aux rel 1e-5 (CPU side "
                       f"{time.perf_counter() - tc0:.1f} s)")
        log(f"[moe-layer] {cfg.name}: E={cfg.n_experts} top-{cfg.top_k} "
            f"d_expert={cfg.d_expert} shared={cfg.n_shared_experts}, B=1 x "
            f"{MOE_LAYER_S} bf16 tokens, capacity {C}: scatter == einsum on "
            f"the card within 2e-2 (max abs err {err:.3g}), dropped "
            f"{int(dropped)} of {MOE_LAYER_S * cfg.top_k} choices in both, "
            f"aux {float(aux):.6f}; tokens per expert min {int(per_e.min())} "
            f"max {int(per_e.max())}{cpu}; "
            f"{time.perf_counter() - t0:.2f} s")
        del p, x, out, oe
        torch.cuda.empty_cache()


def moe_parity(dev) -> None:
    """[moe-parity]: moonshot at full width cut to MOE_PAR_LAYERS layers,
    float32, card against CPU: the prefill and MOE_PAR_NEW decode steps
    fed the same tokens (the CPU's greedy ones), their logits within 1e-3
    when no route differs (route-flip rule), then ServeEngine.generate on
    both, the same greedy tokens; the attention launched once a layer on
    its CUDA-core instance."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import moe, transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    from torch_kernel_inputs import ROUTE_GAP, recorded_routes, route_flips
    full = configs.get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_PAR_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    p_gpu = transformer.make_params(cfg,
                                    torch.Generator(device=dev).manual_seed(0))
    p_cpu = copy.deepcopy(p_gpu).cpu()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (MOE_PAR_BATCH, MOE_PAR_PROMPT)))
    prefill, decode = step.make_prefill(cfg), step.make_serve_step(cfg)
    log(f"[moe-parity] {cfg.name} at full width cut to {MOE_PAR_LAYERS} of "
        f"{full.n_layers} layers (the one cut), float32; B={MOE_PAR_BATCH}, "
        f"prompts of {MOE_PAR_PROMPT} tokens (capacity "
        f"{moe.capacity(cfg, MOE_PAR_PROMPT)}), {MOE_PAR_NEW} new tokens")

    def run(params, device, feed):
        """Logits of the prefill and of each decode step, each step fed
        ``feed``'s token (None: this run's own greedy one)."""
        with torch.inference_mode():
            cache = transformer.init_cache(cfg, MOE_PAR_BATCH, LM_MAX_SEQ,
                                           device=device)
            lg, cache = prefill(params, toks.to(device), cache)
            out = [lg.cpu()]
            for i in range(MOE_PAR_NEW):
                tok = (out[-1] if feed is None else feed[i]).argmax(-1)
                lg, cache = decode(params, cache, tok[:, None].to(device),
                                   MOE_PAR_PROMPT + i)
                out.append(lg.cpu())
        return out

    with recorded_routes(moe) as exp:
        l_cpu = run(p_cpu, "cpu", None)
    t_cpu = time.perf_counter() - t0
    C = moe.capacity(cfg, MOE_PAR_PROMPT)
    drops = [int((moe._positions_in_expert(t, cfg) >= C).sum())
             for t, _ in exp[:MOE_PAR_LAYERS]]
    with recorded_routes(moe) as got:
        l_gpu = run(p_gpu, dev, l_cpu)
    flips = route_flips(got, exp)
    worst = 0.0
    if flips:
        logits = (f"routes differ only at near-ties (CPU gap under "
                  f"{ROUTE_GAP}) at {flip_note(flips, MOE_PAR_LAYERS)}: "
                  f"logits not compared")
    else:
        for i, (g, c) in enumerate(zip(l_gpu, l_cpu)):
            worst = max(worst, float((g - c).abs().max()))
            if not torch.isfinite(g).all() or \
                    not torch.allclose(g, c, rtol=1e-3, atol=1e-3):
                fail(f"moe-parity: {'prefill' if i == 0 else f'decode {i}'} "
                     f"logits differ between card and CPU (max abs err "
                     f"{float((g - c).abs().max())})")
        logits = (f"routes equal in every layer of the prefill and the "
                  f"{MOE_PAR_NEW} decode steps (route-flip bound "
                  f"{ROUTE_GAP}); their logits within 1e-3 (max abs err "
                  f"{worst:.3g})")
    prompts = toks.tolist()
    with recorded_routes(moe) as exp:
        r_cpu = ServeEngine(cfg, p_cpu, max_batch=MOE_PAR_BATCH,
                            max_seq=LM_MAX_SEQ, device="cpu").generate(
            prompts, max_new=MOE_PAR_NEW)
    ops.reset_launch_counts()
    with recorded_routes(moe) as got:
        r_gpu = ServeEngine(cfg, p_gpu, max_batch=MOE_PAR_BATCH,
                            max_seq=LM_MAX_SEQ).generate(
            prompts, max_new=MOE_PAR_NEW)
    counts = ops.launch_counts()
    inst = dict(flash_attention.INSTANCE_LAUNCHES)
    if inst != {flash_attention.TENSOR_CORE: 0,
                flash_attention.CUDA_CORE: MOE_PAR_LAYERS} or \
            counts["flash_attention"] != MOE_PAR_LAYERS or counts["ssm_scan"]:
        fail(f"moe-parity: launches {counts}, attention instances {inst}: "
             f"expected the CUDA-core attention once a layer, no scan")
    gen_flips = route_flips(got, exp)
    new_g = [r.tokens[MOE_PAR_PROMPT:] for r in r_gpu]
    new_c = [r.tokens[MOE_PAR_PROMPT:] for r in r_cpu]
    if gen_flips:
        tokens = (f"generate's routes differ only at near-ties at "
                  f"{flip_note(gen_flips, MOE_PAR_LAYERS)}: tokens {new_g} "
                  f"against {new_c}, not compared")
    elif new_g != new_c:
        fail(f"moe-parity: generate gave other greedy tokens on the card: "
             f"{new_g} against {new_c}")
    else:
        tokens = f"generate gave the same greedy tokens {new_g}"
    log(f"[moe-parity] card == CPU: {logits}; the prefill dropped {drops} "
        f"choices a layer on the CPU; {tokens}; launches {counts}, "
        f"attention instances {inst}; CPU side of the steps {t_cpu:.1f} s, "
        f"phase {time.perf_counter() - t0:.1f} s")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()


def moe_layer_ops(cfg, p, x, tag) -> dict:
    """The MoE layer's device time by operation: one moe_scatter call on
    ``x`` under the profiler (after one warm call)."""
    from repro_torch.models import moe
    with torch.inference_mode():
        moe.moe_scatter(p, x, cfg)

        def call():
            with torch.inference_mode():
                moe.moe_scatter(p, x, cfg)
        ks, wall = device_kernels(call)
    return report_profile(f"MoE layer ({tag})", ks, wall, (), 1, "call")


def moe_main(dev) -> int:
    """[moe-main]: moonshot-v1-16b-a3b's full configuration (48 layers,
    bf16) with the port's seeded random weights on the card,
    ServeEngine(max_batch=4, max_seq=2048).generate of 4 prompts of 1,536
    tokens, 32 new tokens, greedy ([lm-main]'s traffic); then a [profile]
    of one prefill and one decode step and of one MoE layer at each of
    their shapes.  Returns the attention's launches in the run."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    cfg = configs.get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = transformer.make_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[moe-main] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} + "
        f"{cfg.n_shared_experts} shared, {n_params / 1e9:.3f} B parameters "
        f"({cfg.param_dtype}, router float32; param_count() "
        f"{cfg.param_count() / 1e9:.3f} B), random init on the card in "
        f"{init_s:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
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
    if counts["flash_attention"] != cfg.n_layers or counts["ssm_scan"]:
        fail(f"moe-main: launch counts {counts}, expected {cfg.n_layers} "
             f"attention launches (one a layer of the one prefill), no scan")
    if inst != {flash_attention.TENSOR_CORE: cfg.n_layers,
                flash_attention.CUDA_CORE: 0}:
        fail(f"moe-main: bf16 attention ran on instances {inst}, expected "
             f"the tensor-core one once a layer")
    for r, p in zip(res, prompts):
        new = r.tokens[len(p):]
        if r.tokens[:len(p)] != p or len(new) != LM_NEW or \
                not all(0 <= t < cfg.vocab for t in new):
            fail(f"moe-main: bad generation {new}")
    tm = engine.timings
    del engine
    toks = torch.tensor(prompts, device=dev)
    prefill, decode = step.make_prefill(cfg), step.make_serve_step(cfg)
    box = {}

    def run_prefill():
        box.pop("cache", None)             # one cache at a time: 3.2 GB
        with torch.inference_mode():
            cache = transformer.init_cache(cfg, LM_BATCH, LM_MAX_SEQ)
            box["lg"], box["cache"] = prefill(params, toks, cache)

    def run_decode():
        with torch.inference_mode():
            box["lg2"], _ = decode(params, box["cache"],
                                   box["lg"].argmax(-1)[:, None], LM_PROMPT)

    run_prefill()
    run_decode()
    if not (torch.isfinite(box["lg"]).all() and
            torch.isfinite(box["lg2"]).all()):
        fail("moe-main: non-finite logits")
    decode_ms = tm["decode_s"] / tm["decode_steps"] * 1e3
    log(f"[moe-main] generate: {LM_BATCH} x {LM_PROMPT} prompt tokens, "
        f"{LM_NEW} new each: wall {wall:.3f} s; first token (prefill) "
        f"{tm['first_token_s'] * 1e3:.1f} ms; decode {decode_ms:.2f} ms per "
        f"step over {tm['decode_steps']} steps; "
        f"{LM_BATCH * LM_NEW / wall:.1f} generated tokens/s; prefill "
        f"{LM_BATCH * LM_PROMPT / tm['first_token_s']:.0f} tokens/s; peak "
        f"memory {peak / 2**30:.2f} GiB; launches {counts}, attention "
        f"instances {inst}; logits finite; first new tokens "
        f"{[r.tokens[LM_PROMPT:LM_PROMPT + 4] for r in res]}")
    ks, pwall = device_kernels(run_prefill)
    pre = report_profile(f"moonshot prefill ({LM_BATCH} x {LM_PROMPT:,} "
                         f"tokens)", ks, pwall, ("flash_attention",), 1,
                         "prefill")
    ks, dwall = device_kernels(run_decode)
    dec = report_profile("moonshot decode step", ks, dwall,
                         ("flash_attention",), 1, "step")
    p0 = params["layers"][0]["ffn"]
    gen = torch.Generator(device=dev).manual_seed(1)
    layer = {}
    for tag, S in (("prefill", LM_PROMPT), ("decode", 1)):
        x = torch.randn((LM_BATCH, S, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        layer[tag] = moe_layer_ops(cfg, p0, x, f"{tag} shape, {LM_BATCH} x "
                                   f"{S} tokens, layer 0")
    shares = []
    for tag, whole in (("prefill", pre), ("decode step", dec)):
        one = layer[tag.split()[0]]["busy_us"]
        shares.append(f"{tag} " + ("not measured" if one is None or
                                    whole["busy_us"] is None else
                                    f"{100 * cfg.n_layers * one / whole['busy_us']:.1f}%"))
    log(f"[moe-main] the MoE layers' share of the device time ({cfg.n_layers} "
        f"x one layer's): " + ", ".join(shares))
    del params, box
    torch.cuda.empty_cache()
    return counts["flash_attention"]


# --------------------------------------------------------------------------
# recurrent serving (models/ssm.py): [xlstm-parity], [xlstm-main]
# --------------------------------------------------------------------------

def recurrent_parity(tag, cfg, dev, scans):
    """``cfg`` (float32, cut to a few layers) on the card against the CPU:
    the serve steps on PAR_BATCH x PAR_PROMPT random tokens and PAR_NEW
    decode steps (logits within 1e-3), then ServeEngine.generate on both
    (the same greedy tokens); the card's generate must launch the scan
    ``scans`` times a layer and no attention.  Returns (the scan's
    launches in the card's generate, the card's parameters, the prompt
    tokens on the card)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
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
            fail(f"{tag}: {what} logits differ between card and CPU "
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
    if [r.tokens for r in r_gpu] != [r.tokens for r in r_cpu]:
        fail(f"{tag}: generate gave other greedy tokens on the card: "
             f"{[r.tokens[PAR_PROMPT:] for r in r_gpu]} against "
             f"{[r.tokens[PAR_PROMPT:] for r in r_cpu]}")
    if counts["ssm_scan"] != scans * cfg.n_layers or \
            counts["flash_attention"]:
        fail(f"{tag}: launch counts {counts}, expected {scans} scan a layer "
             f"({cfg.n_layers} layers) and no attention")
    log(f"{tag} {cfg.name} {cfg.block_pattern} at full width (d_model "
        f"{cfg.d_model}) cut to {cfg.n_layers} layers, float32, B="
        f"{PAR_BATCH} x {PAR_PROMPT} tokens: card == CPU: prefill and "
        f"{PAR_NEW} decode steps' logits within 1e-3 (max abs err "
        f"{worst:.3g}); generate gave the same greedy tokens "
        f"{[r.tokens[PAR_PROMPT:] for r in r_gpu]}; launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    return counts["ssm_scan"], p_gpu, toks.to(dev)


def law(tag, cfg, params, toks, dev, frames=None,
        max_seq=LM_MAX_SEQ) -> None:
    """tests/test_archs.py's law on the card: prefill(S) then decode at
    S..S+PAR_NEW-1 equals the train forward at those positions (5e-2); an
    encoder-decoder's prefill and train forwards take ``frames``."""
    from repro_torch.models import transformer
    S, n = toks.shape[1], PAR_NEW
    extra = np.random.default_rng(6).integers(1, cfg.vocab,
                                              (toks.shape[0], n))
    full = torch.cat([toks, torch.from_numpy(extra).to(dev)], dim=1)
    worst = 0.0
    with torch.inference_mode():
        cache = transformer.init_cache(cfg, toks.shape[0], max_seq)
        _, cache, _ = transformer.forward(cfg, params, full[:, :S],
                                          mode="prefill", cache=cache,
                                          frames=frames, skip_head=True)
        for t in range(S, S + n):
            dec, cache, _ = transformer.forward(
                cfg, params, full[:, t:t + 1], mode="decode", cache=cache,
                pos=t)
            x, _, _ = transformer.forward(cfg, params, full[:, :t + 1],
                                          frames=frames, skip_head=True)
            train = transformer.head(cfg, params, x[:, -1:])
            err = float((dec - train).abs().max())
            if not torch.allclose(dec, train, atol=5e-2, rtol=5e-2):
                fail(f"{tag}: decode at position {t} differs from the train "
                     f"forward (max abs err {err})")
            worst = max(worst, err)
    log(f"{tag} decode == train on the card at positions {S}..."
        f"{S + n - 1}: max abs err {worst:.3g} (limit 5e-2 + 5e-2 "
        f"rel, tests/test_archs.py)")


def xlstm_parity(dev) -> int:
    """[xlstm-parity]: xlstm-350m and the mamba block kind at full width,
    cut to XLSTM_PAR_LAYERS layers, float32, card against CPU.  Returns
    the scan's launches in the mamba run's generate."""
    from repro_torch import configs
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               n_layers=XLSTM_PAR_LAYERS)
    full = configs.get_config(XLSTM_ARCH)
    chunks = -(-PAR_PROMPT // full.attn_chunk)
    log(f"[xlstm-parity] {full.name} cut to {XLSTM_PAR_LAYERS} of "
        f"{full.n_layers} layers (one of each kind, the one cut); the "
        f"mLSTM's parallel form in {chunks} query chunks of "
        f"{full.attn_chunk}, the last of {PAR_PROMPT % full.attn_chunk}")
    cfg = dataclasses.replace(full, **f32)
    _, params, toks = recurrent_parity("[xlstm-parity]", cfg, dev, 0)
    law("[xlstm-parity]", cfg, params, toks, dev)
    del params
    mamba = dataclasses.replace(configs.get_config(LM_ARCH),
                                block_pattern=("mamba",), **f32)
    return recurrent_parity("[xlstm-parity]", mamba, dev, 1)[0]


def xlstm_main(dev) -> None:
    """[xlstm-main]: xlstm-350m's full configuration (24 layers, bf16)
    with the port's seeded random weights on the card,
    ServeEngine(max_batch=4, max_seq=2048).generate of 4 prompts of 1,536
    tokens, 32 new tokens, greedy ([lm-main]'s traffic); then a [profile]
    of one layer of each kind at the prefill shape and of one decode
    step."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    cfg = configs.get_config(XLSTM_ARCH)
    t0 = time.perf_counter()
    params = transformer.make_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    state = sum(t.numel() * t.element_size() for c in transformer.init_cache(
        cfg, LM_BATCH, LM_MAX_SEQ) for t in c.values())
    log(f"[xlstm-main] {cfg.name}: {cfg.n_layers} layers "
        f"{cfg.block_pattern}, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"of {cfg.head_dim}, vocab {cfg.vocab}: {n_params:,} parameters, "
        f"{n_bytes / 1e9:.3f} GB ({cfg.param_dtype}, the mLSTM's wi/wf and "
        f"the sLSTM's b/R float32; param_count() "
        f"{cfg.param_count() / 1e6:.1f} M), random init on the card in "
        f"{init_s:.1f} s; decode state {state / 1e6:.1f} MB at B="
        f"{LM_BATCH}")
    engine = ServeEngine(cfg, params, max_batch=LM_BATCH, max_seq=LM_MAX_SEQ)
    prompts = np.random.default_rng(7).integers(
        1, cfg.vocab, (LM_BATCH, LM_PROMPT)).tolist()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new=LM_NEW)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        fail(f"xlstm-main: launch counts {counts}: the xLSTM path runs no "
             f"kernel (the reference runs none there)")
    for r, p in zip(res, prompts):
        new = r.tokens[len(p):]
        if r.tokens[:len(p)] != p or len(new) != LM_NEW or \
                not all(0 <= t < cfg.vocab for t in new):
            fail(f"xlstm-main: bad generation {new}")
    tm = engine.timings
    del engine
    toks = torch.tensor(prompts, device=dev)
    prefill, decode = step.make_prefill(cfg), step.make_serve_step(cfg)
    box = {}
    with torch.inference_mode():
        cache = transformer.init_cache(cfg, LM_BATCH, LM_MAX_SEQ)
        box["lg"], box["cache"] = prefill(params, toks, cache)
        box["lg2"], _ = decode(params, box["cache"],
                               box["lg"].argmax(-1)[:, None], LM_PROMPT)
    if not (torch.isfinite(box["lg"]).all() and
            torch.isfinite(box["lg2"]).all()):
        fail("xlstm-main: non-finite logits")
    decode_ms = tm["decode_s"] / tm["decode_steps"] * 1e3
    log(f"[xlstm-main] generate: {LM_BATCH} x {LM_PROMPT} prompt tokens, "
        f"{LM_NEW} new each: wall {wall:.3f} s; first token (prefill) "
        f"{tm['first_token_s'] * 1e3:.1f} ms; decode {decode_ms:.2f} ms per "
        f"step over {tm['decode_steps']} steps; "
        f"{LM_BATCH * LM_NEW / wall:.1f} generated tokens/s; prefill "
        f"{LM_BATCH * LM_PROMPT / tm['first_token_s']:.0f} tokens/s; peak "
        f"memory {peak / 2**30:.2f} GiB; launches {counts}; logits finite; "
        f"first new tokens {[r.tokens[LM_PROMPT:LM_PROMPT + 4] for r in res]}")
    # one layer of each kind at the prefill shape, on random hidden states
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), generator=gen,
                    device=dev).to(transformer.cdtype(cfg))
    layer = {}
    for i in range(cfg.period):
        kind = transformer.layer_kind(cfg, i)
        c0 = transformer.init_cache(cfg, LM_BATCH, LM_MAX_SEQ)[i]

        def run_layer(i=i, kind=kind, c0=c0):
            with torch.inference_mode():
                transformer._apply_block(cfg, kind, params["layers"][i], x,
                                         mode="prefill", cache=c0, pos=0)

        run_layer()                                   # warm
        ks, lwall = device_kernels(run_layer)
        layer[kind] = report_profile(
            f"xlstm {kind} layer prefill ({LM_BATCH} x {LM_PROMPT:,} "
            f"tokens, layer {i})", ks, lwall, (), 1, "layer")

    def run_decode():
        with torch.inference_mode():
            decode(params, box["cache"], box["lg"].argmax(-1)[:, None],
                   LM_PROMPT)

    ks, dwall = device_kernels(run_decode)
    dec = report_profile(f"xlstm decode step ({cfg.n_layers} layers)", ks,
                         dwall, (), 1, "step")
    per = cfg.n_periods
    if all(v["launches"] is not None for v in layer.values()):
        n_pre = per * sum(v["launches"] for v in layer.values())
        busy = per * sum(v["busy_us"] for v in layer.values()) / 1e3
        sl = layer["slstm"]["launches"]
        log(f"[xlstm-main] a prefill's layers, scaled from one layer of "
            f"each kind x {per}: {n_pre:,.0f} launches ({sl:,.0f} a sLSTM "
            f"layer, {sl / LM_PROMPT:.1f} a recurrence step), device busy "
            f"{busy:.2f} ms against a first token of "
            f"{tm['first_token_s'] * 1e3:.1f} ms "
            f"({100 * busy / (tm['first_token_s'] * 1e3):.1f}% busy); "
            f"decode step {dec['launches']} launches")
    else:
        log("[xlstm-main] the profiler recorded no device time: a "
            "prefill's launches and busy share not measured")
    del params, box, x
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the encoder-decoder and the VQ-token front end: [whisper-parity],
# [whisper-main], [vlm-main], and the attention at their shapes
# --------------------------------------------------------------------------

def whisper_parity(dev) -> None:
    """[whisper-parity]: whisper-large-v3 at full width cut to
    WH_PAR_LAYERS encoder and WH_PAR_LAYERS decoder layers, float32, card
    against CPU: B = WH_PAR_BATCH seeded N(0, 1) windows of 1,500 frames
    and prompts of WH_PAR_PROMPT tokens; the encoder's output, then the
    prefill's and each decode step's logits (1e-3) on the CPU's greedy
    tokens, whose argmax must agree; the attention on its CUDA-core
    instance once an encoder layer, twice a decoder layer in the prefill
    and once a decoder layer a step; then the decode-equals-train law on
    the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import transformer
    from repro_torch.train import step
    full = configs.get_config(WH_ARCH)
    cfg = dataclasses.replace(full, n_layers=WH_PAR_LAYERS,
                              enc_layers=WH_PAR_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    log(f"[whisper-parity] {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, enc_seq {cfg.enc_seq}) cut to {WH_PAR_LAYERS} + "
        f"{WH_PAR_LAYERS} of {full.enc_layers} + {full.n_layers} layers "
        f"(the one cut), float32; B={WH_PAR_BATCH}, prompts of "
        f"{WH_PAR_PROMPT} tokens, {WH_PAR_NEW} new, max_seq {WH_MAX_SEQ}")
    t0 = time.perf_counter()
    p_cpu = transformer.make_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu", max_seq=WH_MAX_SEQ)
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    rng = np.random.default_rng(8)
    frames = torch.from_numpy(rng.standard_normal(
        (WH_PAR_BATCH, cfg.enc_seq, cfg.d_model), dtype=np.float32))
    toks = torch.from_numpy(rng.integers(1, cfg.vocab,
                                         (WH_PAR_BATCH, WH_PAR_PROMPT)))
    prefill, decode = step.make_prefill(cfg), step.make_serve_step(cfg)
    worst = {"encoder": 0.0, "logits": 0.0}

    def agree(what, kind, g, c):
        g = g.cpu()
        err = float((g - c).abs().max())
        if g.shape != c.shape or not torch.isfinite(g).all() or \
                not torch.allclose(g, c, rtol=1e-3, atol=1e-3):
            fail(f"whisper-parity: {what} differs between card and CPU "
                 f"(max abs err {err})")
        worst[kind] = max(worst[kind], err)

    greedy = []
    with torch.inference_mode():
        agree("the encoder output", "encoder",
              transformer.encode(cfg, p_gpu, frames.to(dev)),
              transformer.encode(cfg, p_cpu, frames))
        c_cpu = transformer.init_cache(cfg, WH_PAR_BATCH, WH_MAX_SEQ,
                                       device="cpu")
        c_gpu = transformer.init_cache(cfg, WH_PAR_BATCH, WH_MAX_SEQ,
                                       device=dev)
        l_cpu, c_cpu = prefill(p_cpu, toks, c_cpu, frames)
        ops.reset_launch_counts()
        l_gpu, c_gpu = prefill(p_gpu, toks.to(dev), c_gpu, frames.to(dev))
        agree("the prefill's logits", "logits", l_gpu, l_cpu)
        for i in range(WH_PAR_NEW):
            tok = l_cpu.argmax(-1)
            if not torch.equal(l_gpu.argmax(-1).cpu(), tok):
                fail(f"whisper-parity: greedy token {i} differs: card "
                     f"{l_gpu.argmax(-1).tolist()}, CPU {tok.tolist()}")
            greedy.append(tok.tolist())
            if i == WH_PAR_NEW - 1:
                break
            l_cpu, c_cpu = decode(p_cpu, c_cpu, tok[:, None],
                                  WH_PAR_PROMPT + i)
            l_gpu, c_gpu = decode(p_gpu, c_gpu, tok[:, None].to(dev),
                                  WH_PAR_PROMPT + i)
            agree(f"decode step {i}'s logits", "logits", l_gpu, l_cpu)
    counts = ops.launch_counts()
    inst = dict(flash_attention.INSTANCE_LAUNCHES)
    want = cfg.enc_layers + 2 * cfg.n_layers + \
        (WH_PAR_NEW - 1) * cfg.n_layers
    if inst != {flash_attention.TENSOR_CORE: 0,
                flash_attention.CUDA_CORE: want} or counts["ssm_scan"]:
        fail(f"whisper-parity: launch counts {counts}, attention instances "
             f"{inst}; expected {want} CUDA-core attention launches "
             f"(encoder layers + 2 x decoder layers in the prefill, decoder "
             f"layers a decode step) and no scan")
    log(f"[whisper-parity] card == CPU: encoder output within 1e-3 (max abs "
        f"err {worst['encoder']:.3g}); the prefill's and "
        f"{WH_PAR_NEW - 1} decode steps' logits within 1e-3 (max abs err "
        f"{worst['logits']:.3g}); the same greedy tokens "
        f"{[list(t) for t in zip(*greedy)]}; attention launches {want}, "
        f"instances {inst}; {time.perf_counter() - t0:.1f} s")
    law("[whisper-parity]", cfg, p_gpu, toks.to(dev), dev,
        frames=frames.to(dev), max_seq=WH_MAX_SEQ)
    del p_gpu, c_gpu
    torch.cuda.empty_cache()


def whisper_main(dev) -> dict:
    """[whisper-main]: whisper-large-v3's full configuration (32 encoder +
    32 decoder layers, bf16) with the port's seeded random weights on the
    card, serving WH_BATCH requests, each a 30 s window of 1,500 seeded
    frames and a WH_PROMPT-token prompt, WH_NEW new tokens, greedy, max_seq
    WH_MAX_SEQ, through make_prefill and make_serve_step in a loop that
    mirrors ServeEngine.generate (one host read a token, host clock); then
    a [profile] of one prefill and one decode step.  Returns the
    attention's launches by FLASH_SERVING name."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import transformer
    from repro_torch.train import step
    cfg = configs.get_config(WH_ARCH)
    t0 = time.perf_counter()
    params = transformer.make_params(
        cfg, torch.Generator(device=dev).manual_seed(0), max_seq=WH_MAX_SEQ)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[whisper-main] {cfg.name}: {cfg.enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_params:,} parameters at max_seq {WH_MAX_SEQ}, "
        f"{n_bytes / 1e9:.3f} GB ({cfg.param_dtype}, norms float32), random "
        f"init on the card in {init_s:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(9)
    frames = torch.randn((WH_BATCH, cfg.enc_seq, cfg.d_model), generator=gen,
                         device=dev)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        1, cfg.vocab, (WH_BATCH, WH_PROMPT))).to(dev)
    prefill, decode = step.make_prefill(cfg), step.make_serve_step(cfg)
    with torch.inference_mode():
        transformer.encode(cfg, params, frames)             # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transformer.encode(cfg, params, frames)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        cache = transformer.init_cache(cfg, WH_BATCH, WH_MAX_SEQ)
        lg, cache = prefill(params, toks, cache, frames)
        last = lg.argmax(-1)
        out.append(last.tolist())                 # the one host read
        t1 = time.perf_counter()
        first = lg
        for pos in range(WH_PROMPT, WH_PROMPT + WH_NEW - 1):
            lg, cache = decode(params, cache, last[:, None], pos)
            last = lg.argmax(-1)
            out.append(last.tolist())
        t2 = time.perf_counter()
    counts = ops.launch_counts()
    inst = dict(flash_attention.INSTANCE_LAUNCHES)
    got = dict(flash_attention.SHAPE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():            # a second, warm first token
        t3 = time.perf_counter()
        c = transformer.init_cache(cfg, WH_BATCH, WH_MAX_SEQ)
        prefill(params, toks, c, frames)[0].argmax(-1).tolist()
        warm_ms = (time.perf_counter() - t3) * 1e3
        del c
    keys = {name: case[:8] for name, case in FLASH_SERVING.items()
            if name.startswith("whisper")}
    want = {keys["whisper encoder"]: cfg.enc_layers,
            keys["whisper decoder prefill"]: cfg.n_layers,
            keys["whisper cross prefill"]: cfg.n_layers,
            keys["whisper cross decode"]: cfg.n_layers * (WH_NEW - 1)}
    if got != want or counts["ssm_scan"] or \
            inst[flash_attention.CUDA_CORE]:
        fail(f"whisper-main: attention launches by shape {got}, expected "
             f"{want}; instances {inst}; launch counts {counts}")
    new = [list(t) for t in zip(*out)]
    if len(new) != WH_BATCH or any(
            len(t) != WH_NEW or not all(0 <= x < cfg.vocab for x in t)
            for t in new):
        fail(f"whisper-main: bad generation {new}")
    if not (torch.isfinite(first).all() and torch.isfinite(lg).all()):
        fail("whisper-main: non-finite logits")
    wall = t2 - t0
    steps = WH_NEW - 1
    log(f"[whisper-main] {WH_BATCH} requests x ({cfg.enc_seq:,} frames + "
        f"{WH_PROMPT} prompt tokens), {WH_NEW} new each, greedy: encoder "
        f"{enc_ms:.1f} ms (warm, alone); first token {(t1 - t0) * 1e3:.1f} "
        f"ms cold (the first prefill at these shapes: cache, encoder, cross "
        f"keys and values, decoder prefill, sample), {warm_ms:.1f} ms warm "
        f"(a second prefill, after the run); decode {(t2 - t1) / steps * 1e3:.2f} ms per step over "
        f"{steps} steps; {WH_BATCH * WH_NEW / wall:.1f} generated tokens/s; "
        f"wall {wall:.3f} s; peak memory {peak / 2**30:.2f} GiB; all "
        f"{WH_BATCH * WH_NEW} tokens produced, logits finite; attention "
        f"launches by shape "
        + ", ".join(f"{n} {got[k]}" for n, k in keys.items())
        + f", instances {inst}; first new tokens {[t[:4] for t in new]}")
    box = {}

    def run_prefill():
        box.pop("cache", None)
        with torch.inference_mode():
            c = transformer.init_cache(cfg, WH_BATCH, WH_MAX_SEQ)
            box["lg"], box["cache"] = prefill(params, toks, c, frames)

    def run_decode():
        with torch.inference_mode():
            decode(params, box["cache"], box["lg"].argmax(-1)[:, None],
                   WH_PROMPT)

    run_prefill()
    ks, pwall = device_kernels(run_prefill)
    report_profile(f"whisper prefill ({WH_BATCH} x 1,500 frames + "
                   f"{WH_PROMPT} tokens, the encoder included)", ks, pwall,
                   ("flash_attention",), 1, "prefill")
    ks, dwall = device_kernels(run_decode)
    report_profile("whisper decode step", ks, dwall, ("flash_attention",),
                   1, "step")
    del params, box, cache, frames, lg, first
    torch.cuda.empty_cache()
    return {n: got[k] for n, k in keys.items()}


def vlm_main(dev) -> int:
    """[vlm-main]: chameleon-34b (the VQ-token front end: image tokens are
    ids of the shared vocab) at full width and VLM_LAYERS of its 48
    layers, bf16, seeded random weights on the card,
    ServeEngine(max_batch=4, max_seq=2048).generate of 4 prompts of 1,536
    random ids, 32 new tokens, greedy ([lm-main]'s traffic).  Returns the
    attention's launches."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    full = configs.get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = transformer.make_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"[vlm-main] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, QK-norm, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"frontend {cfg.frontend}: {n_params:,} parameters, "
        f"{n_bytes / 2**30:.2f} GiB ({cfg.param_dtype}), random init on the "
        f"card in {init_s:.1f} s")
    engine = ServeEngine(cfg, params, max_batch=LM_BATCH, max_seq=LM_MAX_SEQ)
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).tolist()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new=LM_NEW)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    inst = dict(flash_attention.INSTANCE_LAUNCHES)
    got = dict(flash_attention.SHAPE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {FLASH_SERVING["chameleon prefill"][:8]: cfg.n_layers}
    if got != want or counts["ssm_scan"] or \
            inst[flash_attention.CUDA_CORE]:
        fail(f"vlm-main: attention launches by shape {got}, expected "
             f"{want}; instances {inst}; launch counts {counts}")
    for r, p in zip(res, prompts):
        new = r.tokens[len(p):]
        if r.tokens[:len(p)] != p or len(new) != LM_NEW or \
                not all(0 <= t < cfg.vocab for t in new):
            fail(f"vlm-main: bad generation {new}")
    tm = engine.timings
    del engine
    with torch.inference_mode():           # logits finite (not counted)
        cache = transformer.init_cache(cfg, LM_BATCH, LM_MAX_SEQ)
        lg, cache = step.make_prefill(cfg)(
            params, torch.tensor(prompts, device=dev), cache)
        if not torch.isfinite(lg).all():
            fail("vlm-main: non-finite logits")
    log(f"[vlm-main] generate: {LM_BATCH} x {LM_PROMPT} prompt tokens, "
        f"{LM_NEW} new each: wall {wall:.3f} s; first token (prefill) "
        f"{tm['first_token_s'] * 1e3:.1f} ms; decode "
        f"{tm['decode_s'] / tm['decode_steps'] * 1e3:.2f} ms per step over "
        f"{tm['decode_steps']} steps; {LM_BATCH * LM_NEW / wall:.1f} "
        f"generated tokens/s; prefill "
        f"{LM_BATCH * LM_PROMPT / tm['first_token_s']:.0f} tokens/s; peak "
        f"memory {peak / 2**30:.2f} GiB; launches {counts}, attention "
        f"instances {inst}; logits finite; first new tokens "
        f"{[r.tokens[LM_PROMPT:LM_PROMPT + 4] for r in res]}")
    del params, cache, lg
    torch.cuda.empty_cache()
    return counts["flash_attention"]


def serving_flash_entries(errs, launches, dev) -> list:
    """The attention at each FLASH_SERVING shape beside its bound, its plain
    version and SDPA at the same mask (is_causal, enable_gqa); its
    launches in the main run that gives it that shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    sfu = exp_per_s()
    entries = []
    for name, case in FLASH_SERVING.items():
        (q, k, v), kw = flash_args(case, dev)
        B, H, KV, Sq, Skv, hd, causal, W, _, _ = case

        def call(q=q, k=k, v=v, kw=kw):
            return flash_attention.flash_attention(q, k, v, **kw)

        ms = time_ms(call, reps=50, warmup=5)
        plain = time_ms(lambda: ref.mha_reference(q, k, v, **kw), reps=5,
                        warmup=1)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), reps=50, warmup=5)
        out = call()
        inst = flash_attention.LAST_INSTANCE
        pairs = attn_pairs(Sq, Skv, causal, W) * B * H
        bound, by, op = bound_ms(
            nbytes(q, k, v, out), {"bf16 tensor-core flops":
                                   (4 * hd * pairs, PEAK_BF16_FLOP_S),
                                   "exponentials": (pairs, sfu)})
        dev_us = kernel_device_us(call, ["flash_attention_bf16_kernel"],
                                  reps=20)
        entries.append({
            "name": f"flash_attention ({name})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:83",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "bound_op": op, "library_ms": lib, "instance": inst,
            "device_ms": None if dev_us is None else dev_us / 1e3,
            "shape": list(case[:8])})
        log(f"[time] flash_attention ({inst}) at {name} B,H,KV,Sq,Skv,hd="
            f"{(B, H, KV, Sq, Skv, hd)} {'causal' if causal else 'no mask'}: "
            f"{ms * 1e3:.1f} us per call on the stream, "
            f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'} of "
            f"device time (profiler); bound {bound * 1e3:.3f} us by {op} "
            f"({4 * hd * pairs / 1e9:.2f} GFLOP, {pairs / 1e6:.1f} M "
            f"exponentials, {nbytes(q, k, v, out) / 1e6:.1f} MB); plain "
            f"version {plain * 1e3:.1f} us; SDPA (is_causal={causal}, "
            f"enable_gqa) {lib * 1e3:.1f} us, the kernel {ms / lib:.2f}x its "
            f"time; {launches[name]} launches in its main run")
        del q, k, v, out
    return entries


# --------------------------------------------------------------------------
# [roofline]: [skip-attn] and [dryrun-main]
# --------------------------------------------------------------------------

# the dry run of [train-main]'s work (hymba-1.5b, remat "dots", 4 x 4,096
# tokens) on a one-rank mesh, through the dry run's own cell function, in
# a process of its own: its fake process group stays out of this one
DRYRUN_MAIN = r"""
import json, sys
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.config import ShapeSpec
dryrun.init_fake(1)
cell = dryrun.lower_cell(sys.argv[1], ShapeSpec(
    "train_main", "train", int(sys.argv[3]), int(sys.argv[2])),
    make_local_mesh(1, 1, device="cuda"))
print(json.dumps(cell))
"""
# the predicted peak over [train-main]'s measured one must lie in this band
DRYRUN_PEAK_BAND = (0.80, 1.02)


def start_dryrun_main():
    """Start [dryrun-main]'s subprocess (with the script: it traces on the
    host while the card runs the phases before [roofline]); killed at exit
    if it is still running."""
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_MAIN, LM_ARCH, str(TR_BATCH),
         str(TR_SEQ)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_dryrun_main(proc) -> dict:
    """The dry run's cell for [train-main]'s work; fails on an error."""
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"dryrun-main: the dry run exited {proc.returncode}: "
             f"{err[-3000:]}")
    cell = json.loads(lines[-1])
    if "error" in cell:
        fail(f"dryrun-main: the cell recorded an error: {cell['error']}")
    log(f"[dryrun-main] {cell['arch']} at [train-main]'s work ({TR_BATCH} x "
        f"{TR_SEQ} tokens, its config's remat) on a one-rank mesh, traced on fake {cell['fake_device']} tensors in "
        f"{cell['t_compile'] + cell['t_probes']:.1f} s of host time: "
        f"t_compute {cell['t_compute'] * 1e3:.1f} ms, t_memory "
        f"{cell['t_memory'] * 1e3:.1f} ms, step_time_est "
        f"{cell['step_time_est'] * 1e3:.1f} ms ({cell['dominant']}), "
        f"model_flops {cell['model_flops']:.4e}, operations "
        f"{cell['flops']:.4e}, bytes {cell['bytes_accessed']:.4e}, "
        f"roofline fraction {cell['roofline_fraction']:.4f}, predicted peak "
        f"{cell['bytes_per_device'] / 2**30:.2f} GiB (state "
        f"{cell['memory']['state_bytes'] / 2**30:.2f} GiB)")
    return cell


def check_dryrun_main(cell: dict, tr: dict) -> None:
    """[dryrun-main]'s predicted peak against [train-main]'s measured one
    (the band fails the script), and the measured step over the
    estimate (printed)."""
    pred, peak = cell["bytes_per_device"], tr["peak"]
    lo, hi = DRYRUN_PEAK_BAND
    ratio = pred / peak
    log(f"[dryrun-main] predicted peak {pred / 2**30:.2f} GiB over "
        f"[train-main]'s torch.cuda.max_memory_allocated "
        f"{peak / 2**30:.2f} GiB: {ratio:.4f} (band {lo}-{hi}); live "
        f"storages of a real [train-main] step counted the same way "
        f"(LiveBytes on the card) {tr['live_peak'] / 2**30:.2f} GiB, that "
        f"step's allocator peak {tr['live_alloc_peak'] / 2**30:.2f} GiB; "
        f"measured step {tr['step_s']:.3f} s over step_time_est "
        f"{cell['step_time_est']:.4f} s: {tr['step_s'] / cell['step_time_est']:.2f}x "
        f"(t_compute {cell['t_compute']:.4f} s: "
        f"{tr['step_s'] / cell['t_compute']:.2f}x)")
    if not lo <= ratio <= hi:
        fail(f"dryrun-main: predicted peak {pred} B is {ratio:.4f} of the "
             f"measured {peak} B, outside {lo}-{hi}")


def skip_attn(dev, cfg, params, toks, fa_ms) -> dict:
    """[skip-attn]: hymba-1.5b's warm prefill of [lm-main]'s prompts with
    and without ``skip_attention``, three of each in turns, CUDA events
    around each call; the launches of each; then the ablated prefill of
    [lm-parity]'s 2-layer float32 cut, card against CPU."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.train import step
    variants = {"attention": cfg,
                "skip_attention": dataclasses.replace(cfg,
                                                      skip_attention=True)}
    calls, launches = {}, {}
    with torch.inference_mode():
        for name, c in variants.items():
            cache = transformer.init_cache(c, LM_BATCH, LM_MAX_SEQ)
            calls[name] = functools.partial(step.make_prefill(c), params,
                                            toks, cache)
            calls[name]()                                   # warm
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            lg, _ = calls[name]()
            torch.cuda.synchronize()
            launches[name] = ops.launch_counts()
            if not torch.isfinite(lg).all():
                fail(f"skip-attn: non-finite logits ({name})")
        ms = {name: [] for name in calls}
        for _ in range(3):
            for name, fn in calls.items():
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                torch.cuda.synchronize()
                ms[name].append(s.elapsed_time(e))
    L = cfg.n_layers
    want = {"attention": (L, L), "skip_attention": (0, L)}
    for name, (fa, ss) in want.items():
        if (launches[name]["flash_attention"], launches[name]["ssm_scan"]) \
                != (fa, ss):
            fail(f"skip-attn: {name} prefill launched {launches[name]}, "
                 f"expected flash_attention {fa} and ssm_scan {ss}")
    full, abl = (statistics.median(ms[n]) for n in calls)
    fa_total = L * fa_ms
    log(f"[skip-attn] {cfg.name}, {L} layers, bf16, {LM_BATCH} x "
        f"{LM_PROMPT} tokens, warm prefill (CUDA events, 3 in turns): "
        f"{full:.2f} ms with attention {[round(x, 2) for x in ms['attention']]}, "
        f"{abl:.2f} ms with skip_attention "
        f"{[round(x, 2) for x in ms['skip_attention']]}; the attention's "
        f"share by difference {full - abl:.2f} ms "
        f"({100 * (full - abl) / full:.1f}%); launches flash_attention "
        f"{launches['attention']['flash_attention']} against "
        f"{launches['skip_attention']['flash_attention']}, ssm_scan "
        f"{launches['attention']['ssm_scan']} against "
        f"{launches['skip_attention']['ssm_scan']}; flash_attention alone "
        f"{L} x {fa_ms:.4f} ms = {fa_total:.2f} ms ([time] above), so "
        f"{full - abl - fa_total:.2f} ms of the difference is what else the "
        f"ablation drops: the RoPE of q and k, the (B, H, S, hd) views' "
        f"copies and the prefill's cache writes (the last window of k, v "
        f"and positions, rolled and cast)")

    # card against CPU, the ablated 2-layer float32 cut
    cut = dataclasses.replace(cfg, n_layers=PAR_LAYERS, skip_attention=True,
                              param_dtype="float32", compute_dtype="float32")
    p_cpu = transformer.make_params(cut, torch.Generator().manual_seed(0),
                                    device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    t = torch.from_numpy(np.random.default_rng(5).integers(
        1, cut.vocab, (PAR_BATCH, PAR_PROMPT)))
    prefill = step.make_prefill(cut)
    with torch.inference_mode():
        ops.reset_launch_counts()
        g, _ = prefill(p_gpu, t.to(dev), transformer.init_cache(
            cut, PAR_BATCH, LM_MAX_SEQ, device=dev))
        counts = ops.launch_counts()
        c, _ = prefill(p_cpu, t, transformer.init_cache(
            cut, PAR_BATCH, LM_MAX_SEQ, device="cpu"))
    g = g.cpu()
    err = float((g - c).abs().max())
    if not torch.isfinite(g).all() or \
            not torch.allclose(g, c, rtol=1e-3, atol=1e-3):
        fail(f"skip-attn: the ablated prefill's logits differ between card "
             f"and CPU (max abs err {err})")
    if (counts["flash_attention"], counts["ssm_scan"]) != (0, PAR_LAYERS):
        fail(f"skip-attn: the ablated cut launched {counts}")
    log(f"[skip-attn] card == CPU: the ablated prefill of {cut.name} cut to "
        f"{PAR_LAYERS} layers, float32, {PAR_BATCH} x {PAR_PROMPT} tokens, "
        f"logits within 1e-3 (max abs err {err:.3g}); launches {counts}")
    return launches


# --------------------------------------------------------------------------
# training (train/step.py): the backward kernels, [train-parity],
# [train-main]
# --------------------------------------------------------------------------

# the attention's backward: hymba-1.5b's training shape (train_4k's
# sequence, the batch one card holds), moonshot's hd 128, gemma2's hd 256
# with its window and softcap 50, whisper's encoder and cross-attention,
# ragged lengths and the float32 instance
FLASH_BWD_MAIN = (TR_BATCH, 25, 5, TR_SEQ, TR_SEQ, 64, True, 1024, 0.0,
                  "bfloat16")
# moonshot's hd 128, causal: also timed beside SDPA's flash backward
FLASH_BWD_HD128 = (LM_BATCH, 16, 16, LM_PROMPT, LM_PROMPT, 128, True, 0, 0.0,
                   "bfloat16")
FLASH_BWD_CASES = [
    FLASH_BWD_HD128,
    (2, 16, 8, LM_PROMPT, LM_PROMPT, 256, True, 4096, 50.0, "bfloat16"),
    (WH_BATCH, 20, 20, 1500, 1500, 64, False, 0, 0.0, "bfloat16"),
    (WH_BATCH, 20, 20, WH_PROMPT, 1500, 64, False, 0, 0.0, "bfloat16"),
    (2, 4, 2, 37, 300, 64, True, 0, 0.0, "bfloat16"),
    (2, 4, 2, 300, 37, 64, False, 0, 0.0, "bfloat16"),
    (2, 8, 4, 777, 777, 128, True, 256, 0.0, "float32"),
]
SSM_BWD_MAIN = (TR_BATCH, TR_SEQ, 3200, 16)
SSM_BWD_CASES = [(3, 37, 200, 16)]


def bwd_inputs(case, dev, seed=51):
    """q/k/v as flash_args makes them, the forward's output and a seeded
    output gradient laid out like the model's, (B, S, H, hd) seen as (B,
    H, S, hd)."""
    from repro_torch.kernels import flash_attention
    (q, k, v), kw = flash_args(case, dev, seed)
    B, H, _, Sq, _, hd = case[:6]
    out = flash_attention.flash_attention(q, k, v, **kw)
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, Sq, H, hd), dtype=np.float32)).to(dev, q.dtype).transpose(1, 2)
    return (q, k, v, out, dout), kw


def check_flash_bwd(case, dev):
    """dq, dk, dv against the plain version: 2e-2 of each output's largest
    magnitude in bf16, 1e-4 in f32 (float32 sums in another order; bf16
    outputs rounded once); a second call bit-equal to the first."""
    from repro_torch.kernels import flash_attention, ref
    args, kw = bwd_inputs(case, dev)
    got = flash_attention.flash_attention_backward(*args, **kw)
    inst = flash_attention.LAST_BWD_INSTANCE
    again = flash_attention.flash_attention_backward(*args, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"flash_attention_backward {case} ({inst}): two calls on the "
             f"same inputs differ")
    del again
    q, k, v, out, dout = args
    exp = ref.mha_backward_reference(q, k, v, out, None, dout, **kw)
    torch.cuda.synchronize()
    tol = 2e-2 if case[-1] == "bfloat16" else 1e-4
    errs, abs_err = [], 0.0
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        if g.shape != e.shape or g.dtype != e.dtype:
            fail(f"flash_attention_backward {case}: {name} {g.dtype}"
                 f"{tuple(g.shape)}, plain {e.dtype}{tuple(e.shape)}")
        top = float(e.float().abs().max())
        err = float((g.float() - e.float()).abs().max())
        if not torch.isfinite(g.float()).all() or err > tol * top:
            fail(f"flash_attention_backward {case}: {name} max abs err "
                 f"{err} beyond {tol} of its largest magnitude {top}")
        errs.append(err / top)
        abs_err = max(abs_err, err)
    del exp, args, got
    log(f"[kernels] flash_attention_backward ({inst}) B,H,KV,Sq,Skv,hd="
        f"{case[:6]} causal={case[6]} window={case[7]} softcap={case[8]} "
        f"{case[9]}: dq, dk, dv within {tol} of their largest magnitudes "
        f"(relative errors {', '.join(f'{x:.3g}' for x in errs)}); a second "
        f"call bit-equal")
    return abs_err


def ssm_bwd_inputs(B, S, Dss, N, dev, seed=53, with_dh=False):
    """(dt, Bm, Cm, x, A) as check_ssm makes them, a seeded dy and, with
    ``with_dh``, a seeded final-state gradient (else None)."""
    from torch_kernel_inputs import ssm_inputs, torch_args
    args = torch_args(ssm_inputs(B, S, Dss, N, seed), dev)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((B, S, Dss),
                                              dtype=np.float32)).to(dev)
    dh = torch.from_numpy(rng.standard_normal(
        (B, Dss, N), dtype=np.float32)).to(dev) if with_dh else None
    return (*args, dy, dh)


def check_ssm_bwd(B, S, Dss, N, dev, with_dh=False):
    """ddt, dB, dC, dx, dA against the plain version within 1e-4 of each
    output's largest magnitude (sums over the state, the channels and time
    in the kernel's fixed order); a second call bit-equal to the first."""
    from repro_torch.kernels import ref, ssm_scan
    args = ssm_bwd_inputs(B, S, Dss, N, dev, with_dh=with_dh)
    got = ssm_scan.ssm_scan_backward(*args)
    inst = ssm_scan.LAST_BWD_INSTANCE
    again = ssm_scan.ssm_scan_backward(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"ssm_scan_backward {(B, S, Dss, N)} ({inst}): two calls on "
             f"the same inputs differ")
    del again
    exp = ref.ssm_scan_backward_reference(*args)
    torch.cuda.synchronize()
    errs, abs_err = [], 0.0
    for name, g, e in zip(("ddt", "dB", "dC", "dx", "dA"), got, exp):
        top = float(e.abs().max())
        err = float((g - e).abs().max())
        abs_err = max(abs_err, err)
        if g.shape != e.shape or not torch.isfinite(g).all() or \
                err > 1e-4 * top:
            fail(f"ssm_scan_backward {(B, S, Dss, N)}: {name} max abs err "
                 f"{err} beyond 1e-4 of its largest magnitude {top}")
        errs.append(err / top)
    del exp, got, args
    log(f"[kernels] ssm_scan_backward ({inst}) B,S,Dss,N={(B, S, Dss, N)} "
        f"dh={'yes' if with_dh else 'no'}: within 1e-4 of each output's "
        f"largest magnitude (relative errors "
        f"{', '.join(f'{x:.3g}' for x in errs)}); a second call bit-equal")
    return abs_err


def train_batch(cfg, B, S, seed, dev):
    """numpy tokens from a fixed seed; labels the next token, the last
    position masked (-1)."""
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)))
    labels = torch.cat([toks[:, 1:], torch.full((B, 1), -1)], dim=1)
    return {"tokens": toks.to(dev), "labels": labels.to(dev)}


def train_parity_setup():
    """[train-parity]'s configuration, optimizer, initial parameters (on
    the CPU, from a seeded CPU generator) and CPU batch."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train import optim
    full = configs.get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=PAR_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    p_cpu = transformer.make_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    return (full, cfg, optim.AdamWConfig(warmup_steps=0), p_cpu,
            train_batch(cfg, PAR_BATCH, PAR_PROMPT, 9, "cpu"))


def train_snap(st):
    """Float32 copies of a train state's parameters and moments, on its
    device."""
    return {k: {n: t.detach().float().clone() for n, t in tree}
            for k, tree in (("p", st["params"].named_parameters()),
                            ("m", st["opt"]["m"].items()),
                            ("v", st["opt"]["v"].items()))}


def train_cpu_steps() -> dict:
    """[train-parity]'s two CPU steps from one state: the state before and
    after each step, and the metrics."""
    from repro_torch.train import step
    _, cfg, opt, p_cpu, batch = train_parity_setup()
    state = step.train_state(p_cpu)
    ts = step.make_train_step(cfg, opt_cfg=opt)
    snaps, metrics = [train_snap(state)], []
    for _ in range(2):
        state, m = ts(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append(train_snap(state))
    return {"snaps": snaps, "metrics": metrics}


def train_parity(dev) -> None:
    """hymba-1.5b at full width cut to PAR_LAYERS layers, float32, on
    B=PAR_BATCH x PAR_PROMPT tokens (past the 1,024 window), train steps on
    the card against the CPU, each from one state: the first from the same
    parameters, the second from the CPU's state after the first, copied to
    the card (so each step is held to the step's own error, not to the
    first step's carried over into the second's gradient).  The CPU's two
    steps run ahead in the CPU sides' worker (``train_cpu_steps``).  At
    each step: loss, nll, aux, grad_norm within 1e-5 relative and lr
    within 1e-6; the gradients (read off the moments: m = b1 m0 + (1 -
    b1) g scale) within 1e-4 of each leaf's largest magnitude; m and v within 1e-5 relative
    plus 1e-4 of their largest magnitude; the parameters within
    tests/torch_kernel_inputs.py adamw_param_check's bound."""
    from repro_torch.kernels import ops
    from repro_torch.train import step
    from torch_kernel_inputs import adamw_param_check
    full, cfg, opt, p_cpu, _ = train_parity_setup()
    log(f"[train-parity] {cfg.name} at full width cut to {PAR_LAYERS} of "
        f"{full.n_layers} layers, float32, remat {cfg.remat!r}; B="
        f"{PAR_BATCH} x {PAR_PROMPT} tokens, 2 train steps, card vs CPU")
    t0 = time.perf_counter()
    card = step.train_state(p_cpu.to(dev))
    batch = train_batch(cfg, PAR_BATCH, PAR_PROMPT, 9, dev)
    ts = step.make_train_step(cfg, opt_cfg=opt)
    t_wait = time.perf_counter()
    cpu, cpu_secs = take_cpu_side(TRAIN_PARITY, train_cpu_steps)
    waited = time.perf_counter() - t_wait
    b1, eps = opt.b1, opt.eps
    worst, g_err, loose, total = {}, 0.0, 0, 0
    counts = dict.fromkeys(ops.FORWARD + ops.BACKWARD, 0)
    for i in range(2):
        ops.reset_launch_counts()
        card, m = ts(card, batch)
        for k, n in ops.launch_counts(ops.FORWARD + ops.BACKWARD).items():
            counts[k] += n
        mg, mc = {k: float(v) for k, v in m.items()}, cpu["metrics"][i]
        metrics = {"card": mg, "cpu": mc}
        g = train_snap(card)
        # the CPU's states, compared on the card
        c, before = ({k: {n: t.to(dev) for n, t in tree.items()}
                      for k, tree in snap.items()}
                     for snap in (cpu["snaps"][i + 1], cpu["snaps"][i]))
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            rel = abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30)
            worst[k] = max(worst.get(k, 0.0), rel)
            if not math.isfinite(mg[k]) or \
                    rel > (1e-6 if k == "lr" else 1e-5) and \
                    abs(mg[k] - mc[k]) > 1e-7:
                fail(f"train-parity: step {i} {k} card {mg[k]} CPU {mc[k]}")
        t = np.float32(i + 1)
        c1, c2 = (float(1 - np.float32(b) ** t) for b in (opt.b1, opt.b2))
        scale = {s: min(1.0, opt.grad_clip / (metrics[s]["grad_norm"]
                                              + 1e-9)) for s in metrics}
        for n in c["p"]:
            gg = (g["m"][n] - b1 * before["m"][n]) / ((1 - b1)
                                                      * scale["card"])
            gc = (c["m"][n] - b1 * before["m"][n]) / ((1 - b1)
                                                      * scale["cpu"])
            top = float(gc.abs().max())
            err = float((gg - gc).abs().max())
            g_err = max(g_err, err / max(top, 1e-30))
            if err > 1e-4 * top + 1e-12:
                fail(f"train-parity: step {i} gradient of {n} differs by "
                     f"{err} (largest {top})")
            for k in ("m", "v"):
                d = (g[k][n] - c[k][n]).abs()
                if (d > 1e-5 * c[k][n].abs()
                        + 1e-4 * float(c[k][n].abs().max())).any():
                    fail(f"train-parity: step {i} {k} of {n} differs by "
                         f"{float(d.max())}, "
                         f"{float(d.max()) / float(c[k][n].abs().max()):.3g}"
                         f" of its largest magnitude")
            diff, bad, nl = adamw_param_check(
                g["p"][n], c["p"][n], before["p"][n], g["m"][n], c["m"][n],
                g["v"][n], c["v"][n], mc["lr"], c1, c2, eps,
                torch.zeros_like(c["p"][n]))
            if bad:
                fail(f"train-parity: step {i} parameter {n}: {bad} elements "
                     f"beyond the bound (max diff {float(diff.max())})")
            loose += nl
            total += diff.numel()
        # the second step starts on the card from the CPU's state
        with torch.no_grad():
            for n, pg in card["params"].named_parameters():
                pg.copy_(c["p"][n])
            for k in ("m", "v"):
                for n, tg in card["opt"][k].items():
                    tg.copy_(c[k][n])
    want = {"flash_attention": 4 * PAR_LAYERS, "ssm_scan": 4 * PAR_LAYERS,
            "flash_attention_backward": 2 * PAR_LAYERS,
            "ssm_scan_backward": 2 * PAR_LAYERS}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"train-parity: launches {counts} in two card steps, expected "
             f"{want} (forward and its recompute under remat 'dots', one "
             f"backward a layer a step)")
    log(f"[train-parity] card == CPU, each step from one state: losses "
        f"{[mg['loss']]} at step 2 (CPU {[mc['loss']]}); largest relative "
        f"differences {', '.join(f'{k} {v:.3g}' for k, v in worst.items())}; "
        f"gradients within {g_err:.3g} of each leaf's largest magnitude; "
        f"moments within bound; parameters within bound ({loose} of "
        f"{total} elements beyond 1e-5 and within the moments' part); "
        f"launches {counts}; the CPU's steps took {cpu_secs:.1f} s in "
        f"the worker, {waited:.1f} s of it waited for here; "
        f"{time.perf_counter() - t0:.1f} s")


def train_main(dev) -> dict:
    """The training main run through the user's entry points:
    hymba-1.5b's full config (bf16, remat "dots") with seeded random
    weights on the card, init_state + make_train_step, TR_STEPS steps of
    AdamWConfig(warmup_steps=0) on one batch of TR_BATCH x TR_SEQ tokens.
    Every loss, grad_norm and lr finite, the last loss below the first;
    each step launches the forward kernels twice a layer (the forward and
    its recompute under "dots") and each backward kernel once a layer."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.train import optim, step
    cfg = configs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    state = step.init_state(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    log(f"[train-main] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters "
        f"({cfg.param_dtype}), float32 moments, remat {cfg.remat!r}; "
        f"{TR_BATCH} x {TR_SEQ} tokens a step, {TR_STEPS} steps on one "
        f"batch; init on the card {time.perf_counter() - t0:.1f} s")
    batch = train_batch(cfg, TR_BATCH, TR_SEQ, 11, dev)
    ts = step.make_train_step(cfg, opt_cfg=optim.AdamWConfig(warmup_steps=0))
    torch.cuda.reset_peak_memory_stats()
    walls, losses, per_step, bwd_inst = [], [], [], []
    for i in range(TR_STEPS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = ts(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        per_step.append(ops.launch_counts(ops.FORWARD + ops.BACKWARD))
        bwd_inst.append(dict(flash_attention.BWD_INSTANCE_LAUNCHES))
        vals = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(vals[k]) for k in ("loss", "grad_norm",
                                                    "lr")):
            fail(f"train-main: step {i} metrics {vals}")
        losses.append(vals["loss"])
        log(f"[train-main] step {i + 1}: {walls[-1]:.3f} s, loss "
            f"{vals['loss']:.4f}, nll {vals['nll']:.4f}, grad_norm "
            f"{vals['grad_norm']:.4f}, lr {vals['lr']:.3g}")
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    want = {"dcsim_advance": 0, "telemetry_accum": 0,
            "flash_attention": 2 * L, "ssm_scan": 2 * L,
            "flash_attention_backward": L, "ssm_scan_backward": L}
    if any(c != want for c in per_step):
        fail(f"train-main: launches a step {per_step}, expected {want}")
    want_inst = {flash_attention.TENSOR_CORE: L,
                 flash_attention.CUDA_CORE: 0}
    if any(c != want_inst for c in bwd_inst):
        fail(f"train-main: the attention's backward by instance a step "
             f"{bwd_inst}, expected {want_inst}")
    if not losses[-1] < losses[0]:
        fail(f"train-main: the loss did not fall: {losses}")
    med = statistics.median(walls[1:])
    tokens = TR_BATCH * TR_SEQ
    log(f"[train-main] {TR_STEPS} steps: step time {med:.3f} s (median of "
        f"steps 2-{TR_STEPS}; first {walls[0]:.3f} s), {tokens / med:.0f} "
        f"tokens/s, peak memory {peak / 2**30:.2f} GiB; launches a step "
        f"{per_step[-1]} (forward and its recompute, backward; the "
        f"attention's backward by instance {bwd_inst[-1]}); losses "
        f"{[round(x, 4) for x in losses]}")

    def one_step():
        nonlocal state
        state, _ = ts(state, batch)

    # one more step with its live storages counted as the dry run counts
    # them ([dryrun-main]), beside the allocator's peak of that step
    from repro_torch.roofline.analysis import LiveBytes
    mem = LiveBytes()
    mem.add(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mem:
        one_step()
    torch.cuda.synchronize()
    live = {"live_peak": mem.peak,
            "live_alloc_peak": torch.cuda.max_memory_allocated()}
    del mem

    ks, wall = device_kernels(one_step)
    prof = report_profile("train step (hymba-1.5b, 4 x 4,096 tokens)", ks,
                          wall, ("fa_bwd_", "ssm_scan_bwd"), 1, "step")
    if prof["busy_us"] is not None:
        shares = {n: sum(t for k, (_, t) in ks.items() if p in k)
                  / prof["busy_us"] for n, p in (
                      ("flash_attention_backward", "fa_bwd_"),
                      ("ssm_scan_backward", "ssm_scan_bwd"),
                      ("flash_attention", "flash_attention_bf16_kernel"),
                      ("ssm_scan", "ssm_scan_kernel"))}
        log("[profile] train step: " + ", ".join(
            f"{n} {100 * v:.1f}%" for n, v in shares.items())
            + " of the device time")
    del state
    torch.cuda.empty_cache()
    return {"launches": per_step[-1], "step_s": med, "peak": peak, **live}


def events_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls (after ``warmup``), over ``reps``.  The calls queue
    ahead of the device, so the host's share of a call is hidden unless it
    is the larger."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bwd_timing(fn, names, expect_ops):
    """(device ms from events_ms, {operation: count} of one call from a
    CUDA graph, {kernel: profiler us a call}) of a backward call; fails
    unless the graph holds exactly ``expect_ops`` device operations, each
    a kernel whose name holds one of ``names``."""
    from torch_kernel_inputs import graph_ops
    ops_ = graph_ops(fn)
    ours = {k: c for k, c in ops_.items() if any(n in k for n in names)}
    if sum(ops_.values()) != expect_ops or sum(ours.values()) != expect_ops:
        fail(f"a backward call holds {ops_} in its graph, expected "
             f"{expect_ops} kernels named {names}")
    ks, _ = device_kernels(lambda: [fn() for _ in range(5)])
    split = {k.split("(")[0].replace("void ", ""): t / c
             for k, (c, t) in ks.items() if any(n in k for n in names)}
    return events_ms(fn), ops_, split


def train_kernel_entries(launches, fa_errs, ss_err, dev):
    """Both backward kernels at the training main run's shapes (phase 3's
    inputs, made again), and the attention's at moonshot's hd 128 causal
    shape, beside their bounds, plain versions and (attention) SDPA's
    backward at the same mask: boolean window mask with enable_gqa at
    hymba's, is_causal on its flash backend at hd 128.  Stream time from
    events around each call (``time_ms``), device time from events around
    20 back-to-back calls (``events_ms``), the device operations of one
    call from a CUDA graph (``graph_ops``) and the profiler's time of
    each kernel of the call where it records them.  ``fa_errs``: the
    attention rows' max_abs_err by name."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    sfu = exp_per_s()
    entries, split = [], {}
    for name, case in (("flash_attention_backward", FLASH_BWD_MAIN),
                       ("flash_attention_backward (hd 128)",
                        FLASH_BWD_HD128)):
        (q, k, v, out, dout), kw = bwd_inputs(case, dev)
        B, H, KV, S, _, hd, causal, W, _, _ = case

        def fa_call(q=q, k=k, v=v, out=out, dout=dout, kw=kw):
            return flash_attention.flash_attention_backward(q, k, v, out,
                                                            dout, **kw)

        fa_ms = time_ms(fa_call, reps=20, warmup=3)
        inst = flash_attention.LAST_BWD_INSTANCE
        dev_ms, ops_, split[name] = bwd_timing(fa_call, ["fa_bwd_"], 2)
        fa_plain = time_ms(lambda: ref.mha_backward_reference(
            q, k, v, out, None, dout, **kw), reps=2, warmup=1)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        if W:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - W)
            lib_out = F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, enable_gqa=True)
            lib_how = "boolean window mask, enable_gqa"
        else:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                lib_out = F.scaled_dot_product_attention(ql, kl, vl,
                                                         is_causal=True)
            lib_how = "is_causal, flash backend"
        fa_lib = time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dout, retain_graph=True), reps=10,
            warmup=2)
        del lib_out, ql, kl, vl
        pairs = attn_pairs(S, S, causal, W) * B * H
        dq, dk, dv = fa_call()
        # per unmasked pair: five products of 2 hd flops (q.k, dout.v, P^T
        # dout, dS^T q, dS k) and one exponential
        fa_bound, fa_by, fa_op = bound_ms(
            nbytes(q, k, v, out, dout, dq, dk, dv),
            {"bf16 tensor-core flops": (10 * hd * pairs, PEAK_BF16_FLOP_S),
             "exponentials": (pairs, sfu)})
        del dq, dk, dv, q, k, v, out, dout
        entries.append(
            {"name": name, "route": "cuda",
             "source":
                 "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/models/layers.py:105",
             "replaces_note": "no TPU kernel: the reference's gradient is "
                              "autodiff of its jnp attend",
             # no training run at moonshot's shape: 0 launches there
             "launches": launches[name] if name in launches else 0,
             "max_abs_err": fa_errs[name], "ms": fa_ms,
             "plain_ms": fa_plain,
             "bound_ms": fa_bound, "bound_by": fa_by, "bound_op": fa_op,
             "library_ms": fa_lib, "library_call": lib_how,
             "instance": inst, "device_ms": dev_ms,
             "graph_ops": sum(ops_.values()), "shape": list(case[:8])})
        torch.cuda.empty_cache()

    ss_args = ssm_bwd_inputs(*SSM_BWD_MAIN, dev)

    def ss_call():
        return ssm_scan.ssm_scan_backward(*ss_args)

    ss_ms = time_ms(ss_call, reps=10, warmup=2)
    ss_inst = ssm_scan.LAST_BWD_INSTANCE
    ss_dev, ss_ops, split["ssm_scan_backward"] = bwd_timing(
        ss_call, ["ssm_scan_bwd"], 2)
    ss_plain = time_ms(lambda: ref.ssm_scan_backward_reference(*ss_args),
                       reps=2, warmup=1)
    outs = ss_call()
    Bs, Ss, Dss, N = SSM_BWD_MAIN
    elems = Bs * Ss * Dss * N
    # per state element and step: the state's recompute (4 operations),
    # the reverse recurrence and the five gradients' terms (12), one
    # exponential
    ss_bound, ss_by, ss_op = bound_ms(
        nbytes(*ss_args, *outs), {"f32 operations": (16 * elems,
                                                     PEAK_F32_OPS_S),
                                  "exponentials": (elems, sfu)})
    del outs, ss_args
    entries.append(
        {"name": "ssm_scan_backward", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
         "replaces": "src/repro/models/ssm.py:76",
         "replaces_note": "no TPU kernel: the reference's gradient is "
                          "autodiff of its lax.scan",
         "launches": launches["ssm_scan_backward"], "max_abs_err": ss_err,
         "ms": ss_ms, "plain_ms": ss_plain, "bound_ms": ss_bound,
         "bound_by": ss_by, "bound_op": ss_op, "library_ms": None,
         "instance": ss_inst, "device_ms": ss_dev,
         "graph_ops": sum(ss_ops.values()), "shape": list(SSM_BWD_MAIN)})
    return entries, split


# --------------------------------------------------------------------------
# the mesh side of training and the launcher: [launch-train],
# [mesh-parity], [mesh-main]
# --------------------------------------------------------------------------

# [launch-train]: the reference launcher's default --arch at its full
# configuration; [mesh-parity]: hymba-1.5b at full width cut to 2 layers
# in float32 on a global batch of 4 x 1,100 tokens from the port's
# pipeline, moonshot cut to [moe-parity]'s 2 layers and B x prompt;
# [mesh-main]: hymba-1.5b cut to 4 layers in bf16 on [train-main]'s
# 4 x 4,096 tokens, 2 steps (4 until the decode layouts' phases took
# their seconds)
LAUNCH_ARGS = ("--arch", "smollm-360m", "--batch", "8", "--seq", "2048")
MESH_LAYERS, MESH_BATCH, MESH_SEQ = 2, 4, 1100
MESH_MAIN_LAYERS, MESH_MAIN_STEPS = 4, 2
# [mesh-main]'s peak a rank when its step gathered the whole model before
# the forward (H100 80GB HBM3), which the per-period gathers are held under
MESH_MAIN_WHOLE_GIB = 7.13
# tensor parallelism: [mesh-parity]'s llama3.2-1b at full width (d_model
# 2,048, 32/8 heads, d_ff 8,192, vocab 128,256, tied) cut to TP_PAR_LAYERS
# layers in float32 on (1, 2); [tp-main]: the same cut to TP_LAYERS of its
# 16 layers in bf16 (remat "dots"), TP_STEPS steps of [train-main]'s 4 x
# 4,096 tokens on (1, 2) and then (1, 1) (4 layers and 4 steps until the
# decode layouts' phases took their seconds)
TP_ARCH, TP_PAR_LAYERS, TP_LAYERS, TP_STEPS = "llama3_2_1b", 2, 2, 2
# the kernels at the tensor-parallel ranks' shapes, checked in phase 3 and
# timed after phase 8: [tp-main]'s llama rank (16 of 32 query heads over
# kv heads 0-3 or 4-7), [mesh-parity]'s hymba (1, 2) rank 0 (13 of 25
# heads, which start mid-group, so a kv head a query head: 13 over 13)
# and its SSM (1,600 of 3,200 channels a rank)
FLASH_TP = {
    "llama tp rank": (TR_BATCH, 16, 4, TR_SEQ, TR_SEQ, 64, True, 0, 0.0,
                      "bfloat16"),
    "hymba 13 heads": (MESH_BATCH, 13, 13, MESH_SEQ, MESH_SEQ, 64, True,
                       1024, 0.0, "float32"),
}
SSM_TP = (MESH_BATCH, MESH_SEQ, 1600, 16)


def launch_train(dev) -> dict:
    """[launch-train]: repro_torch.launch.train.main in this process, no
    process group, on smollm-360m's full configuration.  Run A: 4 steps,
    saving async at step 2 and blocking at 4, into a fresh directory;
    A's step 4 is set aside.  Run B: --resume in the same directory
    restores step 2 and writes step 4 again, which must equal A's within
    the train bands (f32 leaves 1e-5 relative plus 1e-4 of the leaf's
    largest magnitude, bf16 ones 5e-2 in norm); whether it is bit-equal
    is printed.  The seconds of each save (the synchronous host copy,
    then the write) and of the restore, and the bytes a checkpoint
    writes; the attention's launches a step.  The directory is removed
    at exit."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    times = {"save": [], "write": [], "restore": []}

    class Timed(checkpoint.Checkpointer):
        def save(self, *a, **kw):
            t0 = time.perf_counter()
            super().save(*a, **kw)
            times["save"].append(time.perf_counter() - t0)

        def _write(self, *a, **kw):
            t0 = time.perf_counter()
            super()._write(*a, **kw)
            times["write"].append(time.perf_counter() - t0)

        def restore(self, *a, **kw):
            t0 = time.perf_counter()
            out = super().restore(*a, **kw)
            times["restore"].append(time.perf_counter() - t0)
            return out

    d = pathlib.Path(tempfile.mkdtemp(prefix="launch_train_"))
    real = launcher.Checkpointer
    launcher.Checkpointer = Timed
    t0 = time.perf_counter()
    try:
        base = list(LAUNCH_ARGS) + ["--ckpt-dir", str(d), "--log-every", "1"]
        ops.reset_launch_counts()
        rc = launcher.main(base + ["--steps", "4", "--ckpt-every", "2"])
        launches = ops.launch_counts(ops.FORWARD + ops.BACKWARD)
        if rc != 0 or sorted(checkpoint.Checkpointer(d).all_steps()) \
                != [2, 4]:
            fail(f"launch-train: run A returned {rc}, checkpoints "
                 f"{checkpoint.Checkpointer(d).all_steps()}")
        a_dir = d / "a_step_4"
        os.replace(d / "step_0000000004", a_dir)
        n_bytes = sum(f.stat().st_size for f in a_dir.iterdir())
        rc = launcher.main(base + ["--steps", "4", "--resume"])
        if rc != 0:
            fail(f"launch-train: run B returned {rc}")
        man = json.loads((a_dir / "manifest.json").read_text())
        man_b = json.loads((d / "step_0000000004" / "manifest.json")
                           .read_text())
        if man != man_b:
            fail("launch-train: run B's manifest is not run A's")
        bit_equal, worst = True, 0.0
        for m in man["leaves"]:
            a = np.load(a_dir / f"{m['name']}.npy")
            b = np.load(d / "step_0000000004" / f"{m['name']}.npy")
            if np.array_equal(a, b):
                continue
            bit_equal = False
            if m["dtype"] == "bfloat16":
                a = (a.astype(np.uint32) << 16).view(np.float32)
                b = (b.astype(np.uint32) << 16).view(np.float32)
                err = float(np.linalg.norm(a.astype(np.float64) - b))
                ok = err <= 5e-2 * float(np.linalg.norm(a)) + 1e-12
            else:
                err = float(np.abs(a - b).max())
                ok = bool((np.abs(a - b) <= 1e-5 * np.abs(a)
                           + 1e-4 * float(np.abs(a).max())).all())
            worst = max(worst, err)
            if not ok:
                fail(f"launch-train: run B's {m['path']} differs from run "
                     f"A's by {err}")
    finally:
        launcher.Checkpointer = real
        shutil.rmtree(d, ignore_errors=True)
    L = 32
    want = {"flash_attention": 4 * 2 * L, "flash_attention_backward": 4 * L}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"launch-train: launches in run A's 4 steps {launches}, "
             f"expected {want}")
    log(f"[launch-train] python -m repro_torch.launch.train "
        f"{' '.join(LAUNCH_ARGS)}: A --steps 4 --ckpt-every 2 (async save "
        f"at 2, blocking at 4), B --resume --steps 4 from step 2: B's step "
        f"4 {'bit-equal to' if bit_equal else f'within the train bands of (largest difference {worst:.3g})'} "
        f"A's; {n_bytes / 2**30:.3f} GiB a checkpoint; saves "
        f"{[round(t, 3) for t in times['save']]} s on the loop (the host "
        f"copy, and the write of the blocking ones), writes "
        f"{[round(t, 3) for t in times['write']]} s, restore "
        f"{[round(t, 3) for t in times['restore']]} s; launches in A "
        f"{launches}; {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "bit_equal": bit_equal,
            "bytes": n_bytes, **times}


def mesh_cfgs():
    """hymba and moonshot for [mesh-parity], hymba for [mesh-main]."""
    from repro_torch import configs
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               microbatches=1)
    return (dataclasses.replace(configs.get_config(LM_ARCH),
                                n_layers=MESH_LAYERS, **f32),
            dataclasses.replace(configs.get_config(MOE_ARCH),
                                n_layers=MOE_PAR_LAYERS, **f32),
            dataclasses.replace(configs.get_config(LM_ARCH),
                                n_layers=MESH_MAIN_LAYERS, microbatches=1))


def tp_cfgs():
    """llama3.2-1b for [mesh-parity] (float32) and [tp-main] (bf16)."""
    from repro_torch import configs
    full = configs.get_config(TP_ARCH)
    return (dataclasses.replace(full, n_layers=TP_PAR_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32"),
            dataclasses.replace(full, n_layers=TP_LAYERS))


def seeded_params(cfg, dev):
    """The same parameters in every process: a CUDA generator's draw."""
    from repro_torch.models import transformer
    return transformer.make_params(
        cfg, torch.Generator(device=dev).manual_seed(5), device=dev)


def mesh_batch(cfg, B, S, dev, unequal=False):
    """Step 0's global batch of the port's pipeline; ``unequal``: the
    first half's rows keep their first 100 labels only."""
    from repro_torch.data.pipeline import DataConfig, get_batch
    b = get_batch(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                             seed=21), 0, device=dev)
    if unequal:
        b["labels"][:B // 2, 100:] = -1
    return b


def host_copy(tree: dict) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in tree.items()}


def mesh_reference(cfg, batch, opt, steps, dev, full=True,
                   routes=False) -> dict:
    """The one-rank make_train_step (no mesh) on the card from the seeded
    parameters, kept on the host: each step's metrics and moments (with
    ``full`` its parameters, and those before the first step), with
    ``routes`` the first forward's routes."""
    from repro_torch.models import moe
    from repro_torch.train import step
    from torch_kernel_inputs import recorded_routes
    state = step.train_state(seeded_params(cfg, dev))
    ref = {"metrics": [], "steps": []}
    if full:
        ref["before"] = host_copy(dict(state["params"].named_parameters()))
    ts = step.make_train_step(cfg, opt_cfg=opt)
    for i in range(steps):
        with recorded_routes(moe) as rec:
            state, m = ts(state, batch)
        ref["metrics"].append({k: float(v) for k, v in m.items()})
        if routes and i == 0:
            ref["routes"] = rec[:cfg.n_layers]
        snap = {"m": host_copy(state["opt"]["m"])}
        if full:
            snap["v"] = host_copy(state["opt"]["v"])
            snap["p"] = host_copy(dict(state["params"].named_parameters()))
        ref["steps"].append(snap)
    del state
    torch.cuda.empty_cache()
    return ref


def mesh_train_check(tag, cfg, mesh, batch, opt, steps, ref, dev,
                     full=True, restart=False) -> dict:
    """make_train_step(cfg, mesh) from the seeded parameters sharded over
    ``mesh``, held step by step to the one-rank reference ``ref``
    (``mesh_reference``) on this rank's blocks, in [train-parity]'s bands: loss, nll, aux,
    grad_norm 1e-5 and lr 1e-6; the gradients read off the moments within
    1e-4 of the full leaf's largest magnitude; with ``full`` m and v
    within 1e-5 relative plus 1e-4 of their largest magnitude and the
    parameters within adamw_param_check's bound (the elements that need
    the moments' part counted once, on the rank that owns them).  With
    ``restart`` (and ``full``) each step after the first starts from the
    reference's state before it, cut to this rank's blocks, as
    [train-parity]'s steps do: a mesh whose compute splits over "model"
    sums in another order, and an element whose gradient is near zero may
    take an update of the other sign (AdamW's m / sqrt(v)), which the next
    step's gradients would carry (``chain_drift`` reads how far)."""
    from repro_torch.kernels import ops
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    from torch_kernel_inputs import adamw_param_check
    from torch_spmd import count_collectives
    ctx = spmd.Ctx.of(mesh)
    sh, _ = step.state_shardings(cfg, mesh)
    specs = {n: s.spec for n, s in sh["params"].items()}
    state = step.train_state(step.shard_params(seeded_params(cfg, dev),
                                               sh["params"]))
    torch.cuda.empty_cache()
    ts = step.make_train_step(cfg, mesh, opt_cfg=opt)
    rm = ref["metrics"]
    b1 = opt.b1
    out = {"worst": {}, "g_err": 0.0, "loose": 0, "total": 0, "calls": [],
           "launches": [], "walls": []}
    prev_m = {n: torch.zeros_like(t) for n, t in state["opt"]["m"].items()}
    carried = {}
    for i in range(steps):
        if restart and i:
            prev = ref["steps"][i - 1]
            with torch.no_grad():
                for n, p in state["params"].named_parameters():
                    p.copy_(spmd.block(prev["p"][n].to(dev), specs[n], ctx))
                    for k in ("m", "v"):
                        state["opt"][k][n].copy_(spmd.block(
                            prev[k][n].to(dev), specs[n], ctx))
                    prev_m[n] = state["opt"]["m"][n].clone()
            carried = {}
        ops.reset_launch_counts()
        with count_collectives() as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = ts(state, batch)
            got = {k: float(v) for k, v in m.items()}
            out["walls"].append(time.perf_counter() - t0)
        out["calls"].append(dict(calls))
        out["launches"].append(ops.launch_counts(ops.FORWARD + ops.BACKWARD))
        out["shapes"] = shape_launches()
        exp = rm[i]
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            rel = abs(got[k] - exp[k]) / max(abs(exp[k]), 1e-30)
            out["worst"][k] = max(out["worst"].get(k, 0.0), rel)
            if not math.isfinite(got[k]) or \
                    rel > (1e-6 if k == "lr" else 1e-5) and \
                    abs(got[k] - exp[k]) > 1e-7:
                fail(f"{tag}: step {i} {k} {got[k]}, one rank {exp[k]}")
        t = np.float32(i + 1)
        c1, c2 = (float(1 - np.float32(b) ** t) for b in (opt.b1, opt.b2))
        sg, se = (min(1.0, opt.grad_clip / (x["grad_norm"] + 1e-9))
                  for x in (got, exp))
        for n, p in state["params"].named_parameters():
            spec = specs[n]

            def blk(x):
                return spmd.block(x, spec, ctx)
            em = ref["steps"][i]["m"][n].to(dev)
            pm = torch.zeros_like(em) if i == 0 else \
                ref["steps"][i - 1]["m"][n].to(dev)
            ge = (em - b1 * pm) / ((1 - b1) * se)
            top = float(ge.abs().max())
            gm = state["opt"]["m"][n]
            gg = (gm - b1 * prev_m[n]) / ((1 - b1) * sg)
            err = float((gg - blk(ge)).abs().max())
            out["g_err"] = max(out["g_err"], err / max(top, 1e-30))
            if err > 1e-4 * top + 1e-12:
                fail(f"{tag}: step {i} gradient of {n} differs by {err} "
                     f"(largest {top})")
            prev_m[n] = gm.clone()
            if not full:
                continue
            ev = ref["steps"][i]["v"][n].to(dev)
            for k, g, e in (("m", gm, em), ("v", state["opt"]["v"][n], ev)):
                d = (g - blk(e)).abs()
                if (d > 1e-5 * blk(e).abs()
                        + 1e-4 * float(e.abs().max())).any():
                    fail(f"{tag}: step {i} {k} of {n} differs by "
                         f"{float(d.max())}")
            ep = ref["steps"][i]["p"][n].to(dev)
            before = (ref["before"] if i == 0
                      else ref["steps"][i - 1]["p"])[n].to(dev)
            diff, bad, loose = adamw_param_check(
                p.detach(), blk(ep), blk(before), gm, blk(em),
                state["opt"]["v"][n], blk(ev), exp["lr"], c1, c2, opt.eps,
                carried.get(n, torch.zeros_like(p.detach())))
            if bad:
                fail(f"{tag}: step {i} parameter {n}: {bad} elements beyond "
                     f"the bound (max diff {float(diff.max())})")
            carried[n] = diff
            if spmd.owns(spec, ctx):
                out["loose"] += loose
                out["total"] += diff.numel()
        out["loss"] = got["loss"]
    if out["loose"] > 0.01 * out["total"] * steps:
        fail(f"{tag}: {out['loose']} of {out['total']} parameter elements "
             f"needed the moments' part of the bound over {steps} steps")
    del state
    torch.cuda.empty_cache()
    return out


def chain_drift(cfg, mesh, batch, opt, ref, dev) -> dict:
    """A reading, not a check: make_train_step(cfg, mesh) two steps chained
    from the seeded parameters, against the one-rank reference ``ref``
    on this rank's blocks.  Step 1: the gradient elements whose sign
    differs from one rank's (``flips``; the largest of their one-rank
    magnitudes over the leaf's largest, ``flip_top``), and the largest
    parameter difference after it over the step's lr (``p_lr``: AdamW's
    m / sqrt(v) gives such an element about lr of the other sign).  Step
    2: each leaf's gradient elements beyond mesh_train_check's band, 1e-4
    of the leaf's largest magnitude (``over``), and the leaf whose error
    over its largest is worst (``worst``).  It says why a restarted check
    (``mesh_train_check(restart=True)``) restarts."""
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    ctx = spmd.Ctx.of(mesh)
    sh, _ = step.state_shardings(cfg, mesh)
    specs = {n: s.spec for n, s in sh["params"].items()}
    state = step.train_state(step.shard_params(seeded_params(cfg, dev),
                                               sh["params"]))
    ts = step.make_train_step(cfg, mesh, opt_cfg=opt)
    b1 = opt.b1
    prev_m = {n: torch.zeros_like(t) for n, t in state["opt"]["m"].items()}
    out = {"flips": 0, "flip_top": 0.0, "p_lr": 0.0, "over": {},
           "worst": ("", 0.0)}
    for i in range(2):
        state, m = ts(state, batch)
        exp = ref["metrics"][i]
        sg, se = (min(1.0, opt.grad_clip / (g + 1e-9))
                  for g in (float(m["grad_norm"]), exp["grad_norm"]))
        for n, p in state["params"].named_parameters():
            em = ref["steps"][i]["m"][n].to(dev)
            pm = torch.zeros_like(em) if i == 0 else \
                ref["steps"][i - 1]["m"][n].to(dev)
            ge = (em - b1 * pm) / ((1 - b1) * se)
            top = max(float(ge.abs().max()), 1e-30)
            ge = spmd.block(ge, specs[n], ctx)
            gm = state["opt"]["m"][n]
            gg = (gm - b1 * prev_m[n]) / ((1 - b1) * sg)
            prev_m[n] = gm.clone()
            if i == 0:
                flip = torch.sign(gg) != torch.sign(ge)
                out["flips"] += int(flip.sum())
                if flip.any():
                    out["flip_top"] = max(out["flip_top"],
                                          float(ge[flip].abs().max()) / top)
                ep = spmd.block(ref["steps"][0]["p"][n].to(dev), specs[n], ctx)
                out["p_lr"] = max(out["p_lr"], float(
                    (p.detach() - ep).abs().max()) / exp["lr"])
                continue
            d = (gg - ge).abs()
            k = int((d > 1e-4 * top + 1e-12).sum())
            if k:
                out["over"][n] = k
            if float(d.max()) / top > out["worst"][1]:
                out["worst"] = (n, float(d.max()) / top)
    del state
    torch.cuda.empty_cache()
    return out


def shape_launches() -> dict:
    """The attention's launches since the last reset by shape, forward
    and backward, and the scan's: {"fwd": {shape: n}, "bwd": {shape: n},
    "ssm_scan": n}."""
    from repro_torch.kernels import flash_attention, ops
    return {"fwd": dict(flash_attention.SHAPE_LAUNCHES),
            "bwd": dict(flash_attention.BWD_SHAPE_LAUNCHES),
            "ssm_scan": ops.launch_counts()["ssm_scan"]}


def moe_prefill_check(tag, cfg, mesh, batch, ref, dev) -> dict:
    """make_prefill(cfg, mesh) of moonshot's blocks against the one-rank
    prefill: routes and the drops they give exact, logits within 1e-4 of
    their largest magnitude."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.train import step
    from torch_kernel_inputs import recorded_routes
    B, S = batch["tokens"].shape
    C = moe.capacity(cfg, S)
    params = seeded_params(cfg, dev)
    if mesh is not None:
        sh, _ = step.state_shardings(cfg, mesh)
        params = step.shard_params(params, sh["params"])
    cache = transformer.init_cache(cfg, B, S, device=dev)
    ops.reset_launch_counts()
    with torch.inference_mode(), recorded_routes(moe) as routes:
        logits, _ = step.make_prefill(cfg, mesh)(params, batch["tokens"],
                                                 cache)
    drops = [int((moe._positions_in_expert(t, cfg) >= C).sum())
             for t, _ in routes]
    got = {"logits": logits.float().cpu(), "routes": routes, "drops": drops,
           "launches": ops.launch_counts()}
    del params, cache
    torch.cuda.empty_cache()
    if ref is None:
        return got
    exp = ref["prefill"]
    bad = [i for i, ((a, _), (b, _)) in enumerate(zip(routes,
                                                      exp["routes"]))
           if not torch.equal(a, b)]
    if bad or drops != exp["drops"]:
        fail(f"{tag}: routes differ in layers {bad}, drops {drops} against "
             f"{exp['drops']}")
    top = float(exp["logits"].abs().max())
    err = float((got["logits"] - exp["logits"]).abs().max())
    if err > 1e-4 * top:
        fail(f"{tag}: prefill logits differ by {err} (largest {top})")
    got["err"] = err / top
    return got


def moe_split_check(tag, cfg, mesh, batch, ref, dev) -> dict:
    """A train-mode forward and loss of moonshot over ``mesh`` with the
    batch split: the global loss and aux equal the one-rank train step's
    (1e-5), a route differs only at a near-tie."""
    from repro_torch.models import moe, transformer
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    from torch_kernel_inputs import recorded_routes, route_flips
    ctx = spmd.Ctx.of(mesh).for_batch(batch["tokens"].shape[0])
    sh, _ = step.state_shardings(cfg, mesh)
    blocks = step.shard_params(seeded_params(cfg, dev), sh["params"])
    torch.cuda.empty_cache()
    full = step.gather_params(blocks, step.tp_plan(cfg, mesh, blocks), ctx)
    del blocks
    with torch.no_grad(), recorded_routes(moe) as routes:
        logits, _, aux = transformer.forward(
            cfg, full, ctx.batch_rows(batch["tokens"]), mode="train",
            ctx=ctx)
        loss, parts = transformer.lm_loss(
            cfg, logits, ctx.batch_rows(batch["labels"]), aux, ctx=ctx)
    loss, aux = ctx.batch_sum(torch.stack([loss, parts["aux"]])).tolist()
    rows = lambda t: spmd.gather(t.to(dev), (ctx.batch_axes,), ctx).cpu()
    routes = [(rows(t), rows(g)) for t, g in routes]
    del full, logits
    torch.cuda.empty_cache()
    exp = ref["metrics"][0]
    for k, v in (("loss", loss), ("aux", aux)):
        if abs(v - exp[k]) > 1e-5 * abs(exp[k]):
            fail(f"{tag}: {k} {v}, one rank {exp[k]}")
    flips = route_flips(routes, ref["routes"])
    return {"loss": loss, "aux": aux, "flips": flips,
            "rel": {k: abs(v - exp[k]) / abs(exp[k])
                    for k, v in (("loss", loss), ("aux", aux))}}


@contextlib.contextmanager
def timed_collectives():
    """Seconds, calls and bytes of every torch.distributed collective
    called inside.  Before each call the rank finishes its card work and
    waits at a barrier of the call's group for the other ranks (both
    ranks share one card, so a rank's wait holds the other's compute):
    ``wait_s`` sums those waits, ``s`` the calls themselves, from the
    barrier to the card's synchronisation after the call (gloo's calls
    block the host anyway)."""
    import torch.distributed as dist
    acc = {"s": 0.0, "wait_s": 0.0, "bytes": {}, "calls": 0}
    saved = {}
    for name in ("all_gather_single", "all_gather_into_tensor",
                 "reduce_scatter_single", "reduce_scatter_tensor",
                 "all_reduce"):
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def wrapped(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.barrier(group=kw.get("group"))
            t1 = time.perf_counter()
            r = _fn(*a, **kw)
            torch.cuda.synchronize()
            acc["wait_s"] += t1 - t0
            acc["s"] += time.perf_counter() - t1
            acc["calls"] += 1
            # the bytes the call hands in (a reduce-scatter's full input,
            # an all-gather's own block, an all-reduce's tensor)
            t = a[1] if _name.startswith(("all_gather", "reduce_scatter")) \
                else a[0]
            kind = _name.split("_")[0] + "_" + _name.split("_")[1]
            acc["bytes"][kind] = acc["bytes"].get(kind, 0) \
                + t.numel() * t.element_size()
            return r
        setattr(dist, name, wrapped)
    try:
        yield acc
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def mesh_main_rank(cfg, mesh, dev, steps=MESH_MAIN_STEPS) -> dict:
    """[mesh-main] (and [tp-main]) on this rank: ``cfg`` in bf16 (remat
    "dots") sharded over ``mesh``, ``steps`` steps of [train-main]'s batch
    through make_train_step(cfg, mesh), timed without instrumentation,
    then one more step under ``timed_collectives`` for the collectives'
    bytes and seconds; the peak of allocated memory over the steps, and
    what was allocated before the state was made (``base``)."""
    from repro_torch.kernels import ops
    from repro_torch.train import optim, step
    base = torch.cuda.memory_allocated(dev)
    sh, _ = step.state_shardings(cfg, mesh)
    state = step.train_state(step.shard_params(seeded_params(cfg, dev),
                                               sh["params"]))
    torch.cuda.empty_cache()
    batch = train_batch(cfg, TR_BATCH, TR_SEQ, 11, dev)
    ts = step.make_train_step(cfg, mesh, opt_cfg=optim.AdamWConfig(
        warmup_steps=0))
    torch.cuda.reset_peak_memory_stats()
    out = {"walls": [], "losses": [], "launches": [], "base": base}
    for i in range(steps + 1):
        timed = i == steps
        ops.reset_launch_counts()
        with (timed_collectives() if timed
              else contextlib.nullcontext()) as acc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = ts(state, batch)
            loss = float(m["loss"])
            wall = time.perf_counter() - t0
        if not math.isfinite(loss):
            fail(f"mesh-main: step {i} loss {loss}")
        if timed:
            out["comm"], out["timed_wall"] = acc, wall
        else:
            out["walls"].append(wall)
            out["losses"].append(loss)
        out["launches"].append(ops.launch_counts(ops.FORWARD + ops.BACKWARD))
        out["shapes"] = shape_launches()
    out["peak"] = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank, world, dev):
    """The two gloo ranks of [mesh-parity] and [mesh-main], both on
    ``dev`` (card 0): hymba on (2, 1) and (1, 2), the unequal batch on
    (2, 1), moonshot's prefill and train step on (1, 2) and its
    split-batch forward on (2, 1), then [mesh-main] on (2, 1).  Each rank
    computes the one-rank references it is held to (moonshot's one rank
    at a time: its full train state leaves room for one)."""
    import torch.distributed as dist
    from repro_torch.train import optim
    from torch_spmd import mesh_of
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hy, mo, mn = mesh_cfgs()
    ll, tp = tp_cfgs()
    opt = optim.AdamWConfig(warmup_steps=0)
    out, secs, t0 = {}, {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        secs[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
    for key in ("a", "u"):
        batch = mesh_batch(hy, MESH_BATCH, MESH_SEQ, dev, key == "u")
        ref = mesh_reference(hy, batch, opt, 2, dev)
        for shape in (((2, 1), (1, 2)) if key == "a" else ((2, 1),)):
            out[f"hymba {shape} {key}"] = mesh_train_check(
                f"mesh-parity hymba {shape} {key} rank {rank}", hy,
                mesh_of(shape, device=dev.type), batch, opt, 2, ref, dev)
        del ref
        lap(f"hymba {key}")
    # tensor parallelism over "model": llama's heads, ff and vocab split;
    # its second step restarts from one rank's state, and the chained
    # steps' drift is read beside it (chain_drift)
    batch = mesh_batch(ll, MESH_BATCH, MESH_SEQ, dev)
    ref = mesh_reference(ll, batch, opt, 2, dev)
    out["llama (1, 2)"] = mesh_train_check(
        f"mesh-parity llama (1, 2) rank {rank}", ll,
        mesh_of((1, 2), device=dev.type), batch, opt, 2, ref, dev,
        restart=True)
    out["llama chained"] = chain_drift(ll, mesh_of((1, 2), device=dev.type),
                                       batch, opt, ref, dev)
    del ref
    lap("llama (1, 2)")
    batch = mesh_batch(mo, MOE_PAR_BATCH, MOE_PAR_PROMPT, dev)
    for r in range(world):
        if r == rank:
            ref = mesh_reference(mo, batch, opt, 1, dev, full=False,
                                 routes=True)
            pre = moe_prefill_check("", mo, None, batch, None, dev)
            ref["prefill"] = {k: pre[k] for k in ("logits", "routes",
                                                  "drops")}
        dist.barrier()
    lap("moonshot references")
    m12 = mesh_of((1, 2), device=dev.type)
    out["moe prefill"] = moe_prefill_check(
        f"mesh-parity moonshot (1, 2) prefill rank {rank}", mo, m12, batch,
        ref, dev)
    del out["moe prefill"]["logits"], out["moe prefill"]["routes"]
    lap("moonshot prefill")
    out["moe train"] = mesh_train_check(
        f"mesh-parity moonshot (1, 2) rank {rank}", mo, m12, batch, opt, 1,
        ref, dev, full=False)
    lap("moonshot train step")
    out["moe split"] = moe_split_check(
        f"mesh-parity moonshot (2, 1) rank {rank}", mo,
        mesh_of((2, 1), device=dev.type), batch, ref, dev)
    del ref
    lap("moonshot split batch")
    out["main"] = mesh_main_rank(mn, mesh_of((2, 1), device=dev.type), dev)
    lap("mesh-main")
    out["tp"] = mesh_main_rank(tp, mesh_of((1, 2), device=dev.type), dev,
                               TP_STEPS)
    lap("tp-main (1, 2)")
    out["serve"] = serve_rank(rank, dev)
    lap("the decode layouts")
    out["secs"] = secs
    return out


def mesh_phases(dev) -> dict:
    """[launch-train] (no process group), then [mesh-parity]: a mesh of one
    over NCCL in this process, and two gloo ranks on card 0 (NCCL refuses
    two ranks on one card), then [mesh-main] on those ranks, each held
    to the one-rank make_train_step without a mesh on the card.  Returns
    the LM kernels' launches in the phase's runs."""
    import torch.distributed as dist
    from repro_torch.core import shard_sim
    from repro_torch.train import optim
    from torch_spmd import mesh_of
    t0 = time.perf_counter()
    lt = launch_train(dev)
    hy, mo, mn = mesh_cfgs()
    opt = optim.AdamWConfig(warmup_steps=0)
    L = MESH_LAYERS
    main_ref = mesh_reference(
        mn, train_batch(mn, TR_BATCH, TR_SEQ, 11, dev), opt,
        MESH_MAIN_STEPS, dev, full=False)["metrics"]
    # a mesh of one over NCCL, in this process
    batch = mesh_batch(hy, MESH_BATCH, MESH_SEQ, dev)
    ref = mesh_reference(hy, batch, opt, 2, dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            one = mesh_train_check(
                "mesh-parity hymba (1, 1)", hy,
                mesh_of((1, 1), device=dev.type), batch, opt, 2, ref, dev)
        finally:
            dist.destroy_process_group()
    del ref
    t1 = time.perf_counter()
    ranks = shard_sim.spawn(mesh_rank, 2, (dev,), backend="gloo")
    t_spawn = time.perf_counter() - t1
    # [tp-main] on a mesh of one over NCCL in this process, after the
    # two ranks' (1, 2) run
    ll, tp = tp_cfgs()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            tp_one = mesh_main_rank(tp, mesh_of((1, 1), device=dev.type),
                                    dev, TP_STEPS)
        finally:
            dist.destroy_process_group()
    t_tp_one = time.perf_counter() - t1
    serve_counts = serve_phases(ranks, dev)

    want = {"flash_attention": 2 * L, "ssm_scan": 2 * L,
            "flash_attention_backward": L, "ssm_scan_backward": L}

    def report(tag, r, want=want):
        bad = [c for c in r["launches"]
               if any(c[k] != n for k, n in want.items())]
        if bad:
            fail(f"{tag}: launches a step {r['launches']}, expected {want}")
        log(f"{tag}: == one rank at each of {len(r['walls'])} steps: "
            f"largest relative differences "
            f"{', '.join(f'{k} {v:.3g}' for k, v in r['worst'].items())}; "
            f"gradients within {r['g_err']:.3g} of each leaf's largest "
            f"magnitude; moments within bound; parameters within bound "
            f"({r['loose']} of {r['total']} elements beyond 1e-5 and within "
            f"the moments' part); collectives a step {r['calls']}; launches "
            f"a step {r['launches'][-1]}; step walls "
            f"{[round(w, 3) for w in r['walls']]} s")

    report(f"[mesh-parity] hymba-1.5b {L} layers f32, {MESH_BATCH} x "
           f"{MESH_SEQ} tokens, mesh (1, 1) over NCCL", one)
    launches = {"(1, 1)": one["launches"]}
    for rk, out in enumerate(ranks):
        for key in ("(2, 1) a", "(1, 2) a", "(2, 1) u"):
            r = out[f"hymba {key}"]
            what = "the unequal batch (100 valid labels a row in the first " \
                "half)" if key.endswith("u") else "the batch"
            report(f"[mesh-parity] hymba {key[:6]} rank {rk} (gloo), {what}",
                   r)
            launches[f"{key} rank {rk}"] = r["launches"]
        Lt = TP_PAR_LAYERS
        report(f"[mesh-parity] llama3.2-1b {Lt} layers f32 (1, 2) rank {rk} "
               f"(gloo), {MESH_BATCH} x {MESH_SEQ} tokens: heads, ff and "
               f"vocab split over 'model'", out["llama (1, 2)"],
               {"flash_attention": 2 * Lt, "ssm_scan": 0,
                "flash_attention_backward": Lt, "ssm_scan_backward": 0})
        launches[f"llama (1, 2) rank {rk}"] = out["llama (1, 2)"]["launches"]
        c = out["llama chained"]
        log(f"[mesh-parity] llama3.2-1b (1, 2) rank {rk}, its second step "
            f"above restarts from one rank's state; the same two steps "
            f"chained (a reading): step 1 {c['flips']} gradient elements of "
            f"the other sign (one-rank magnitudes up to {c['flip_top']:.3g} "
            f"of their leaf's largest), parameters then up to "
            f"{c['p_lr']:.3g} lr apart; step 2 gradient elements beyond "
            f"1e-4 of their leaf's largest {c['over'] or 'none'}, the worst "
            f"leaf {c['worst'][0]} at {c['worst'][1]:.3g}")
        p, t, s = out["moe prefill"], out["moe train"], out["moe split"]
        log(f"[mesh-parity] moonshot {MOE_PAR_LAYERS} layers f32, "
            f"{MOE_PAR_BATCH} x {MOE_PAR_PROMPT} tokens, rank {rk}: (1, 2) "
            f"{mo.n_experts // 2} experts a rank: make_prefill(cfg, mesh) "
            f"routes and drops {p['drops']} == one rank, logits within "
            f"{p['err']:.3g} of the largest; one train step == one rank: "
            f"{', '.join(f'{k} {v:.3g}' for k, v in t['worst'].items())}, "
            f"gradients within {t['g_err']:.3g}; collectives "
            f"{t['calls'][0]}; launches {t['launches'][0]} (prefill "
            f"{p['launches']}); (2, 1) batch split: loss {s['loss']:.6f} "
            f"and aux {s['aux']:.6f} == one rank (relative "
            f"{s['rel']['loss']:.3g}, {s['rel']['aux']:.3g}); "
            + ("routes equal to one rank's" if not s["flips"] else
               "routes differ only at near-ties: "
               + flip_note(s["flips"], MOE_PAR_LAYERS)))
        if not (t["launches"][0]["flash_attention"]
                and t["launches"][0]["flash_attention_backward"]):
            fail(f"mesh-parity: moonshot's train step launched "
                 f"{t['launches'][0]}")
    mm = ranks[0]["main"]
    for rk, out in enumerate(ranks):
        r = out["main"]
        for i, (a, b) in enumerate(zip(r["losses"], main_ref)):
            if not abs(a - b["loss"]) <= 5e-2 * abs(b["loss"]):
                fail(f"mesh-main: rank {rk} step {i} loss {a}, one rank "
                     f"{b['loss']}")
        Lm = MESH_MAIN_LAYERS
        wm = {"flash_attention": 2 * Lm, "ssm_scan": 2 * Lm,
              "flash_attention_backward": Lm, "ssm_scan_backward": Lm}
        if any(any(c[k] != n for k, n in wm.items()) for c in r["launches"]):
            fail(f"mesh-main: rank {rk} launches {r['launches']}")
    med = statistics.median(mm["walls"][1:])
    tokens = TR_BATCH * TR_SEQ
    comm = [o["main"]["comm"] for o in ranks]
    tw = [o["main"]["timed_wall"] for o in ranks]
    log(f"[mesh-main] hymba-1.5b cut to {MESH_MAIN_LAYERS} layers, bf16, "
        f"remat 'dots', mesh (2, 1) over gloo (both ranks on card 0), "
        f"{TR_BATCH} x {TR_SEQ} tokens a step, {MESH_MAIN_STEPS} steps: step "
        f"time {med:.3f} s (median of steps 2-{MESH_MAIN_STEPS}, rank 0; "
        f"first {mm['walls'][0]:.3f} s; {[round(w, 3) for w in mm['walls']]}"
        f"), {tokens / med:.0f} tokens/s; peak memory a rank "
        f"{[round(o['main']['peak'] / 2**30, 2) for o in ranks]} GiB; one "
        f"more step, instrumented (a card sync and a barrier before each "
        f"collective), hands {comm[0]['bytes']} bytes to {comm[0]['calls']} "
        f"collectives a rank: the calls take "
        f"{[round(c['s'], 3) for c in comm]} s and the waits for the other "
        f"rank at the barriers {[round(c['wait_s'], 3) for c in comm]} s of "
        f"the step's {[round(w, 3) for w in tw]} s (ranks 0, 1): the calls "
        f"{[round(100 * c['s'] / w, 1) for c, w in zip(comm, tw)]}% of the "
        f"instrumented step, {[round(100 * c['s'] / med, 1) for c in comm]}"
        f"% of the uninstrumented median; losses "
        f"{[round(x, 4) for x in mm['losses']]} (one rank "
        f"{[round(x['loss'], 4) for x in main_ref]}, within 5e-2); launches "
        f"a step {mm['launches'][-1]}")
    peaks = [round(o["main"]["peak"] / 2**30, 2) for o in ranks]
    if any(o["main"]["peak"] / 2**30 >= MESH_MAIN_WHOLE_GIB for o in ranks):
        fail(f"mesh-main: peak a rank {peaks} GiB, not below the "
             f"{MESH_MAIN_WHOLE_GIB} GiB of the whole model gathered")
    log(f"[mesh-main] peak a rank {peaks} "
        f"GiB with the blocks gathered a period at a time: below the "
        f"{MESH_MAIN_WHOLE_GIB} GiB with the whole model gathered")
    tp_out = tp_main_report(ranks, tp_one, tp)
    log(f"[tp-main] (1, 1) over NCCL in this process: {t_tp_one:.1f} s")
    log(f"[mesh] the two-rank spawn took {t_spawn:.1f} s wall, start-up "
        f"included (rank 0's parts, s: {ranks[0]['secs']}); the phase "
        f"{time.perf_counter() - t0:.1f} s")
    hy13 = FLASH_TP["hymba 13 heads"][:8]
    sh = ranks[0]["hymba (1, 2) a"]["shapes"]
    return {"launch-train": lt["launches"], "mesh-parity": launches,
            "mesh-main": mm["launches"][-1], "serve": serve_counts,
            "tp": {"llama tp rank": tp_out,
                   "hymba 13 heads": {"fwd": sh["fwd"].get(hy13, 0),
                                      "bwd": sh["bwd"].get(hy13, 0)},
                   "ssm_scan": sh["ssm_scan"]}}


def tp_kernel_entries(errs, launches, dev) -> list:
    """The kernels at the tensor-parallel ranks' shapes (FLASH_TP, SSM_TP;
    phase 3's inputs, made again) beside their bounds, plain versions and
    (attention) SDPA at the same mask, forward and backward; ``launches``
    the phase's counts by shape (``mesh_phases``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    sfu = exp_per_s()
    entries = []

    def sdpa(q, k, v, causal, W, S):
        if W:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - W)
            return lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)

    def row(name, source, replaces, n, ms, plain, lib, n_bytes, ops_, inst,
            case):
        bound, by, op = bound_ms(n_bytes, ops_)
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "bound_op": op, "library_ms": lib, "instance": inst,
            "shape": list(case)})
        log(f"[time] {name} ({inst}) at {tuple(case)}: {ms * 1e3:.1f} us a "
            f"call; bound {bound * 1e3:.3f} us by {op}; plain version "
            f"{plain * 1e3:.1f} us; library "
            + ("none" if lib is None else f"{lib * 1e3:.1f} us")
            + f"; {n} launches a step in its main run")

    for name, case in FLASH_TP.items():
        B, H, KV, S, _, hd, causal, W, _, dt = case
        f32 = dt == "float32"
        peak = ("f32 operations", PEAK_F32_OPS_S) if f32 \
            else ("bf16 tensor-core flops", PEAK_BF16_FLOP_S)
        pairs = attn_pairs(S, S, causal, W) * B * H
        n = launches[name] if name in launches else launches["llama tp rank"]
        nf = n["fwd"] if isinstance(n, dict) else n
        nb = n["bwd"] if isinstance(n, dict) else n
        (q, k, v), kw = flash_args(case, dev)

        def call(q=q, k=k, v=v, kw=kw):
            return flash_attention.flash_attention(q, k, v, **kw)

        ms = time_ms(call, reps=20, warmup=3)
        inst = flash_attention.LAST_INSTANCE
        plain = time_ms(lambda: ref.mha_reference(q, k, v, **kw), reps=2,
                        warmup=1)
        lib = time_ms(sdpa(q, k, v, causal, W, S), reps=20, warmup=3)
        out = call()
        row(f"flash_attention ({name})",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:83", nf, ms, plain, lib,
            nbytes(q, k, v, out), {peak[0]: (4 * hd * pairs, peak[1]),
                                   "exponentials": (pairs, sfu)}, inst,
            case[:8])
        del q, k, v, out
        (q, k, v, out, dout), kw = bwd_inputs(case, dev)

        def bcall(q=q, k=k, v=v, out=out, dout=dout, kw=kw):
            return flash_attention.flash_attention_backward(q, k, v, out,
                                                            dout, **kw)

        ms = time_ms(bcall, reps=10, warmup=2)
        inst = flash_attention.LAST_BWD_INSTANCE
        plain = time_ms(lambda: ref.mha_backward_reference(
            q, k, v, out, None, dout, **kw), reps=2, warmup=1)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = sdpa(ql, kl, vl, causal, W, S)()
        lib = time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dout, retain_graph=True), reps=5,
            warmup=1)
        del lib_out, ql, kl, vl
        dq, dk, dv = bcall()
        row(f"flash_attention_backward ({name})",
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/models/layers.py:105", nb, ms, plain, lib,
            nbytes(q, k, v, out, dout, dq, dk, dv),
            {peak[0]: (10 * hd * pairs, peak[1]),
             "exponentials": (pairs, sfu)}, inst, case[:8])
        del q, k, v, out, dout, dq, dk, dv
        torch.cuda.empty_cache()
    from torch_kernel_inputs import ssm_inputs, torch_args
    args = torch_args(ssm_inputs(*SSM_TP, 33), dev)
    ms = time_ms(lambda: ssm_scan.ssm_scan(*args), reps=20, warmup=3)
    inst = ssm_scan.LAST_INSTANCE
    plain = time_ms(lambda: ref.ssm_scan_reference(*args), reps=2, warmup=1)
    y, h = ssm_scan.ssm_scan(*args)
    Bs, Ss, Dss, N = SSM_TP
    elems = Bs * Ss * Dss * N
    row("ssm_scan (1,600 channels)",
        "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "src/repro/kernels/ssm_scan.py:52", launches["ssm_scan"], ms, plain,
        None, nbytes(*args, y, h), {"f32 operations": (7 * elems,
                                                       PEAK_F32_OPS_S),
                                    "exponentials": (elems, sfu)}, inst,
        SSM_TP)
    bargs = ssm_bwd_inputs(*SSM_TP, dev)
    ms = time_ms(lambda: ssm_scan.ssm_scan_backward(*bargs), reps=10,
                 warmup=2)
    inst = ssm_scan.LAST_BWD_INSTANCE
    plain = time_ms(lambda: ref.ssm_scan_backward_reference(*bargs), reps=2,
                    warmup=1)
    outs = ssm_scan.ssm_scan_backward(*bargs)
    row("ssm_scan_backward (1,600 channels)",
        "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        "src/repro/models/ssm.py:76", launches["ssm_scan"] // 2, ms, plain,
        None, nbytes(*bargs, *outs), {"f32 operations": (16 * elems,
                                                         PEAK_F32_OPS_S),
                                      "exponentials": (elems, sfu)}, inst,
        SSM_TP)
    return entries


def tp_main_report(ranks, one, cfg) -> dict:
    """[tp-main]'s lines: llama3.2-1b cut to TP_LAYERS layers on (1, 2)
    (the two gloo ranks' ``out["tp"]``) and on (1, 1) (``one``): step time,
    tokens/s, peak memory a rank, the collectives of the instrumented
    step, the attention's launches at 16 of 32 query heads over 4 kv heads
    a rank (forward and recompute, and the backward, a layer a step); the
    (1, 2) losses within 5e-2 of (1, 1)'s and its peak below (1, 1)'s.
    Returns rank 0's launches of the attention at that shape a step."""
    tokens = TR_BATCH * TR_SEQ
    shape = FLASH_TP["llama tp rank"][:8]
    want = {"fwd": 2 * TP_LAYERS, "bwd": TP_LAYERS}
    for rk, o in enumerate(ranks):
        r = o["tp"]
        got = {k: r["shapes"][k].get(shape, 0) for k in ("fwd", "bwd")}
        if got != want or sum(r["shapes"]["fwd"].values()) != want["fwd"]:
            fail(f"tp-main: rank {rk} launched the attention "
                 f"{r['shapes']}, expected {want} at {shape}")
        for i, (a, b) in enumerate(zip(r["losses"], one["losses"])):
            if not (math.isfinite(a) and abs(a - b) <= 5e-2 * abs(b)):
                fail(f"tp-main: rank {rk} step {i} loss {a}, (1, 1) {b}")
    peaks = [o["tp"]["peak"] - o["tp"]["base"] for o in ranks]
    one_peak = one["peak"] - one["base"]
    if max(peaks) >= one_peak:
        fail(f"tp-main: peak a rank {peaks} on (1, 2), not below (1, 1)'s "
             f"{one_peak}")
    for name, runs in (("(1, 2)", [o["tp"] for o in ranks]), ("(1, 1)",
                                                             [one])):
        r = runs[0]
        med = statistics.median(r["walls"][1:])
        comm = [x["comm"] for x in runs]
        tw = [x["timed_wall"] for x in runs]
        log(f"[tp-main] {cfg.name} cut to {TP_LAYERS} of 16 layers at full "
            f"width, bf16, remat 'dots', mesh {name}"
            + (" over gloo (both ranks on card 0)" if name == "(1, 2)"
               else " over NCCL") + f", {TR_BATCH} x {TR_SEQ} tokens a "
            f"step, {TP_STEPS} steps: step time {med:.3f} s (median of "
            f"steps 2-{TP_STEPS}, rank 0; {[round(w, 3) for w in r['walls']]}"
            f"), {tokens / med:.0f} tokens/s; peak memory a rank "
            f"{[round((x['peak'] - x['base']) / 2**30, 2) for x in runs]} "
            f"GiB; one more step, instrumented: {comm[0]['bytes']} bytes "
            f"handed to {comm[0]['calls']} collectives a rank, the calls "
            f"{[round(c['s'], 3) for c in comm]} s, the waits "
            f"{[round(c['wait_s'], 3) for c in comm]} s of "
            f"{[round(w, 3) for w in tw]} s; losses "
            f"{[round(x, 4) for x in r['losses']]}; attention launches a "
            f"step by shape {r['shapes']['fwd']}, backward "
            f"{r['shapes']['bwd']}")
    gib = [round(p / 2**30, 2) for p in peaks]
    log(f"[tp-main] peak a rank on (1, 2) {gib} GiB, below (1, 1)'s "
        f"{one_peak / 2**30:.2f} GiB; the attention at 16/4 heads a rank: "
        f"{want['fwd']} forward and {want['bwd']} backward launches a step")
    return want


# --------------------------------------------------------------------------
# the decode layouts, in phase 8's two ranks and then on one rank over
# NCCL: [kvseq-parity], [ws-parity], [serve-tp-main], [ws-main]
# --------------------------------------------------------------------------

# [kvseq-parity]: llama3.2-1b cut to KV_PAR_LAYERS layers in float32 with
# KV_PAR_MAX_SEQ slots, prompts of each of KV_PAR_PROMPTS tokens (at 100,
# rank 1's slots 128-255 hold no written key through the decode steps),
# hymba-1.5b cut the same (its SSM channels a rank's half), and
# llama3.2-1b's 16 layers in float32 with KV_FULL_MAX_SEQ slots and
# prompts of KV_FULL_PROMPT tokens, so that both ranks hold written slots
# and the decode steps write on rank 1, all on (1, 2);
# [ws-parity]: moonshot cut to MOE_PAR_LAYERS layers in float32 on (2, 1)
# with serve_weights_stationary, WS_PAR_BATCH x WS_PAR_PROMPT tokens;
# [serve-tp-main]: llama3.2-1b's 16 layers in bf16 through
# ServeEngine.generate, [lm-main]'s traffic, decode_32k's cache length, on
# (1, 2) and then (1, 1), whose steps then run again fed (1, 2)'s tokens;
# [ws-main]: moonshot at full width cut to
# WS_LAYERS layers in bf16 on (2, 1), WS_BATCH x WS_PROMPT tokens, then
# WS_PLAIN_STEPS decode steps in the train layout and WS_STEPS in the
# weights-stationary one, in turns
KV_PAR_LAYERS, KV_PAR_BATCH, KV_PAR_MAX_SEQ, KV_PAR_NEW = 2, 2, 256, 4
KV_PAR_PROMPTS = (100, 200)
KV_FULL_BATCH, KV_FULL_MAX_SEQ, KV_FULL_PROMPT, KV_FULL_NEW = 2, 1024, 600, 8
WS_PAR_BATCH, WS_PAR_PROMPT, WS_PAR_NEW = 4, 128, 3
SERVE_TP_MAX_SEQ = 32768
WS_LAYERS, WS_BATCH, WS_PROMPT, WS_PLAIN_STEPS, WS_STEPS = 2, 4, 256, 2, 8
# [serve-tp-main]'s near-tie: (1, 1)'s logits of the two tokens within four
# bf16 steps (2^-8 each) of its largest, where bf16 logits cannot rank them
SERVE_TP_TIE = 2.0 ** -6


def seeded_tokens(cfg, B, S, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab, (B, S)))


def step_logits(cfg, params, mesh, toks, max_seq, new, dev, feed=None,
                calls=None):
    """make_prefill / make_serve_step(cfg, mesh) on ``toks`` into a cache
    of ``max_seq`` slots (this rank's blocks with a mesh), then ``new``
    decode steps, each fed ``feed``'s greedy token (None: its own): the
    logits of each call on the CPU, in float32.  ``calls`` (a list)
    receives each decode step's collectives (torch_spmd's
    ``record_collectives``)."""
    from repro_torch.models import transformer
    from repro_torch.train import step
    from torch_spmd import record_collectives
    B, S = toks.shape
    with torch.inference_mode():
        cache = transformer.init_cache(cfg, B, max_seq, device=dev, ctx=mesh)
        lg, cache = step.make_prefill(cfg, mesh)(params, toks.to(dev), cache)
        out = [lg.float().cpu()]
        decode = step.make_serve_step(cfg, mesh)
        for i in range(new):
            tok = (out[-1] if feed is None else feed[i]).argmax(-1)
            with record_collectives() as rec:
                lg, cache = decode(params, cache, tok[:, None].to(dev), S + i)
            if calls is not None:
                calls.append(rec)
            out.append(lg.float().cpu())
    return out, cache


def logits_err(tag, got, exp, tol) -> float:
    """The largest absolute difference of two runs' logits, call by call;
    ``fail`` past ``tol`` or on a non-finite value."""
    worst = 0.0
    for i, (g, e) in enumerate(zip(got, exp)):
        if not torch.isfinite(g).all():
            fail(f"{tag}: call {i} logits not finite")
        worst = max(worst, float((g - e).abs().max()))
    if worst > tol:
        fail(f"{tag}: logits differ from one rank's by {worst} (> {tol})")
    return worst


def state_gathers(calls, shapes) -> int:
    """All-gathers among recorded collectives whose tensor has one of
    ``shapes`` (a block, or the block with its gathered dim first)."""
    from torch_spmd import GATHERS
    return sum(1 for rec in calls for n, s, _ in rec
               if n in GATHERS and s in shapes)


def kvseq_parity_rank(rank, dev) -> dict:
    """[kvseq-parity] on this rank: llama3.2-1b and hymba-1.5b cut to
    KV_PAR_LAYERS layers, and llama3.2-1b at its full depth with both
    ranks' slots written (float32), on (1, 2) against the same calls on
    one rank (this rank computes them too): logits within 1e-3 and the
    same greedy token at every call, fed one rank's tokens; the same
    greedy tokens from ServeEngine(mesh=) as from one rank's engine (the
    cut cases); whether this rank holds a written slot after the decode
    steps, the cache's blocks, and hymba's decode steps gathering no SSM
    state."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    from torch_spmd import mesh_of
    m12 = mesh_of((1, 2), device=dev.type)
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    out = {}
    # (arch, layers (None: all), batch, slots, prompt lengths, new tokens,
    # the engines compared too)
    cases = ((TP_ARCH, KV_PAR_LAYERS, KV_PAR_BATCH, KV_PAR_MAX_SEQ,
              KV_PAR_PROMPTS, KV_PAR_NEW, True),
             (LM_ARCH, KV_PAR_LAYERS, KV_PAR_BATCH, KV_PAR_MAX_SEQ, (200,),
              KV_PAR_NEW, True),
             (TP_ARCH, None, KV_FULL_BATCH, KV_FULL_MAX_SEQ,
              (KV_FULL_PROMPT,), KV_FULL_NEW, False))
    for arch, layers, B, max_seq, prompts, new, engines in cases:
        cfg = configs.get_config(arch)
        cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                                  **f32)
        full = seeded_params(cfg, dev)
        blocks = step.shard_params(full, step.state_shardings(cfg, m12)[0][
            "params"])
        cache = transformer.init_cache(cfg, B, max_seq, device="meta",
                                       ctx=m12)
        for S in prompts:
            tag = f"kvseq-parity {cfg.name} {cfg.n_layers} layers {S} " \
                  f"rank {rank}"
            toks = seeded_tokens(cfg, B, S, S)
            ref, _ = step_logits(cfg, full, None, toks, max_seq, new, dev)
            calls = []
            ops.reset_launch_counts()
            got, got_cache = step_logits(cfg, blocks, m12, toks, max_seq,
                                         new, dev, feed=ref, calls=calls)
            launches = ops.launch_counts()
            err = logits_err(tag, got, ref, 1e-3)
            differ = [i for i, (g, r) in enumerate(zip(got, ref))
                      if not torch.equal(g.argmax(-1), r.argmax(-1))]
            if differ:
                fail(f"{tag}: greedy tokens differ from one rank's at calls "
                     f"{differ}")
            written = bool((got_cache[0]["pos_ids"] >= 0).any())
            del got_cache
            if engines:
                prompts_l = toks.tolist()
                one = [g.tokens for g in ServeEngine(
                    cfg, full, max_batch=B, max_seq=max_seq,
                    device=dev).generate(prompts_l, max_new=new)]
                sh = [g.tokens for g in ServeEngine(
                    cfg, blocks, max_batch=B, max_seq=max_seq, mesh=m12,
                    device=dev).generate(prompts_l, max_new=new)]
                if sh != one:
                    fail(f"{tag}: ServeEngine's greedy tokens differ from "
                         f"one rank's")
            c0 = cache[0]
            blk = {k: tuple(v.shape) for k, v in c0.items()
                   if isinstance(v, torch.Tensor)}
            if "ssm" in c0:
                blk |= {f"ssm.{k}": tuple(v.shape)
                        for k, v in c0["ssm"].items()}
            Dh = cfg.d_ssm // 2
            ssm_shapes = {(B, cfg.ssm_conv - 1, Dh), (B, Dh, cfg.ssm_state),
                          (Dh, B, cfg.ssm_conv - 1), (Dh, B, cfg.ssm_state)}
            out[f"{cfg.name} {cfg.n_layers} layers {S}"] = {
                "err": err, "launches": launches, "blocks": blk,
                "calls": [len(r) for r in calls], "written": written,
                "layers": cfg.n_layers, "batch": B, "slots": max_seq,
                "new": new, "engines": engines,
                "state_gathers": state_gathers(calls, ssm_shapes)
                if "ssm" in c0 else None}
        del full, blocks
        torch.cuda.empty_cache()
    return out


def ws_parity_rank(rank, dev) -> dict:
    """[ws-parity] on this rank: moonshot cut to MOE_PAR_LAYERS layers
    (float32) with serve_weights_stationary on (2, 1), its parameters
    under serve_rules (experts' "e_ff" halved), against one rank: logits
    within 1e-3 where no route differs (the route-flip rule), the
    collectives of each decode step, and no parameter gathered."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    from torch_kernel_inputs import recorded_routes, route_flips
    from torch_spmd import mesh_of
    m21 = mesh_of((2, 1), device=dev.type)
    cfg = dataclasses.replace(
        configs.get_config(MOE_ARCH), n_layers=MOE_PAR_LAYERS,
        param_dtype="float32", compute_dtype="float32",
        serve_weights_stationary=True)
    full = seeded_params(cfg, dev)
    toks = seeded_tokens(cfg, WS_PAR_BATCH, WS_PAR_PROMPT, 17)
    with recorded_routes(moe) as exp:
        ref, _ = step_logits(cfg, full, None, toks, LM_MAX_SEQ, WS_PAR_NEW,
                             dev)
    blocks = step.shard_params(full, step.serve_shardings(cfg, m21)[0][
        "params"])
    del full
    torch.cuda.empty_cache()
    taken = []

    def hook(event, key, tensors):
        taken.extend(tuple(t.shape) for t in tensors)
    spmd.ON_GATHER.append(hook)
    calls = []
    try:
        with recorded_routes(moe) as got_routes:
            got, _ = step_logits(cfg, blocks, m21, toks, LM_MAX_SEQ,
                                 WS_PAR_NEW, dev, feed=ref, calls=calls)
    finally:
        spmd.ON_GATHER.remove(hook)
    flips = route_flips(got_routes, exp)
    err = None if flips else logits_err(f"ws-parity rank {rank}", got, ref,
                                        1e-3)
    rows = WS_PAR_BATCH // 2
    from torch_spmd import GATHERS
    acts = {(rows, 1, cfg.d_model), (rows, cfg.vocab)}
    params_gathered = taken + [s for rec in calls for n, s, _ in rec
                               if n in GATHERS and s not in acts]
    if params_gathered:
        fail(f"ws-parity rank {rank}: parameters gathered {params_gathered}")
    ef = blocks["layers"][0]["ffn"]["wg"].shape
    del blocks
    torch.cuda.empty_cache()
    return {"err": err, "flips": flips, "calls": calls[0], "wg": tuple(ef)}


def serve_tp_main(cfg, mesh, dev, keep=True, forced=None) -> dict:
    """[serve-tp-main] on this rank: ``cfg`` (llama3.2-1b, bf16) through
    ServeEngine(mesh=).generate on [lm-main]'s traffic with decode_32k's
    cache length: first token and decode seconds, peak memory over the
    run, the cache's bytes a rank, the kernels' launches over the
    generate call, the generated tokens and, with ``keep``, the logits
    of every call (the prefill and each decode step, caught at the
    engine's steps).  ``forced`` (another run's logits a call): after
    generate, the same prompts' prefill and decode steps through the
    step functions, each step fed the greedy token of ``forced``'s call
    before it, and their logits ("forced")."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step
    base = torch.cuda.memory_allocated(dev)
    params = seeded_params(cfg, dev)
    if mesh is not None:
        params = step.shard_params(params, step.state_shardings(cfg, mesh)[
            0]["params"])
    torch.cuda.empty_cache()
    prompts = seeded_tokens(cfg, LM_BATCH, LM_PROMPT, 23).tolist()
    eng = ServeEngine(cfg, params, max_batch=LM_BATCH,
                      max_seq=SERVE_TP_MAX_SEQ, mesh=mesh, device=dev)
    seen = []
    for name in ("_prefill", "_decode"):
        inner = getattr(eng, name)

        def caught(*a, _inner=inner):
            lg, cache = _inner(*a)
            if keep:
                seen.append(lg.cpu())
            return lg, cache
        setattr(eng, name, caught)
    # the keys, values and their positions (not the slot ids a split
    # cache also holds)
    cache_bytes = sum(c[k].numel() * c[k].element_size()
                      for c in transformer.init_cache(
                          cfg, LM_BATCH, SERVE_TP_MAX_SEQ, device="meta",
                          ctx=mesh)
                      for k in ("k", "v", "pos_ids"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = eng.generate(prompts, max_new=LM_NEW)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    tm = eng.timings
    del eng
    torch.cuda.empty_cache()
    got = None
    if forced is not None:
        got, _ = step_logits(cfg, params, mesh, torch.tensor(prompts),
                             SERVE_TP_MAX_SEQ, len(forced) - 1, dev,
                             feed=forced)
    del params
    torch.cuda.empty_cache()
    return {"first_s": tm["first_token_s"],
            "decode_ms": 1e3 * tm["decode_s"] / max(tm["decode_steps"], 1),
            "steps": tm["decode_steps"], "peak": peak,
            "cache_bytes": cache_bytes, "launches": launches,
            "logits": seen, "forced": got,
            "tokens": [r.tokens[LM_PROMPT:] for r in res]}


def ws_main_rank(rank, dev) -> dict:
    """[ws-main] on this rank: moonshot at full width cut to WS_LAYERS
    layers (bf16) on (2, 1): the prompts' prefill in the weights-stationary
    layout, then decode steps in turns from the same cache: one in the
    train layout (its FSDP blocks gathered each step) and WS_STEPS /
    WS_PLAIN_STEPS in the weights-stationary one, WS_PLAIN_STEPS rounds;
    each step timed between card syncs, its collectives' bytes recorded,
    and each round's train-layout logits beside the first stationary
    step's, which takes the same cache and token."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train import step
    from torch_spmd import mesh_of, record_collectives
    m21 = mesh_of((2, 1), device=dev.type)
    ws = dataclasses.replace(configs.get_config(MOE_ARCH),
                             n_layers=WS_LAYERS, serve_weights_stationary=True)
    plain = dataclasses.replace(ws, serve_weights_stationary=False)
    full = seeded_params(ws, dev)
    train_b = step.shard_params(full, step.state_shardings(plain, m21)[0][
        "params"])
    ws_b = step.shard_params(full, step.serve_shardings(ws, m21)[0]["params"])
    del full
    torch.cuda.empty_cache()
    toks = seeded_tokens(ws, WS_BATCH, WS_PROMPT, 29).to(dev)
    steps = {"train layout": step.make_serve_step(plain, m21),
             "weights-stationary": step.make_serve_step(ws, m21)}
    out = {k: {"ms": [], "bytes": []} for k in steps}
    diffs = []
    with torch.inference_mode():
        cache = transformer.init_cache(ws, WS_BATCH, WS_PROMPT + WS_STEPS
                                       + WS_PLAIN_STEPS, device=dev, ctx=m21)
        lg, cache = step.make_prefill(ws, m21)(ws_b, toks, cache)
        pos = WS_PROMPT
        per_round = WS_STEPS // WS_PLAIN_STEPS
        for _ in range(WS_PLAIN_STEPS):
            tok = lg.argmax(-1)[:, None]
            runs = [("train layout", train_b)] + [("weights-stationary",
                                                   ws_b)] * per_round
            first = {}
            for i, (name, params) in enumerate(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with record_collectives() as rec:
                    lg_i, c_i = steps[name](params, cache, tok, pos)
                torch.cuda.synchronize()
                out[name]["ms"].append(1e3 * (time.perf_counter() - t0))
                out[name]["bytes"].append(sum(b for _, _, b in rec))
                if i < 2:
                    first[name] = lg_i.float()
                if name == "weights-stationary":
                    cache, lg = c_i, lg_i
                    pos += 1
                    tok = lg.argmax(-1)[:, None]
            diffs.append(float((first["train layout"]
                                - first["weights-stationary"]).abs().max()))
            if not all(torch.isfinite(t).all() for t in first.values()):
                fail(f"ws-main rank {rank}: non-finite logits")
    out["diffs"] = diffs
    del train_b, ws_b, cache
    torch.cuda.empty_cache()
    return out


def serve_rank(rank, dev) -> dict:
    """This slice's phases on one of phase 8's two gloo ranks: each
    returns what the main process reports, with its seconds."""
    from torch_spmd import mesh_of
    from repro_torch import configs
    out, secs = {}, {}
    for name, fn in (
            ("kvseq", lambda: kvseq_parity_rank(rank, dev)),
            ("ws", lambda: ws_parity_rank(rank, dev)),
            ("serve-tp", lambda: serve_tp_main(
                configs.get_config(TP_ARCH), mesh_of((1, 2), device=dev.type),
                dev, keep=rank == 0)),
            ("ws-main", lambda: ws_main_rank(rank, dev))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = round(time.perf_counter() - t0, 1)
    out["secs"] = secs
    return out


def serve_phases(ranks, dev) -> dict:
    """Report [kvseq-parity], [ws-parity], [serve-tp-main] and [ws-main]
    from the two gloo ranks' ``serve_rank`` results, after [serve-tp-main]
    on (1, 1) over NCCL in this process, which then runs the prompts'
    prefill and decode steps again fed (1, 2)'s tokens: (1, 2)'s logits
    at every call within the bf16 band of (1, 1)'s on the same tokens,
    its greedy token the same at every call but at a near-tie
    (SERVE_TP_TIE), the cache a rank half of (1, 1)'s.  Returns the kernels'
    launches in this slice's runs."""
    import torch.distributed as dist
    from repro_torch import configs
    from torch_spmd import mesh_of
    t0 = time.perf_counter()
    cfg = configs.get_config(TP_ARCH)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            one = serve_tp_main(
                cfg, mesh_of((1, 1), device=dev.type), dev, keep=False,
                forced=ranks[0]["serve"]["serve-tp"]["logits"])
        finally:
            dist.destroy_process_group()
    t_one = time.perf_counter() - t0
    for rk, o in enumerate(ranks):
        s = o["serve"]
        for case, r in s["kvseq"].items():
            kernel = "ssm_scan" if LM_ARCH[:5] in case else "flash_attention"
            if r["launches"][kernel] == 0:
                fail(f"kvseq-parity {case} rank {rk}: {kernel} never "
                     f"launched")
            extra = "" if r["state_gathers"] is None else \
                f"; SSM state all-gathers in the decode steps " \
                f"{r['state_gathers']}"
            if r["state_gathers"]:
                fail(f"kvseq-parity {case} rank {rk}: a decode step gathered "
                     f"the SSM state")
            log(f"[kvseq-parity] {case} tokens f32, B={r['batch']}, "
                f"{r['slots']} slots, (1, 2) rank {rk} (gloo): logits of the "
                f"prefill and {r['new']} decode steps within {r['err']:.3g} "
                f"of one rank's (limit 1e-3), the same greedy token at every "
                f"call" + (", ServeEngine(mesh=)'s tokens == one rank's"
                           if r["engines"] else "")
                + f"; this rank holds {'a' if r['written'] else 'no'} "
                f"written slot after the decode steps; layer 0's blocks "
                f"{r['blocks']}; collectives a decode step {r['calls']}; "
                f"launches {r['launches']}{extra}")
        # the trap (rank 1 with no written slot at 100 tokens) and its
        # opposite (both ranks written at full depth) did occur
        full = [c for c in s["kvseq"] if c.startswith(
            f"{cfg.name} {cfg.n_layers} layers")]
        if not full or not all(s["kvseq"][c]["written"] for c in full):
            fail(f"kvseq-parity rank {rk}: the full-depth case left this "
                 f"rank without a written slot")
        short = f"{cfg.name} {KV_PAR_LAYERS} layers {KV_PAR_PROMPTS[0]}"
        if rk == 1 and s["kvseq"][short]["written"]:
            fail(f"kvseq-parity: rank 1 holds a written slot in {short}")
        w = s["ws"]
        counts = {}
        for n, _, b in w["calls"]:
            c, by = counts.get(n, (0, 0))
            counts[n] = (c + 1, by + b)
        log(f"[ws-parity] {MOE_ARCH} {MOE_PAR_LAYERS} layers f32, "
            f"serve_weights_stationary, (2, 1) rank {rk} (gloo), "
            f"{WS_PAR_BATCH} x {WS_PAR_PROMPT} tokens, {WS_PAR_NEW} decode "
            f"steps: " + (f"logits within {w['err']:.3g} of one rank's "
                          f"(limit 1e-3), routes equal" if w["err"] is not None
                          else "routes differ only at near-ties: "
                          + flip_note(w["flips"], MOE_PAR_LAYERS)
                          + "; logits not compared")
            + f"; the experts' wg block {w['wg']}; a decode step's "
            f"collectives (calls, bytes handed in) {counts}; no parameter "
            f"all-gathered")
    r12 = [o["serve"]["serve-tp"] for o in ranks]
    if r12[1]["tokens"] != r12[0]["tokens"]:
        fail("serve-tp-main: the two ranks generated different tokens")
    got, ref = r12[0]["logits"], one["forced"]
    if not len(got) == len(ref) == LM_NEW:
        fail(f"serve-tp-main: {len(got)} and {len(ref)} calls' logits, not "
             f"{LM_NEW}")
    errs, flips = [], []
    for i, (g, e) in enumerate(zip(got, ref)):
        g = g.float()
        if not (torch.isfinite(g).all() and torch.isfinite(e).all()):
            fail(f"serve-tp-main: call {i} logits not finite")
        top = float(e.abs().max())
        errs.append(float((g - e).abs().max()) / top)
        a12, a11 = g.argmax(-1), e.argmax(-1)
        for row in (a12 != a11).nonzero().flatten().tolist():
            flips.append((i, row, float(e[row, a11[row]] - e[row, a12[row]])
                          / top))
    if max(errs) > 5e-2:
        fail(f"serve-tp-main: (1, 2)'s logits differ from (1, 1)'s on the "
             f"same tokens by {max(errs)} of the largest at call "
             f"{errs.index(max(errs))} (limit 5e-2)")
    if any(m > SERVE_TP_TIE for _, _, m in flips):
        fail(f"serve-tp-main: greedy tokens differ from (1, 1)'s on the same "
             f"tokens away from a near-tie (call, row, margin of the "
             f"largest; limit {SERVE_TP_TIE}): {flips}")
    free = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
            for x, y in zip(r12[0]["tokens"], one["tokens"])]
    for r in r12 + [one]:
        if r["launches"]["flash_attention"] == 0:
            fail("serve-tp-main: flash_attention never launched")
        if r is not one and r["cache_bytes"] * 2 != one["cache_bytes"]:
            fail(f"serve-tp-main: cache a rank {r['cache_bytes']} bytes, not "
                 f"half of (1, 1)'s {one['cache_bytes']}")
    for name, runs in (("(1, 2) over gloo (both ranks on card 0)", r12),
                       ("(1, 1) over NCCL", [one])):
        r = runs[0]
        log(f"[serve-tp-main] {cfg.name} (16 layers, bf16), "
            f"ServeEngine.generate {LM_BATCH} x {LM_PROMPT} tokens, {LM_NEW} "
            f"new, greedy, {SERVE_TP_MAX_SEQ} slots, mesh {name}: first "
            f"token {[round(1e3 * x['first_s'], 1) for x in runs]} ms, decode "
            f"{[round(x['decode_ms'], 2) for x in runs]} ms a step "
            f"({r['steps']} steps), peak a rank "
            f"{[round(x['peak'] / 2**30, 2) for x in runs]} GiB, cache a "
            f"rank {r['cache_bytes'] / 2**30:.3f} GiB; launches {r['launches']}")
    log(f"[serve-tp-main] (1, 2)'s logits at each of the {LM_NEW} calls "
        f"against (1, 1)'s fed the same tokens: within {max(errs):.3g} of "
        f"(1, 1)'s largest (prefill {errs[0]:.3g}, decode steps "
        f"{max(errs[1:]):.3g}; limit 5e-2); the greedy token the same in "
        f"{LM_NEW * LM_BATCH - len(flips)} of {LM_NEW * LM_BATCH} "
        f"(call, row) pairs" + ("" if not flips else
                                f", the others near-ties (call, row, margin "
                                f"of the largest; limit {SERVE_TP_TIE}) "
                                f"{[(i, j, round(m, 4)) for i, j, m in flips]}")
        + f"; rank 1's tokens == rank 0's; free-running, (1, 1)'s generate "
        f"first departs from (1, 2)'s at step {free} of each row (None: "
        f"never)")
    for rk, o in enumerate(ranks):
        m = o["serve"]["ws-main"]
        log(f"[ws-main] {MOE_ARCH} at full width cut to {WS_LAYERS} layers, "
            f"bf16, (2, 1) rank {rk} (gloo), {WS_BATCH} x {WS_PROMPT} "
            f"tokens: decode steps in turns from the same cache, "
            + "; ".join(f"{k}: {len(v['ms'])} steps "
                        f"{[round(x, 1) for x in v['ms']]} ms (median "
                        f"{statistics.median(v['ms']):.1f}), "
                        f"{statistics.median(v['bytes']) / 2**20:.2f} MiB "
                        f"handed to collectives a step"
                        for k, v in m.items() if k != "diffs")
            + f"; the two layouts' logits on the same cache and token "
              f"differ by at most {[round(d, 4) for d in m['diffs']]}")
    log(f"[serve] the ranks' seconds {[o['serve']['secs'] for o in ranks]}; "
        f"(1, 1) [serve-tp-main] {t_one:.1f} s")
    return {"serve-tp (1, 2)": [r["launches"] for r in r12],
            "serve-tp (1, 1)": one["launches"],
            "kvseq": [{c: r["launches"] for c, r in o["serve"]["kvseq"].items()}
                      for o in ranks]}


# --------------------------------------------------------------------------

def main() -> None:
    t_start = T_START
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs "
             "an NVIDIA GPU")
    global CPU_SIDES
    CPU_SIDES = CpuSides()
    dryrun_proc = start_dryrun_main()
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
    # the serving main runs' shapes: moonshot's, the encoder-decoder's and
    # chameleon's
    serving_errs = {name: check_flash(case, dev)[2]
                    for name, case in FLASH_SERVING.items()}
    flash_row_controls(dev)
    ss_main, ss_err = check_ssm(*SSM_MAIN, dev)
    for case in SSM_RAGGED + SSM_EDGES:
        ss_err = max(ss_err, check_ssm(*case, dev)[1])
    # the backward kernels (training)
    fb_err = check_flash_bwd(FLASH_BWD_MAIN, dev)
    fb_errs = {}
    for case in FLASH_BWD_CASES + [c + ("bfloat16",) for c in FLASH_TC_EDGES]:
        fb_errs[case] = check_flash_bwd(case, dev)
    fb_errs = {"flash_attention_backward": max(fb_err, *fb_errs.values()),
               "flash_attention_backward (hd 128)":
                   fb_errs[FLASH_BWD_HD128]}
    sb_err = check_ssm_bwd(*SSM_BWD_MAIN, dev)
    for case in SSM_BWD_CASES + SSM_EDGES[:4]:
        for with_dh in (False, True):
            sb_err = max(sb_err, check_ssm_bwd(*case, dev, with_dh=with_dh))
    # the tensor-parallel ranks' shapes ([tp-main], [mesh-parity])
    tp_errs = {}
    for name, case in FLASH_TP.items():
        tp_errs[f"flash_attention ({name})"] = check_flash(case, dev)[2]
        tp_errs[f"flash_attention_backward ({name})"] = \
            check_flash_bwd(case, dev)
    tp_errs["ssm_scan (1,600 channels)"] = check_ssm(*SSM_TP, dev)[1]
    tp_errs["ssm_scan_backward (1,600 channels)"] = check_ssm_bwd(*SSM_TP,
                                                                  dev)
    torch.cuda.empty_cache()
    mc_err = mc_kernels(dev)

    log(f"[elapsed] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
    # phase 4: card vs CPU
    from repro_torch.core.types import TraceKind
    n_d = CASE_D_PAR_JOBS
    parity_case(f"[parity] one_farm n512 j{FARM_PAR_JOBS}", dev)
    # the vectorized card runs [scalar-parity] holds the scalar loops to
    vec = {"dag_chain": parity_case("[parity] dag_chain SINGLE_TIMER", dev)}
    for pol in ("ROUND_ROBIN", "NETWORK_AWARE"):
        g = parity_case(f"[net-parity] case D fat_tree k=4 {pol} {n_d} jobs",
                        dev)
        if pol == "ROUND_ROBIN":
            vec["case_d_rr"] = g
            if not {TraceKind.FLOW_SPAWN, TraceKind.FLOW_FINISH} <= set(
                    g.trace.buf[:int(g.trace.ptr), 0].int().tolist()):
                fail("net-parity: the traced case D run recorded no flows")
    g = parity_case("[net-parity] star max_flows=2", dev)
    if int(g.flows.flows_dropped) == 0:
        fail("net-parity: the star with two flow slots dropped no flow")
    vec["star"] = g
    g = parity_case(f"[thermal-parity] thermal main config n512 "
                    f"j{TH_PAR_JOBS}", dev)
    if not (float(g.thermal.throttle_seconds.sum()) > 0
            and int(g.thermal.defer_count) > 0):
        fail("thermal-parity: the main configuration at 512 servers did "
             "not both throttle and defer")
    if not {TraceKind.THROTTLE_CROSSING, TraceKind.RELEASE,
            TraceKind.CTRL_TICK} <= set(
            g.trace.buf[:int(g.trace.ptr), 0].int().tolist()):
        fail("thermal-parity: the traced run recorded no crossing, release "
             "or controller tick")
    g = parity_case("[thermal-parity] thermal_case THERMAL_AWARE guard 500 "
                    "jobs", dev)
    if not float(g.thermal.throttle_seconds.sum()) > 0:
        fail("thermal-parity: thermal_case's guard never throttled")
    from repro_torch.kernels import dcsim_step
    parity_case(f"[thermal-parity] one_farm n512 j{FARM_PAR_JOBS} float64 "
                f"clock", dev)
    f64_launches = dcsim_step.CLOCK_LAUNCHES["float64"]
    for cap in (65536, 64):
        g = parity_case(f"[trace-parity] rich scenario capacity {cap}", dev,
                        ring_exact=True)
        if (int(g.trace.dropped) > 0) != (cap == 64):
            fail(f"trace-parity: {int(g.trace.dropped)} records dropped at "
                 f"capacity {cap}")
    for name in MC_PARITY:
        g = mc_parity(name, dev)
        if name == "replicas_r3":
            vec[name] = g
    log(f"[elapsed] [scalar-parity] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    scalar_parity(dev, vec)
    del vec
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
    log(f"[elapsed] [scalar-main] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    sc_counts = scalar_main(dev, res)
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
         "thermal_launches": th_counts[name],
         "scalar_launches": sc_counts[name]}
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
                            f"run, {k['scalar_launches']} in the scalar "
                            f"main run")
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

    # [roofline]: the attention's share by ablation on [lm-main]'s weights;
    # the dry run of [train-main]'s work, traced in a subprocess since the
    # script started
    t_roof = time.perf_counter()
    log(f"[elapsed] [roofline] starts at {t_roof - t_start:.1f} s")
    fa_ms = next(k["ms"] for k in kernels if k["name"] == "flash_attention")
    roof_launches = skip_attn(dev, lm_cfg, lm_params, lm_toks, fa_ms)
    dryrun_cell = finish_dryrun_main(dryrun_proc)
    for k in kernels:
        if k["name"] in ("flash_attention", "ssm_scan"):
            k["skip_attn_launches"] = {n: c[k["name"]]
                                       for n, c in roof_launches.items()}
    log(f"[roofline] phase took {time.perf_counter() - t_roof:.1f} s")

    # MoE serving, after hymba's weights are freed: moonshot's 57.8 GB of
    # weights leave room for little else
    del lm_params, lm_toks
    torch.cuda.empty_cache()

    # training, on the freed card: the parity run (its CPU steps, in the
    # worker since the script started, are ready by now), the main run,
    # then both backward kernels timed at its shapes
    log(f"[elapsed] [train-parity] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    train_parity(dev)
    log(f"[elapsed] [train-main] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    tr = train_main(dev)
    check_dryrun_main(dryrun_cell, tr)
    t_entries = time.perf_counter()
    tr_entries, tr_split = train_kernel_entries(tr["launches"], fb_errs,
                                                sb_err, dev)
    for k in tr_entries:
        log(f"[time] {k['name']} ({k['instance']}) at "
            f"{tuple(k['shape'])}: {k['ms'] * 1e3:.1f} us per call on the "
            f"stream, {k['device_ms'] * 1e3:.1f} us of device time (events "
            f"around 20 calls; {k['graph_ops']} kernels a call: "
            + ", ".join(f"{n} {t:.1f} us" for n, t in
                        tr_split[k['name']].items())
            + f"); bound {k['bound_ms'] * 1e3:.3f} us by {k['bound_op']}; "
            f"plain version {k['plain_ms'] * 1e3:.1f} us"
            + ("" if k["library_ms"] is None else
               f"; SDPA's backward ({k['library_call']}) "
               f"{k['library_ms'] * 1e3:.1f} us, the kernel "
               f"{k['ms'] / k['library_ms']:.2f}x its time")
            + f"; {k['launches']} launches a step of [train-main]")
    log(f"[time] the backward kernels' timings took "
        f"{time.perf_counter() - t_entries:.1f} s")
    kernels += tr_entries
    torch.cuda.empty_cache()
    log(f"[elapsed] [moe-layer] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    moe_layer(dev)
    log(f"[elapsed] [moe-parity] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    moe_parity(dev)
    log(f"[elapsed] [moe-main] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    moe_fa_launches = moe_main(dev)

    # recurrent serving: the xLSTM mixers and the mamba block kind
    log(f"[elapsed] [xlstm-parity] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    mamba_scans = xlstm_parity(dev)
    for k in kernels:
        if k["name"] == "ssm_scan":
            k["mamba_launches"] = mamba_scans
    log(f"[elapsed] [xlstm-main] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    xlstm_main(dev)

    # the encoder-decoder, then the VQ-token front end (chameleon's 63.9
    # GiB of weights leave room for little else)
    log(f"[elapsed] [whisper-parity] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    whisper_parity(dev)
    log(f"[elapsed] [whisper-main] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    serving_launches = whisper_main(dev)
    serving_launches["hd 128"] = moe_fa_launches
    log(f"[elapsed] [vlm-main] starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    serving_launches["chameleon prefill"] = vlm_main(dev)
    kernels += serving_flash_entries(serving_errs, serving_launches, dev)

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

    # the mesh side of training and the launcher, after the rack-sharded
    # runs' process groups: [launch-train] runs with none, then its own
    log(f"[elapsed] phase 8 starts at {time.perf_counter() - t_start:.1f} s")
    mesh_counts = mesh_phases(dev)
    for k in kernels:
        if k["name"] in ("flash_attention", "ssm_scan",
                         "flash_attention_backward", "ssm_scan_backward"):
            k["mesh_launches"] = {
                "launch-train": mesh_counts["launch-train"].get(k["name"], 0),
                "mesh-parity": {case: [c[k["name"]] for c in steps]
                                for case, steps in
                                mesh_counts["mesh-parity"].items()},
                "mesh-main": mesh_counts["mesh-main"][k["name"]]}
            log(f"[mesh] {k['name']}: {k['mesh_launches']}")
    # this slice's path: the sequence-sharded prefill ([serve-tp-main], the
    # attention) and the SSM's channels kept ([kvseq-parity] hymba, the scan)
    sv = mesh_counts["serve"]
    for k in kernels:
        if k["name"] == "flash_attention":
            k["serve_tp_launches"] = {
                "(1, 2)": [c["flash_attention"] for c in sv["serve-tp (1, 2)"]],
                "(1, 1)": sv["serve-tp (1, 1)"]["flash_attention"]}
        if k["name"] in ("flash_attention", "ssm_scan"):
            k["kvseq_launches"] = [{case: c[k["name"]] for case, c in r.items()}
                                   for r in sv["kvseq"]]
            log(f"[serve] {k['name']}: "
                f"{k.get('serve_tp_launches', '')} {k['kvseq_launches']}")
    kernels += tp_kernel_entries(tp_errs, mesh_counts["tp"], dev)

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
    elif sys.argv[1:2] == ["--cpu-sides"] and len(sys.argv) == 3:
        cpu_sides_worker(sys.argv[2])
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--engine-calls ROOT]")
    else:
        main()
