"""End-to-end training launcher with fault tolerance (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

On one rank (no process group) the state lives whole on ``--device``
(the card unless asked for the CPU).  Under ``torchrun`` (or
``core.shard_sim.spawn``), with the default process group initialised by
the caller, the mesh is ``make_local_mesh(--data, --model)`` over its
ranks: each rank keeps its blocks of the state
(``train.step.shard_state``), draws the same global batch and runs the
sharded step; rank 0 writes the checkpoints, every rank restores.

Fault-tolerance posture, as the reference's:
  * atomic+async checkpoints every --ckpt-every steps (Checkpointer)
  * SIGTERM/SIGINT -> final checkpoint, clean exit (preemption survival)
  * resume: --resume picks up the latest step; the data pipeline is a pure
    function of step, so batches replay exactly (skip-ahead, no data state)
  * checkpoint cadence can be derived from a fleet MTBF via Young/Daly
    (--mtbf / --ckpt-cost) instead of a fixed interval
  * step watchdog: a step exceeding --step-timeout-s aborts with a
    checkpoint and exit code 42 (straggler/hang mitigation: on a real
    fleet the launcher restarts the job on healthy nodes)
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import configs
from ..ckpt.checkpoint import Checkpointer
from ..core.montecarlo import young_daly_interval
from ..core.types import resolve_device
from ..data.pipeline import DataConfig, get_batch
from ..train import optim, step as step_lib
from .mesh import make_local_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mtbf", type=float, default=0.0,
                    help="fleet MTBF seconds -> Young/Daly cadence")
    ap.add_argument("--ckpt-cost", type=float, default=5.0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--step-timeout-s", type=float, default=0.0)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    cfg = dataclasses.replace(cfg, microbatches=1)
    dev = resolve_device(args.device)
    mesh = make_local_mesh(args.data, args.model, dev) \
        if dist.is_initialized() else None
    multi = mesh is not None and mesh.size() > 1

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed)
    opt_cfg = optim.AdamWConfig(lr=args.lr, total_steps=args.steps)
    train_step = step_lib.make_train_step(cfg, mesh if multi else None,
                                          opt_cfg=opt_cfg)

    state = step_lib.init_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    shardings = None
    if multi:
        shardings, _ = step_lib.state_shardings(cfg, mesh)
        state = step_lib.shard_state(state, shardings)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, start = ckpt.restore(state, shardings=shardings)
        print(f"resumed from step {start}")

    every = args.ckpt_every
    if args.mtbf > 0:
        # steps-per-checkpoint from Young/Daly given measured step time
        every = max(1, int(young_daly_interval(args.mtbf, args.ckpt_cost)))
        print(f"Young/Daly cadence: checkpoint every ~{every}s of compute")

    stop = {"flag": False}

    def on_term(signum, frame):
        stop["flag"] = True
    saved = {s: signal.signal(s, on_term)
             for s in (signal.SIGTERM, signal.SIGINT)}

    def save(at, blocking):
        ckpt.save(state, at, blocking=blocking, shardings=shardings)

    losses = []
    try:
        for step in range(start, args.steps):
            batch = get_batch(dc, step, device=dev)
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            late = bool(args.step_timeout_s and dt > args.step_timeout_s)
            if multi:           # every rank stops at the same step
                flags = torch.tensor([late, stop["flag"]], dtype=torch.int32,
                                     device=dev)
                dist.all_reduce(flags, op=dist.ReduceOp.MAX)
                late, stop["flag"] = (bool(f) for f in flags.tolist())
            if late:
                print(f"WATCHDOG: step {step} took {dt:.1f}s "
                      f"> {args.step_timeout_s}s; checkpoint + abort")
                if ckpt:
                    save(step + 1, True)
                return 42
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            if ckpt and (step + 1) % every == 0:
                save(step + 1, False)
            if stop["flag"]:
                print(f"SIGTERM at step {step}: checkpointing and exiting")
                if ckpt:
                    save(step + 1, True)
                return 0
        if ckpt:
            save(args.steps, True)
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
        if ckpt:
            ckpt.wait()

    if len(losses) >= 20:
        a = float(np.mean(losses[:5]))
        b = float(np.mean(losses[-5:]))
        print(f"loss first5={a:.4f} last5={b:.4f} "
              f"({'DECREASED' if b < a else 'no decrease'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
