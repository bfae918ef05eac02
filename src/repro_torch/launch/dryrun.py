"""Multi-pod dry run of the port (port of ``repro.launch.dryrun``): show
that every (architecture x input shape x mesh) cell of the port's train,
prefill and decode steps traces on rank 0 of the reference's 16 x 16 pod
and 2 x 16 x 16 two-pod meshes, and take the per-device operations,
bytes, collective bytes and memory for the roofline
(``roofline/analysis.py``).  Host only: nothing runs on a card.

The reference lowers and compiles each cell's SPMD module for 512 fake
devices.  The port's program is one process a rank, so "lowers and
compiles" becomes "traces on rank 0": the process joins a fake process
group (``torch.testing._internal.distributed.fake_pg``; world size 512,
so both meshes fit), builds ``launch.mesh.make_production_mesh`` and runs
the port's own ``make_train_step(cfg, mesh)`` / ``make_prefill`` /
``make_serve_step`` once under ``FakeTensorMode`` and
``analysis.graph_audit.record``.  Every tensor is fake: the state is rank
0's blocks (``train.step.state_shardings``; ``partition.serve_rules`` for
a weights-stationary decode, as the reference's, and for its prefill,
whose parameters the port's steps take in the same layout: there the
port's cell departs from the reference's, which gives a flagged prefill
the train layout), the inputs
the global batch every rank takes, the cache rank 0's blocks (its rows,
an attn layer's slots and the SSM's channels,
``transformer.init_cache(..., ctx=)``).  The tensors lie on
``cuda`` where the torch build has CUDA, so the kernels' fake
implementations (``kernels/ops.py``) stand where the card runs the
kernels and the recording is the card's graph; a build without CUDA
cannot run autograd on fake CUDA tensors, and there they lie on ``meta``
in the same graph (``fake_device``).  Collectives on the fake group
return at once and move nothing.

Each cell runs three traces: the full-depth step (the proof that it
traces, and the peak of live bytes on rank 0, ``analysis.LiveBytes``)
and two depth probes of 1 and 2 pattern periods, whose counts
``analysis.collect`` extrapolates to full depth.  A configuration with sLSTM blocks outside decode (a Python
loop of about 20 ops a position a layer) skips the full-depth trace:
its memory is extrapolated from the probes' peaks as well
(``memory["from"]``).

The fake process group and its world size must not reach other code, so
callers that are not this module's ``main`` (``chip_smoke.py``, the
tests) run it as a subprocess:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --out results/dryrun
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist

from .. import configs
from ..analysis import graph_audit
from ..models import layers, transformer
from ..models.config import SHAPES, ModelConfig, ShapeSpec, supported_shapes
from ..roofline import analysis
from ..sharding import partition, spmd
from ..train import step as step_lib
from .mesh import make_production_mesh

# the two production meshes' ranks
WORLD = 512


def init_fake(world: int = WORLD) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (once a
    process)."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_device() -> str:
    """The fake tensors' device: ``cuda`` where the torch build has CUDA,
    else ``meta`` (the same graph; see the module's note)."""
    return "cuda" if torch.backends.cuda.is_built() \
        and torch.cuda.is_available() else "meta"


_MODE = []


def fake_mode():
    """The process's one ``FakeTensorMode``: fake tensors of two modes do
    not mix, and the model caches small tensors across calls (the rotary
    frequencies, ``models/layers.py``)."""
    if not _MODE:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _MODE.append(FakeTensorMode())
    return _MODE[0]


def _shape(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


# --------------------------------------------------------------------------
# inputs, caches and state (fake tensors; call under FakeTensorMode)
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape, device=None) -> dict:
    """The global inputs of one (arch, shape) cell, every rank's
    (the port's steps take the global batch and keep their rows):

    train:   {"tokens", "labels"} (B, S) int32 (+ "frames" for enc-dec,
             "modality_mask" for VQ tokens, which the step does not take)
    prefill: {"tokens"} (+ "frames")
    decode:  {"token" (B, 1), "pos"} (pos a Python int, the last slot).
    """
    shp = _shape(shape)
    dev = device or fake_device()
    B, S = shp.global_batch, shp.seq_len
    tok = torch.zeros((B, S), dtype=torch.int32, device=dev)

    def frames():
        return torch.zeros((B, cfg.enc_seq, cfg.d_model),
                           dtype=torch.bfloat16, device=dev)
    if shp.kind == "train":
        out = {"tokens": tok, "labels": tok.clone()}
        if cfg.is_enc_dec:
            out["frames"] = frames()
        if cfg.frontend == "vq_tokens":
            out["modality_mask"] = tok.clone()
        return out
    if shp.kind == "prefill":
        out = {"tokens": tok}
        if cfg.is_enc_dec:
            out["frames"] = frames()
        return out
    if shp.kind == "decode":
        return {"token": torch.zeros((B, 1), dtype=torch.int32, device=dev),
                "pos": S - 1}
    raise ValueError(shp.kind)


def cache_specs(cfg: ModelConfig, shape, mesh, device=None) -> list:
    """Rank 0's blocks of the cell's decode cache under
    ``transformer.cache_specs``: its rows, its slots of a full cache and
    its channels of the SSM state over "model" (``init_cache`` with the
    mesh)."""
    shp = _shape(shape)
    return transformer.init_cache(cfg, shp.global_batch, shp.seq_len,
                                  device=device or fake_device(),
                                  ctx=spmd.Ctx.of(mesh))


def state_specs(cfg: ModelConfig, mesh, max_seq: int = 0, rules=None,
                device=None) -> dict:
    """Rank 0's blocks of the train state (``step.state_shardings`` under
    ``rules``), as fake tensors in ``step.init_state``'s layout."""
    dev = device or fake_device()
    sh, shapes = step_lib.state_shardings(cfg, mesh, max_seq, rules)
    ctx = spmd.Ctx.of(mesh)

    def blk(t, s):
        shape = spmd.block(torch.empty(t.shape, device="meta"), s.spec,
                           ctx).shape
        return torch.empty(shape, dtype=t.dtype, device=dev)
    params = transformer.params_from_named(
        {n: blk(t, sh["params"][n]) for n, t in shapes["params"].items()})
    opt = {k: {n: blk(t, sh["opt"][k][n])
               for n, t in shapes["opt"][k].items()} for k in ("m", "v")}
    return step_lib.train_state(params, opt,
                                torch.zeros((), dtype=torch.int32, device=dev))


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------

def _lower_one(cfg: ModelConfig, shp: ShapeSpec, mesh, device=None):
    """(fn, args, the state's tensors) of the cell's step on rank 0's fake
    blocks, ready to trace."""
    max_seq = shp.seq_len if cfg.pos == "learned" else 0
    rules = None
    if shp.kind in ("prefill", "decode") and cfg.serve_weights_stationary:
        rules = partition.serve_rules(mesh)
    state = state_specs(cfg, mesh, max_seq, rules, device)
    ins = input_specs(cfg, shp, device)
    if shp.kind == "train":
        fn = step_lib.make_train_step(cfg, mesh)
        batch = {k: v for k, v in ins.items() if k != "modality_mask"}
        return fn, (state, batch), state
    params = state["params"]
    for p in params.parameters():
        p.requires_grad_(False)
    cache = cache_specs(cfg, shp, mesh, device)
    if shp.kind == "prefill":
        fn = step_lib.make_prefill(cfg, mesh)
        args = (params, ins["tokens"], cache) \
            + ((ins["frames"],) if "frames" in ins else ())
        return fn, args, params
    fn = step_lib.make_serve_step(cfg, mesh)
    return fn, (params, cache, ins["token"], ins["pos"]), params


def _trace(cfg, shp, mesh, device):
    """Trace the cell's step once on fake tensors: (raw_stats, {"peak_bytes",
    "state_bytes", "input_bytes"}, host seconds making the state and
    inputs, host seconds tracing)."""
    # every trace a cold step: the tables made once a process count once
    # in each trace alike
    layers.clear_tables()
    with fake_mode():
        t0 = time.perf_counter()
        fn, args, state = _lower_one(cfg, shp, mesh, device)
        t_setup = time.perf_counter() - t0
        mem = analysis.LiveBytes()
        state_bytes = mem.add(state)
        input_bytes = mem.add(args)
        t0 = time.perf_counter()
        with torch.enable_grad() if shp.kind == "train" \
                else torch.no_grad(), mem:
            inv = graph_audit.record(fn, *args)
            inv.result = None
            stats = analysis.raw_stats(inv)
            del inv
        t_trace = time.perf_counter() - t0
        del fn, args, state
    return stats, {"peak_bytes": mem.peak, "state_bytes": state_bytes,
                   "input_bytes": input_bytes}, t_setup, t_trace


def _probe_cfg(cfg: ModelConfig, k: int) -> ModelConfig:
    """The depth probe of k pattern periods.  The reference's probes also
    turn off the layer scan, microbatches and the query chunks, loops
    whose bodies XLA counts once; the port's trace counts every
    iteration of its Python loops, so its probes keep them, and with
    them the step's own memory."""
    return dataclasses.replace(cfg, n_layers=k * cfg.period,
                               enc_layers=k if cfg.is_enc_dec else 0)


def full_depth_is_slow(cfg: ModelConfig, shp: ShapeSpec) -> bool:
    """An sLSTM block outside decode: a Python loop over the positions."""
    return "slstm" in cfg.block_pattern and shp.kind != "decode"


def lower_cell(arch: str, shape, mesh, *, overrides=None,
               probe=True) -> dict:
    """Trace one (arch, shape, mesh) cell on rank 0 (``shape`` a name of
    ``SHAPES`` or a ``ShapeSpec``).

    Three traces: the full-depth step (traces, and its peak of live
    bytes) and two unrolled depth probes of 1 and 2 pattern periods,
    whose counts are depth-extrapolated (see the module's note).
    """
    cfg = configs.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shp = _shape(shape)
    dev = fake_device()
    pstats, pmems, t_probes = [], [], 0.0
    if probe:
        for k in (1, 2):
            st, mem, _, t = _trace(_probe_cfg(cfg, k), shp, mesh, dev)
            pstats.append(st)
            pmems.append(mem)
            t_probes += t
    if full_depth_is_slow(cfg, shp) and probe:
        stats, t_lower, t_compile = None, 0.0, 0.0
        memory = {k: pmems[0][k] + (cfg.n_periods - 1) * max(
            pmems[1][k] - pmems[0][k], 0) for k in pmems[0]}
        memory["from"] = "probes, extrapolated"
    else:
        stats, memory, t_lower, t_compile = _trace(cfg, shp, mesh, dev)
        memory["from"] = "full-depth trace"
    out = analysis.collect(
        cfg, shp, partition.mesh_sizes(mesh), stats, memory,
        t_lower=t_lower, t_compile=t_compile,
        probes=tuple(pstats) if probe else None)
    out.update(t_probes=t_probes, fake_device=dev,
               counts_from="probes (1 and 2 periods), extrapolated"
               if probe else "full-depth trace")
    return out


def run_cells(archs, shapes, meshes, out_dir=None, overrides=None,
              tag=""):
    results = []
    for mesh_name in meshes:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                    device="cuda")
        for arch in archs:
            cfg = configs.get_config(arch)
            names = [s.name for s in supported_shapes(cfg)]
            for shape_name in shapes:
                if shape_name not in names:
                    print(f"SKIP {arch} {shape_name} ({mesh_name}): "
                          "full-attention arch, long-context infeasible "
                          "(DESIGN.md §Arch-applicability)")
                    continue
                key = f"{arch}|{shape_name}|{mesh_name}"
                t0 = time.perf_counter()
                try:
                    st = lower_cell(arch, shape_name, mesh,
                                    overrides=overrides)
                    st["cell"] = key
                    st["tag"] = tag
                    st["host_s"] = time.perf_counter() - t0
                    results.append(st)
                    print(f"OK   {key}: trace={st['t_compile']:.1f}s "
                          f"probes={st['t_probes']:.1f}s "
                          f"flops={st['flops']:.3e} "
                          f"bytes={st['bytes_accessed']:.3e} "
                          f"coll={st['collective_bytes']:.3e} "
                          f"mem/dev={st['bytes_per_device']/1e9:.2f}GB")
                except Exception as e:
                    print(f"FAIL {key}: {e}")
                    traceback.print_exc()
                    results.append({"cell": key, "error": str(e),
                                    "error_type": type(e).__name__,
                                    "tag": tag,
                                    "host_s": time.perf_counter() - t0})
                if out_dir:
                    p = pathlib.Path(out_dir)
                    p.mkdir(parents=True, exist_ok=True)
                    fname = key.replace("|", "_").replace(".", "_")
                    if tag:
                        fname += f"_{tag}"
                    (p / f"{fname}.json").write_text(
                        json.dumps(results[-1], indent=1, default=str))
                sys.stdout.flush()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (hillclimb lever)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        overrides[k] = v

    init_fake()
    archs = configs.list_archs() if args.all or not args.arch \
        else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    results = run_cells(archs, shapes, meshes, out_dir=args.out,
                        overrides=overrides or None, tag=args.tag)
    ok = sum(1 for r in results if "error" not in r)
    print(f"\n{ok}/{len(results)} cells traced")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
