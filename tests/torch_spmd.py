"""SPMD helpers of the port's tests and chip_smoke.py: a counter of the
collectives a rank calls, and the functions the tests' ranks run
(spawned with ``repro_torch.core.shard_sim.spawn``: K processes, one
``torch.distributed`` rank each, over a ``file://`` store; ``fn`` must be
importable by module path, and a failure in any rank raises
``torch.multiprocessing.ProcessRaisedException`` in the caller,
uncaught).  Imports neither JAX nor pytest, so it loads on a machine with
a card and PyTorch alone.
"""
from __future__ import annotations

import collections
import contextlib
import sys

import torch
import torch.distributed as dist

# every collective and point-to-point call of torch.distributed that a
# program could issue
COLLECTIVES = ("all_gather_single", "all_gather_into_tensor", "all_gather",
               "all_gather_object", "all_reduce", "all_to_all",
               "all_to_all_single", "barrier", "broadcast",
               "broadcast_object_list", "gather", "irecv", "isend", "recv",
               "reduce", "reduce_scatter", "reduce_scatter_single",
               "reduce_scatter_tensor", "scatter", "send")
GATHERS = ("all_gather_single", "all_gather_into_tensor", "all_gather")


@contextlib.contextmanager
def count_collectives():
    """Count every ``torch.distributed`` collective called by name inside
    the block: yields a ``Counter`` {name: calls}.  The port calls them
    through the module's attributes, so patching the attributes sees
    every call."""
    counts = collections.Counter()
    saved = {}
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        setattr(dist, name, wrapped)
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def record_collectives():
    """Record every collective called inside as (name, shape, bytes) of
    the tensor it is handed (an all-gather's block, a reduce-scatter's
    full input, an all-reduce's tensor), in call order: yields the
    list."""
    calls = []
    saved = {}
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def wrapped(*a, _fn=fn, _name=name, **kw):
            t = a[1] if _name.startswith(("all_gather", "reduce_scatter")) \
                and len(a) > 1 else (a[0] if a else None)
            if isinstance(t, torch.Tensor):
                calls.append((_name, tuple(t.shape),
                              t.numel() * t.element_size()))
            else:
                calls.append((_name, None, 0))
            return _fn(*a, **kw)
        setattr(dist, name, wrapped)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


# --------------------------------------------------------------------------
# the CPU tests' ranks (tests/test_torch_sharding.py, test_torch_engine.py)
# --------------------------------------------------------------------------

def shard_initial(name, device="cpu", cfg_kw=None):
    """(cfg, state, tc) of a pinned sharding scenario
    (torch_kernel_inputs.shard_scenario) in the port, as the reference's
    test builds it: tau written to every server after ``init_state``.
    ``cfg_kw`` overrides fields of its SimConfig."""
    import dataclasses
    import numpy as np
    from repro_torch.core import engine, jobs, topology, types
    from torch_kernel_inputs import shard_scenario
    cfg, arr, specs, topo, tau = shard_scenario(name, jobs, topology, types)
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    jt = jobs.build_jobs(cfg, np.asarray(arr), specs, device=device)
    state, tc = engine.init_state(cfg, jt, topo)
    if tau is not None:
        state.farm.srv_tau = torch.full_like(state.farm.srv_tau, tau)
    return cfg, state, tc


def sharded_runs(rank, world, names, device="cpu", cfg_kw=None):
    """Each named scenario (its SimConfig with ``cfg_kw`` applied) through
    ``run_sharded`` on a ``world``-rank mesh on ``device``: {name: (final
    state, {collective: calls}, sharded leaves)}."""
    from repro_torch.core import shard_sim
    mesh = shard_sim.make_mesh(world, device=device)
    out = {}
    for name in names:
        cfg, state, tc = shard_initial(name, device, cfg_kw)
        n = shard_sim.n_sharded_leaves(state, cfg, mesh)
        with count_collectives() as calls:
            final = shard_sim.run_sharded(state, cfg, tc, mesh)
        out[name] = (final, dict(calls), n)
    return out


def simulate_runs(rank, world, cases):
    """``farm.simulate`` of each (cfg, arrivals, specs, keyword arguments)
    on the CPU twice: with ``partition.n_shards = world`` and no mesh, and
    with a mesh from ``make_mesh``; [(result, result)]."""
    import dataclasses
    from repro_torch.core import farm, shard_sim
    mesh = shard_sim.make_mesh(world, device="cpu")
    out = []
    for cfg, arr, specs, kw in cases:
        by_cfg = dataclasses.replace(cfg, partition=dataclasses.replace(
            cfg.partition, n_shards=world))
        out.append((farm.simulate(by_cfg, arr, specs, device="cpu", **kw),
                    farm.simulate(cfg, arr, specs, device="cpu", mesh=mesh,
                                  **kw)))
    return out


def replica_runs(rank, world, cfg, arrs, specs, mesh_shape, axes):
    """``run_replicas`` of one batch on a CPU mesh of ``mesh_shape`` named
    ``axes``: the final batch."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import montecarlo
    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=axes)
    sb, tc = montecarlo.batched_state(cfg, arrs, specs, device="cpu")
    return montecarlo.run_replicas(cfg, sb, tc, mesh=mesh)


# --------------------------------------------------------------------------
# the LM substrate's sharded steps (tests/test_torch_mesh_train.py,
# tests/test_torch_mesh_moe.py, tests/test_torch_mesh_serve.py,
# tests/test_torch_data_ckpt.py, tests/test_torch_launch.py, chip_smoke.py)
# --------------------------------------------------------------------------

def plain_state(state):
    """A train state as plain dicts ({"params": {name: tensor}, "opt",
    "step"}), detached: what crosses a spawn."""
    return {"params": {n: p.detach() for n, p in
                       state["params"].named_parameters()},
            "opt": {k: dict(v) for k, v in state["opt"].items()},
            "step": state["step"]}


def train_state_of(plain):
    """A port train state from ``plain_state``'s dicts (copied)."""
    from repro_torch.models import transformer
    from repro_torch.train import step
    params = transformer.params_from_named(
        {n: t.clone() for n, t in plain["params"].items()})
    return step.train_state(
        params, {k: {n: t.clone() for n, t in v.items()}
                 for k, v in plain["opt"].items()}, plain["step"].clone())


def mesh_of(shape, axes=("data", "model"), device="cpu"):
    """A DeviceMesh of ``shape`` named ``axes`` over the default group's
    first ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    import math
    return DeviceMesh(torch.device(device).type,
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=tuple(axes))


def gathered(state, shardings, ctx):
    """Every leaf of a sharded train state gathered to full:
    ``plain_state``'s layout."""
    from repro_torch.sharding import spmd
    flat = plain_state(state)
    def full(t, sh):
        return spmd.gather(t, sh.spec, ctx).clone()
    return {"params": {n: full(t, shardings["params"][n])
                       for n, t in flat["params"].items()},
            "opt": {k: {n: full(t, shardings["opt"][k][n])
                        for n, t in v.items()}
                    for k, v in flat["opt"].items()},
            "step": flat["step"].clone()}


def mesh_train(rank, world, cfg, plain, batches, opt, shape,
               axes=("data", "model"), device="cpu"):
    """``make_train_step(cfg, mesh)`` from the full state ``plain``
    (``plain_state``'s layout) sharded over a mesh of ``shape``, one step
    a batch: [(metrics as floats, the state gathered to full, {collective:
    calls})] a step."""
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    mesh = mesh_of(shape, axes, device)
    ctx = spmd.Ctx.of(mesh)
    pos = plain["params"].get("dec_pos")
    sh, _ = step.state_shardings(cfg, mesh,
                                 0 if pos is None else pos.shape[0])
    state = step.shard_state(train_state_of(plain), sh)
    ts = step.make_train_step(cfg, mesh, opt_cfg=opt)
    out = []
    for b in batches:
        with count_collectives() as calls:
            state, m = ts(state, b)
            metrics = {k: float(v) for k, v in m.items()}
        out.append((metrics, gathered(state, sh, ctx), dict(calls)))
    return out


def mesh_mm_sites(rank, world, cfg, plain, batch, shape,
                  axes=("data", "model")):
    """One ``make_train_step(cfg, mesh)`` recorded on this rank by
    ``analysis.graph_audit.record``: ([(in_shapes, out_shapes,
    operations)] of its matrix products (``costmodel.op_cost``), the
    query shapes of its ``flash_attention`` calls)."""
    from repro_torch.analysis import costmodel, graph_audit
    from repro_torch.train import step
    mesh = mesh_of(shape, axes)
    sh, _ = step.state_shardings(cfg, mesh)
    state = step.shard_state(train_state_of(plain), sh)
    inv = graph_audit.record(step.make_train_step(cfg, mesh), state, batch)
    return ([(s.in_shapes, s.shapes, costmodel.op_cost(s)[1])
             for s in inv.sites if s.op in ("aten.mm", "aten.addmm")],
            [s.in_shapes[0] for s in inv.sites
             if s.op == "repro_torch.flash_attention"])


def kernel_plans(rank, world, cfg, plain, batch, shape,
                 axes=("data", "model")):
    """One ``make_train_step(cfg, mesh)`` on this rank with every LM
    kernel call's inputs put to its wrapper's ``plan`` (pure: the checks
    the card's wrapper makes before a launch): [(kernel, q's or x's shape,
    the instance, or the ValueError's text)]."""
    from repro_torch.kernels import flash_attention, ops, ssm_scan
    from repro_torch.train import step
    mesh = mesh_of(shape, axes)
    sh, _ = step.state_shardings(cfg, mesh)
    state = step.shard_state(train_state_of(plain), sh)
    seen, real = [], (ops.flash_attention, ops.ssm_scan)

    def planned(name, fn, *a):
        try:
            seen.append((name, tuple(a[0].shape), str(fn(*a))))
        except ValueError as e:
            seen.append((name, tuple(a[0].shape), f"ValueError: {e}"))

    def fa(q, k, v, **kw):
        planned("flash_attention", lambda *x: flash_attention.plan(
            *x, window=kw.get("window", 0)), q, k, v)
        return real[0](q, k, v, **kw)

    def ss(*a):
        planned("ssm_scan", ssm_scan.plan, *a)
        return real[1](*a)
    ops.flash_attention, ops.ssm_scan = fa, ss
    try:
        step.make_train_step(cfg, mesh)(state, batch)
    finally:
        ops.flash_attention, ops.ssm_scan = real
    return seen


def period_watch(rank, world, cfg, plain, batch, shape,
                 axes=("data", "model")):
    """One ``make_train_step(cfg, mesh)`` on this rank under
    ``roofline.analysis.LiveBytes``, its period gathers watched through
    ``spmd.ON_GATHER``: ([(event, key)] of the periods' keys in order,
    the most periods whose gathered leaves were alive at once at any
    event, by the tensors' weak references and by the storages
    ``LiveBytes`` still counts, {collective: calls})."""
    import weakref
    from repro_torch.roofline.analysis import LiveBytes
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    mesh = mesh_of(shape, axes)
    sh, _ = step.state_shardings(cfg, mesh)
    state = step.shard_state(train_state_of(plain), sh)
    ts = step.make_train_step(cfg, mesh)
    mem = LiveBytes()
    mem.add(state, batch)
    events, refs, stores, most = [], {}, {}, [0, 0]

    def hook(event, key, tensors):
        if not (isinstance(key, tuple) and key[0].startswith("layers.")):
            return
        events.append((event, int(key[0].split(".")[1])))
        refs.setdefault(key, []).extend(weakref.ref(t) for t in tensors)
        stores.setdefault(key, []).extend(
            weakref.ref(t.untyped_storage()) for t in tensors)
        live = sum(any(r() is not None for r in rs) for rs in refs.values())
        counted = sum(any(r() is not None and id(r()) in mem.live
                          for r in rs) for rs in stores.values())
        most[0], most[1] = max(most[0], live), max(most[1], counted)
    spmd.ON_GATHER.append(hook)
    try:
        with count_collectives() as calls, mem:
            state, m = ts(state, batch)
            float(m["loss"])
    finally:
        spmd.ON_GATHER.remove(hook)
    return events, tuple(most), dict(calls)


def mesh_moe_forward(rank, world, cfg, plain_params, tokens, shape,
                     axes=("data", "model"), device="cpu"):
    """A train-mode forward of an MoE model over a mesh of ``shape`` from
    full parameters (``plain_state``'s {name: tensor}), with the step's
    compute forms (``tp_plan``) and context: (logits of every row and
    vocab column, the global
    aux, [(topi, gaps) a layer] of every row, tokens dropped a layer over
    every row)."""
    from repro_torch.models import moe, transformer
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    from torch_kernel_inputs import recorded_routes
    mesh = mesh_of(shape, axes, device)
    ctx = spmd.Ctx.of(mesh).for_batch(tokens.shape[0])
    sh, _ = step.state_shardings(cfg, mesh)
    params = transformer.params_from_named(plain_params)
    blocks = step.shard_state(step.train_state(params), sh)["params"]
    full = step.gather_params(blocks, step.tp_plan(cfg, mesh, blocks), ctx)
    drops, scatter = [], moe.moe_scatter

    def counting(*a):
        out = scatter(*a)
        drops.append(out[2])
        return out
    moe.moe_scatter = counting
    try:
        with torch.no_grad(), contextlib.ExitStack() as stack:
            routes = stack.enter_context(recorded_routes(moe))
            logits, _, aux = transformer.forward(
                cfg, full, ctx.batch_rows(tokens), mode="train", ctx=ctx)
            logits = transformer.full_logits(cfg, logits, ctx)
    finally:
        moe.moe_scatter = scatter
    if ctx.split:
        rows = lambda t: spmd.gather(t, (ctx.batch_axes,), ctx)
        logits, aux = rows(logits), ctx.batch_sum(aux)
        routes = [(rows(t), rows(g)) for t, g in routes]
        drops = [ctx.batch_sum(d) for d in drops]
    return logits, float(aux), routes, [int(d) for d in drops]


def mesh_serve(rank, world, cfg, plain_params, tokens, steps, prompts,
               shape, max_seq, axes=("data", "model"), device="cpu"):
    """The sharded serving entry points over a mesh of ``shape`` from full
    parameters (``plain_state``'s {name: tensor}), cut to this rank's
    blocks: ``make_prefill(cfg, mesh)`` on ``tokens`` (B, S) into this
    rank's blocks of the cache (``init_cache(..., ctx=mesh)``),
    ``make_serve_step(cfg, mesh)`` on each (B, 1) token of ``steps`` at
    positions S, S + 1, ..., then ``ServeEngine(mesh=)`` greedy on each
    prompt list of ``prompts``:
    (logits of every row a call, [tokens a prompt] a list, the cache's
    rows, {collective: calls} of the first serve step)."""
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    mesh = mesh_of(shape, axes, device)
    sh, _ = step.state_shardings(cfg, mesh)
    blocks = step.shard_params(transformer.params_from_named(
        dict(plain_params)), sh["params"])
    B, S = tokens.shape
    cache = transformer.init_cache(cfg, B, max_seq, device=device, ctx=mesh)
    rows = next(t for t in cache[0].values()
                if isinstance(t, torch.Tensor)).shape[0]
    prefill = step.make_prefill(cfg, mesh)
    serve_step = step.make_serve_step(cfg, mesh)
    with torch.no_grad():
        logits, cache = prefill(blocks, tokens, cache)
        out, calls = [logits], None
        for i, tok in enumerate(steps):
            with count_collectives() as counted:
                logits, cache = serve_step(blocks, cache, tok, S + i)
            calls = dict(counted) if calls is None else calls
            out.append(logits)
    engine = ServeEngine(cfg, blocks, max_batch=B, max_seq=max_seq,
                         mesh=mesh, device=device)
    gens = [[g.tokens for g in engine.generate(p, max_new=len(steps) + 2)]
            for p in prompts]
    return out, gens, rows, calls


def serve_layout(rank, world, cfg, plain_params, tokens, steps, prompts,
                 shape, max_seq, axes=("data", "model"), device="cpu"):
    """The serve steps over a mesh of ``shape`` in the decode layout of
    ``cfg`` (with ``serve_weights_stationary`` the parameters under
    ``partition.serve_rules``), from full parameters: the prefill of
    ``tokens`` (B, S) into this rank's blocks of the cache, a decode step
    a (B, 1) token of ``steps``, then ``ServeEngine(mesh=)`` greedy on
    ``prompts`` from the train layout's blocks.  Returns {"logits" a
    call, "tokens", "cache" {leaf: block shape} of every layer,
    "decode" [(collective, shape, bytes)] a decode step, "param_gathers"
    the parameter leaves a step's ``Gatherer`` gathered}."""
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    mesh = mesh_of(shape, axes, device)
    full = transformer.params_from_named(dict(plain_params))
    train_sh, _ = step.state_shardings(cfg, mesh)
    blocks = step.shard_params(full, step.serve_shardings(cfg, mesh)[0][
        "params"])
    B, S = tokens.shape
    cache = transformer.init_cache(cfg, B, max_seq, device=device, ctx=mesh)
    out = {"cache": {}, "decode": [], "param_gathers": 0}
    for i, c in enumerate(cache):
        for k, t in c.items():
            for kk, tt in (t.items() if isinstance(t, dict) else [(None, t)]):
                out["cache"][".".join(str(x) for x in (i, k, kk)
                                      if x is not None)] = tuple(tt.shape)

    def hook(event, key, tensors):
        out["param_gathers"] += len(tensors)
    spmd.ON_GATHER.append(hook)
    try:
        with torch.no_grad():
            logits, cache = step.make_prefill(cfg, mesh)(blocks, tokens,
                                                        cache)
            out["logits"] = [logits]
            serve_step = step.make_serve_step(cfg, mesh)
            n_prefill = out["param_gathers"]
            for i, tok in enumerate(steps):
                with record_collectives() as calls:
                    logits, cache = serve_step(blocks, cache, tok, S + i)
                out["decode"].append(calls)
                out["logits"].append(logits)
            out["param_gathers"] = (n_prefill,
                                    out["param_gathers"] - n_prefill)
    finally:
        spmd.ON_GATHER.remove(hook)
    engine = ServeEngine(cfg, step.shard_params(full, train_sh["params"]),
                         max_batch=len(prompts), max_seq=max_seq, mesh=mesh,
                         device=device)
    out["tokens"] = [g.tokens for g in
                     engine.generate(prompts, max_new=len(steps) + 2)]
    return out


def ckpt_reshard(rank, world, cfg, plain, other, directory, save_shape,
                 load_shape):
    """Save the full state ``plain`` from its blocks on a ``save_shape``
    mesh (rank 0 writes), then restore it on a ``load_shape`` mesh into
    the blocks of the state ``other``: the restored state gathered to
    full, and its step."""
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.sharding import spmd
    from repro_torch.train import step
    mesh = mesh_of(save_shape)
    sh, _ = step.state_shardings(cfg, mesh)
    ck = Checkpointer(directory)
    ck.save(step.shard_state(train_state_of(plain), sh), 7, shardings=sh)
    dist.barrier()
    mesh = mesh_of(load_shape)
    sh, _ = step.state_shardings(cfg, mesh)
    like = step.shard_state(train_state_of(other), sh)
    state, at = ck.restore(like, shardings=sh)
    return gathered(state, sh, spmd.Ctx.of(mesh)), at


def launch_main(rank, world, argv):
    """``repro_torch.launch.train.main(argv)`` on this rank: its return
    code."""
    from repro_torch.launch import train
    return train.main(argv)


def spmd_laws(rank, world, shape, axes=("data", "model")):
    """``sharding/spmd.py``'s pieces on a CPU mesh of ``shape``, from
    full tensors every rank draws alike (seeded): {law: value} for the
    test to hold (tests/test_torch_partition.py)."""
    from repro_torch.sharding import spmd
    mesh = mesh_of(shape, axes)
    ctx = spmd.Ctx.of(mesh)
    g = torch.Generator().manual_seed(7)
    full = torch.randn(8, 6, generator=g)
    out = {}
    specs = [(), ("data",), (None, "data"), ("model", "data"),
             (("data", "model"),), ("data", "model")]
    out["roundtrip"] = [
        torch.equal(spmd.gather(spmd.block(full, sp, ctx), sp, ctx), full)
        for sp in specs]
    # a rank's gradient of a full leaf: its batch rank's share, the same
    # on every model rank
    grad = full * (1 + ctx.batch_index)
    total = sum(full * (1 + r) for r in range(ctx.n_batch))
    split = dataclasses_replace(ctx, split=True)
    out["reduce_split"] = [
        float((spmd.reduce_grad(grad, sp, split)
               - spmd.block(total if split.n_batch > 1 else grad, sp, ctx)
               ).abs().max()) for sp in specs]
    out["reduce_replicated"] = [
        torch.equal(spmd.reduce_grad(full, sp, ctx), spmd.block(full, sp, ctx))
        for sp in specs]
    # the norm of blocks counts a replicated leaf once
    leaves = [torch.randn(8, 6, generator=g), torch.randn(5, generator=g),
              torch.randn(4, 4, generator=g)]
    lspecs = [("data", "model"), (), ("model",)]
    blocks = [spmd.block(t, sp, ctx) for t, sp in zip(leaves, lspecs)]
    out["norm"] = (float(spmd.global_norm(blocks, lspecs, ctx)),
                   float(torch.sqrt(sum((t * t).sum() for t in leaves))))
    # the expert-parallel region: y = sum_r f_r(slice_r(x)), replicated
    x = torch.randn(3, 4, 2, generator=g, requires_grad=True)
    w = torch.randn(3, 4, 2, generator=g)
    xs = spmd.model_slice(x, 1, ctx)
    ws = spmd.block(w, (None, "model"), ctx)
    c = spmd.model_copy(x.sum(dim=(1, 2)), ctx)
    y = spmd.model_sum((xs * ws).sum(dim=(1, 2)) * c, ctx)
    (gx,) = torch.autograd.grad((y ** 2).sum(), x)
    x1 = x.detach().clone().requires_grad_(True)
    y1 = (x1 * w).sum(dim=(1, 2)) * x1.sum(dim=(1, 2))
    (gx1,) = torch.autograd.grad((y1 ** 2).sum(), x1)
    out["ep"] = (float((y - y1).detach().abs().max()),
                 float((gx - gx1).abs().max()), float(gx1.abs().max()))
    return out


def dataclasses_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


def plan(rank, world, steps):
    """Several of the functions above in one spawn, so each rank imports
    torch once: ``steps`` is [(function name, extra args)].  Returns their
    results in order, and the JAX or ``repro`` modules the rank had
    imported by then (none: the port stands alone)."""
    results = [globals()[fn](rank, world, *args) for fn, args in steps]
    return results, sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "repro"))
