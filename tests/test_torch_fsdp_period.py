"""FSDP gathers a period at a time, with the next period's gathers in
flight, in the port's sharded train step, on spawned CPU ranks (gloo):
every architecture at smoke size in float32 on the (data, model) mesh
(2, 2), where each step gathers the batch axes' blocks period by period
and splits its compute over "model" too, two steps of
``make_train_step(cfg, mesh)`` held to two of the port's one-device step
within ``tests/torch_train_cases.py``'s bands (with the two cuts whose
heads a block cuts mid-head of test_torch_tensor_parallel.py).  On (2, 1)
``spmd.ON_GATHER`` pins the schedule of a step of four periods under
remat "full" and "dots": each period's gathers start before the period
before it runs and are waited on before its own checkpoint, a recompute
gathers again (the all-gathers counted: twice a period's leaves, once
each leaf outside the periods), and at most two periods' gathered leaves
are alive at once (their tensors' weak references, and the storages
``roofline.analysis.LiveBytes`` counts: the dry run's peak sees each
period's leaves freed).  About 34 s on one worker."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import shard_sim
from repro_torch.sharding import spmd
from repro_torch.train import step as tstep

import torch_spmd
from torch_train_cases import mesh_runs, mesh_vs_one_device

torch.set_num_threads(1)
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = tconfigs.list_archs()
CUTS = {"llama_9_heads": ("llama3_2_1b", dict(n_heads=9, n_kv_heads=3)),
        "hymba_3_heads": ("hymba_1_5b", dict(n_heads=3, n_kv_heads=1))}


def _cfg(arch, **kw):
    return dataclasses.replace(tconfigs.get_smoke(arch), **F32, **kw)


@pytest.fixture(scope="module")
def runs():
    cfgs = [_cfg(a) for a in ARCHS] + [_cfg(a, **kw) for a, kw in
                                       CUTS.values()]
    return dict(zip(ARCHS + list(CUTS), mesh_runs(cfgs, (2, 2))))


@pytest.mark.parametrize("arch", ARCHS + list(CUTS))
def test_data2_model2_train_steps_equal_one_device(runs, arch):
    mesh_vs_one_device(runs[arch], (2, 2))


REMATS = ("full", "dots")
L = 4


@pytest.fixture(scope="module")
def watched():
    cases = []
    for remat in REMATS:
        cfg = _cfg("hymba_1_5b", n_layers=L, remat=remat)
        st = tstep.init_state(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab, (4, 8)))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        cases.append((cfg, torch_spmd.plain_state(st), batch, (2, 1)))
    res = shard_sim.spawn(torch_spmd.plan, 2, ([
        ("period_watch", c) for c in cases],))
    return [c[0] for c in cases], res


def _expected_gathers(cfg, shape):
    """All-gathers of one step with remat: each period's leaves twice (its
    forward, prefetched, and its recompute), each leaf outside the periods
    once at its use (``embed`` twice when the head is tied)."""
    ctx = spmd.Ctx(None, {"data": shape[0], "model": shape[1]},
                   {"data": 0, "model": 0})
    plan = tstep.tp_plan(cfg, ctx, {})
    n = 0
    for name, lp in plan.items():
        uses = 2 if name.startswith("layers.") else \
            1 + (name == "embed" and cfg.tie_embeddings)
        n += uses * len(spmd._gather_steps(lp, ctx))
    return n


@pytest.mark.parametrize("k", range(len(REMATS)), ids=REMATS)
def test_periods_gather_ahead_and_free_behind(watched, k):
    cfgs, res = watched
    cfg = cfgs[k]
    expect = [("start", 0), ("wait", 0)]
    for i in range(1, L):
        expect += [("start", i), ("take", i - 1), ("wait", i)]
    expect += [("take", L - 1)] + [("sync", i) for i in reversed(range(L))]
    for r, (outs, mods) in enumerate(res):
        assert not mods
        events, most, calls = outs[k]
        assert events == expect, (cfg.remat, r, events)
        # by the tensors' references and by LiveBytes' count of storages
        assert max(most) <= 2, (cfg.remat, r, most)
        gathers = sum(calls.get(n, 0) for n in torch_spmd.GATHERS)
        assert gathers == _expected_gathers(cfg, (2, 1)), \
            (cfg.remat, r, calls)


def test_a_torch_without_the_selective_checkpoint_modes_raises(monkeypatch):
    """The gathers hide from remat "dots" through
    ``torch.utils.checkpoint``'s private dispatch modes: a torch that
    lacks one raises naming it, rather than let a recompute record them."""
    from torch.utils import checkpoint as ck
    assert spmd._selective_modes() == (ck._CachingTorchDispatchMode,
                                       ck._CachedTorchDispatchMode)
    monkeypatch.delattr(ck, "_CachedTorchDispatchMode")
    spmd._selective_modes.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="_CachedTorchDispatchMode"):
            with spmd._unseen_by_selective_checkpoint():
                pass
    finally:
        spmd._selective_modes.cache_clear()
