"""Tensor parallelism over "model" in the port's sharded train step, on
spawned CPU ranks (gloo): every architecture at smoke size in float32 on
the (data, model) mesh (1, 2), two steps of ``make_train_step(cfg, mesh)``
held to two of the port's one-device step within
``tests/torch_train_cases.py``'s bands (loss, nll, aux and grad_norm
1e-5, gradients 1e-4 of each leaf's largest magnitude, moments and
parameters by ``adamw_param_check``), with two cuts whose heads a model
rank's block cuts mid-head (the gather-and-slice path: llama with 9 heads
over 3 kv heads, whose ranks start and end mid-group, and hymba with 3
over 1); llama3.2-1b against ``jax.jit(repro.train.step.make_train_step)``
too (hymba's and qwen3-moe's are in test_torch_mesh_train.py and
test_torch_mesh_moe.py).  The split itself is pinned on rank 0's
recording (``analysis.graph_audit.record``): the column-parallel
products run on half the columns, at half the operations of one device's
(``costmodel.op_cost``), and the attention on half the heads; every
kernel input a rank makes passes the card wrapper's ``plan``.  About 51 s
on one worker."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.analysis import costmodel, graph_audit
from repro_torch.core import shard_sim
from repro_torch.models import layers as tlayers
from repro_torch.sharding import spmd
from repro_torch.train import step as tstep

import torch_spmd
from torch_train_cases import mesh_runs, mesh_vs_one_device, run_case

torch.set_num_threads(1)
F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = tconfigs.list_archs()
# a model rank's block cuts a head: 9 heads over 3 kv heads (each rank
# starts or ends mid-group, its kv heads taken a query head each), and
# hymba's 3 over 1 (13 and 12 of hymba-1.5b's 25 over 2, in small)
CUTS = {"llama_9_heads": ("llama3_2_1b", dict(n_heads=9, n_kv_heads=3)),
        "hymba_3_heads": ("hymba_1_5b", dict(n_heads=3, n_kv_heads=1))}


def _cfg(arch, **kw):
    return dataclasses.replace(tconfigs.get_smoke(arch), **F32, **kw)


@pytest.fixture(scope="module")
def runs():
    cfgs = [_cfg(a) for a in ARCHS] + [_cfg(a, **kw) for a, kw in
                                       CUTS.values()]
    return dict(zip(ARCHS + list(CUTS), mesh_runs(cfgs, (1, 2))))


@pytest.mark.parametrize("arch", ARCHS + list(CUTS))
def test_model2_train_steps_equal_one_device(runs, arch):
    mesh_vs_one_device(runs[arch], (1, 2))


def _ctx(shape, model_index):
    """Model rank ``model_index``'s context of a (data, model) mesh of
    ``shape`` (its sizes and coordinate, no process group)."""
    return spmd.Ctx(None, {"data": shape[0], "model": shape[1]},
                    {"data": 0, "model": model_index})


def test_heads_cut_mid_head_take_the_gather_and_slice_path():
    # hymba-1.5b's 25 heads over 2: 13 and 12; 5 a kv head, so both ranks
    # read kv head 2 and take their kv heads a query head each
    assert [spmd.split_range(25, 2, i) for i in range(2)] == \
        [(0, 13), (13, 25)]
    assert tlayers.kv_heads(0, 13, 25, 5) == [0] * 5 + [1] * 5 + [2] * 3
    assert tlayers.kv_heads(13, 25, 25, 5) == [2] * 2 + [3] * 5 + [4] * 5
    # llama3.2-1b's 32 over 8 on 2 ranks: 16 heads over kv heads 0-3, 4-7
    assert tlayers.kv_heads(0, 16, 32, 8) == slice(0, 4)
    assert tlayers.kv_heads(16, 32, 32, 8) == slice(4, 8)
    arch, kw = CUTS["llama_9_heads"]
    plan = tstep.tp_plan(_cfg(arch, **kw), _ctx((1, 2), 1), {})
    wq, wo, wk = (plan[f"layers.0.mixer.{n}"] for n in ("wq", "wo", "wk"))
    assert wq.take == (1, [(5 * 16, 9 * 16)], 9 * 16) and wq.keep == ()
    assert wo.take == (0, [(5 * 16, 9 * 16)], 9 * 16)
    assert wk.partial and wk.take is None
    # the mamba in_proj [x | z]: the rank's x and z columns
    plan = tstep.tp_plan(_cfg("hymba_1_5b"), _ctx((1, 2), 1), {})
    Dss = _cfg("hymba_1_5b").d_ssm
    assert plan["layers.0.mixer.ssm.in_proj"].take == (
        1, [(Dss // 2, Dss), (Dss + Dss // 2, 2 * Dss)], 2 * Dss)
    assert plan["layers.0.mixer.ssm.conv_b"].keep == (0,)


def test_llama_model2_matches_jax():
    run_case("llama3_2_1b", mesh_shape=(1, 2))


def _column_cfg():
    # shapes that no other product of the step shares: D 64, Qd 192 (96 a
    # rank), F 160 (80), kv 48, B S = 48 rows
    return _cfg("llama3_2_1b", head_dim=48, n_kv_heads=1, d_ff=160)


def _batch_of(cfg, B, S, seed):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)))
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


# the kernel-input cases: bf16 (the tensor-core instances' alignment
# rule), the SSM's summed B and C, kv heads as a slice and a query head
# each
PLAN_CASES = [("hymba_1_5b", {}), ("hymba_1_5b", dict(n_heads=3,
                                                     n_kv_heads=1)),
              CUTS["llama_9_heads"]]


@pytest.fixture(scope="module")
def rank_records():
    """One spawn of two ranks: rank 0's recording of a (1, 2) step of the
    column config, and every kernel call's ``plan`` in a step of each
    PLAN_CASES config in bf16."""
    cfg = _column_cfg()
    st = tstep.init_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    steps = [("mesh_mm_sites", (cfg, torch_spmd.plain_state(st),
                                _batch_of(cfg, 4, 12, 2), (1, 2)))]
    for arch, kw in PLAN_CASES:
        c = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
        s = tstep.init_state(c, torch.Generator().manual_seed(0),
                             device="cpu")
        steps.append(("kernel_plans", (c, torch_spmd.plain_state(s),
                                       _batch_of(c, 2, 16, 1), (1, 2))))
    res = shard_sim.spawn(torch_spmd.plan, 2, (steps,))
    return cfg, st, res


def test_column_parallel_products_run_on_half_the_columns(rank_records):
    cfg, st, res = rank_records
    D, Qd, F = cfg.d_model, cfg.q_dim, cfg.d_ff
    (sites, tp_flash) = res[0][0][0]
    inv = graph_audit.record(tstep.make_train_step(cfg), st,
                             _batch_of(cfg, 4, 12, 2))
    one = [(s.in_shapes, costmodel.op_cost(s)[1]) for s in inv.sites
           if s.op in ("aten.mm", "aten.addmm")]
    flash = [s.in_shapes[0] for s in inv.sites
             if s.op == "repro_torch.flash_attention"]
    for full, half in (((D, Qd), (D, Qd // 2)), ((D, F), (D, F // 2))):
        got = [ops for ins, _, ops in sites if tuple(ins[-1]) == half]
        exp = [ops for ins, ops in one if tuple(ins[-1]) == full]
        assert exp and len(got) == len(exp), (full, len(got), len(exp))
        assert 2 * sum(got) == sum(exp), (full, sum(got), sum(exp))
        assert not [1 for ins, _, _ in sites if tuple(ins[-1]) == full]
    # the attention at H/2 heads a rank, (B, H, S, hd)
    assert flash and all(s[1] == cfg.n_heads for s in flash)
    assert len(tp_flash) == len(flash) and \
        all(s[1] == cfg.n_heads // 2 for s in tp_flash)


def test_kernel_inputs_pass_the_card_wrappers_checks(rank_records):
    """The card's wrappers refuse what their kernels cannot take (strides,
    alignment, contiguity); their ``plan`` is pure and runs here on the
    inputs a model rank hands them: the SSM's B and C summed over "model",
    the kv heads a rank's query heads read (a slice, or a query head
    each), in bf16."""
    _, _, res = rank_records
    for outs, _ in res:
        for (arch, kw), seen in zip(PLAN_CASES, outs[1:]):
            tag = (arch, kw)
            assert seen, tag
            bad = [s for s in seen if s[2].startswith("ValueError")]
            assert not bad, (tag, bad)
            assert {s[0] for s in seen} == (
                {"flash_attention", "ssm_scan"} if arch == "hymba_1_5b"
                else {"flash_attention"}), tag


@pytest.mark.parametrize("shape, full, dim, ctx, want", [
    ((8, 6), 6, -1, object(), False),      # a whole leaf
    ((8, 3), 6, -1, object(), True),       # a model rank's columns
    ((3, 8), 6, 0, object(), True),        # a vocab-parallel embedding
    ((8, 3), 6, -1, None, False),          # no mesh: never a part
])
def test_is_part_reads_the_layouts_verdict_off_the_shape(shape, full, dim,
                                                         ctx, want):
    assert spmd.is_part(torch.empty(shape), full, ctx, dim) is want
