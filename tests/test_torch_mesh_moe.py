"""Expert parallelism and the MoE losses under batch sharding, on spawned
CPU ranks (gloo): smoke qwen3-moe (and moonshot, with its shared expert)
in float32 with drops (capacity factor 0.5).

  * On (1, 2) each rank holds half the experts: the routes and the drops
    are exactly one device's, the logits within 1e-4 of their largest
    magnitude, the aux within 1e-5; two train steps equal one device's and
    JAX's within tests/torch_train_cases.py's bands, the gradients not
    scaled by the shard count.
  * On (2, 1) each rank routes half the rows: the global aux (the top-1
    fractions summed over the ranks, the mean probabilities and the
    z-loss as shares of the global count) equals one device's, and a
    route may differ only at a near-tie (``torch_kernel_inputs.route_flips``,
    the top-(k+1) logits closer than 1e-5); the train steps as above.
  * The collectives a sharded step calls, counted by name against the
    laws of its plan (``_expected_calls``: the gathers a period's leaves
    take where they are used, the tensor-parallel regions' sums and
    copies, the vocab-parallel loss's all-reduces), with microbatches the
    batch ranks do not divide too (their counts' all-reduce, and one of
    the top-1 counts a wave for MoE).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import shard_sim
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.sharding import spmd
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep

import torch_spmd
from torch_kernel_inputs import recorded_routes, route_flips
from torch_train_cases import run_case

torch.set_num_threads(1)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _cfg(arch, **kw):
    return dataclasses.replace(tconfigs.get_smoke(arch), **F32, **kw)


def _one_device(cfg, plain, tokens):
    """The same forward on one device: (logits, aux, routes, drops)."""
    params = ttransformer.params_from_named(plain)
    drops, scatter = [], tmoe.moe_scatter

    def counting(*a):
        out = scatter(*a)
        drops.append(int(out[2]))
        return out
    tmoe.moe_scatter = counting
    try:
        with torch.no_grad(), recorded_routes(tmoe) as routes:
            logits, _, aux = ttransformer.forward(cfg, params, tokens,
                                                  mode="train")
    finally:
        tmoe.moe_scatter = scatter
    return logits, float(aux), routes, drops


def test_expert_parallel_and_split_batch_forward():
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 16)))
    cases = []
    for arch in ("qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b"):
        cfg = _cfg(arch, capacity_factor=0.5)
        p = ttransformer.make_params(cfg, torch.Generator().manual_seed(1),
                                     device="cpu")
        plain = {n: t.detach() for n, t in p.named_parameters()}
        cases += [(cfg, plain, shape) for shape in ((1, 2), (2, 1))]
    res = shard_sim.spawn(torch_spmd.plan, 2, ([
        ("mesh_moe_forward", (cfg, plain, tokens, shape))
        for cfg, plain, shape in cases],))
    for r, (outs, mods) in enumerate(res):
        assert not mods
        for (cfg, plain, shape), got in zip(cases, outs):
            lg, aux, routes, drops = got
            elg, eaux, eroutes, edrops = _one_device(cfg, plain, tokens)
            tag = (cfg.name, shape, r)
            assert sum(edrops) > 0, tag               # the case drops
            assert abs(aux - eaux) <= 1e-5 * abs(eaux), (tag, aux, eaux)
            top = float(elg.abs().max())
            assert float((lg - elg).abs().max()) <= 1e-4 * top, tag
            if shape == (1, 2):                       # rows not split
                assert all(torch.equal(a[0], b[0])
                           for a, b in zip(routes, eroutes)), tag
                assert drops == edrops, (tag, drops, edrops)
            else:
                flips = route_flips(routes, eroutes)
                if not flips:
                    assert drops == edrops, (tag, drops, edrops)


def test_expert_weights_must_be_the_ranks_block():
    cfg = _cfg("qwen3_moe_235b_a22b")
    p = ttransformer.make_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")["layers"][0]["ffn"]
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    two = spmd.Ctx(None, {"data": 1, "model": 2}, {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="this rank runs 4 of 8"):
        tmoe.moe_scatter(p, x, cfg, two)
    # E % n != 0: replicated experts, the local path, no collective
    three = spmd.Ctx(None, {"data": 1, "model": 3}, {"data": 0, "model": 0})
    assert not tmoe.expert_parallel(cfg, three)
    got, exp = tmoe.moe_block(p, x, cfg, three), tmoe.moe_block(p, x, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, exp))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1)],
                         ids=["model2", "data2"])
def test_sharded_moe_train_step_matches_jax_and_one_device(mesh_shape):
    run_case("qwen3_moe_235b_a22b", mesh_shape=mesh_shape)


class _Mesh:                       # a DeviceMesh's names and sizes alone
    def __init__(self, shape):
        self.mesh_dim_names, self.shape = ("data", "model"), tuple(shape)


def _tp(lp) -> bool:
    """Whether a leaf's compute form is a model rank's part."""
    on_model = lambda e: e is not None and "model" in (
        (e,) if isinstance(e, str) else e)
    return lp.take is not None or any(
        on_model(lp.spec[d]) for d in lp.keep if d < len(lp.spec))


def _expected_calls(cfg, shape, B=4):
    """The collectives one sharded step must call on a (data, model) mesh
    of ``shape`` on a batch of ``B`` rows it splits (smoke configs: remat
    "nothing", no chunked loss), as laws of the step's plan
    (``train.step.tp_plan``):

      * each leaf's gathers, once a use (a period's leaves in the forward,
        the tied ``embed`` at the lookup and at the head), or once a step
        where microbatches cross the batch ranks (every compute form made
        up front): an all-gather an axis over 1 of every dim it gathers,
        the taken leaves' over "model" included; backward, a
        reduce-scatter over "model" for a taken leaf and one an axis for
        each batch axis of its spec when the batch is split, an
        all-reduce an axis where the spec names none, and one over
        "model" for a ``partial`` leaf;
      * the tensor-parallel regions over "model": a copy (its backward
        all-reduce) and a sum a region (hymba's attention and SSM share
        them), the SSM's B and C summed forward and backward, the
        vocab-parallel lookup's sum, the head's copy and the loss's two
        all-reduces (the row max, then the exponentials' sum and the gold
        logit together);
      * expert parallelism: the slice's backward gather, the combine's
        sum and the gates' copy a layer (the shared experts' region joins
        that sum);
      * the norm's all-reduce an axis over 1; with a split batch the label
        count's, the stats' and the MoE fractions' a layer (with
        microbatches, the counts' and one a wave)."""
    sizes = {"data": shape[0], "model": shape[1]}
    ctx = spmd.Ctx(None, sizes, {"data": 0, "model": 0})
    plan = tstep.tp_plan(cfg, ctx, {})
    split = shape[0] > 1
    whole = split and cfg.microbatches > 1
    # the forwards a step runs: a rank's segments, or every microbatch
    runs = len(tstep.segments(B, cfg.microbatches, shape[0], 0)) if whole \
        else cfg.microbatches
    n = shape[1]
    gathers = scatters = reduces = 0
    for name, lp in plan.items():
        uses = 1 if whole else runs * (
            2 if name == "embed" and cfg.tie_embeddings else 1)
        axes = {a for e in lp.spec for a in ((e,) if isinstance(e, str)
                                            else e or ())}
        gathers += uses * len(spmd._gather_steps(lp, ctx))
        if lp.take is not None:
            scatters += uses
        if split:
            if "data" in axes:
                scatters += uses
            else:
                reduces += uses
        if lp.partial and n > 1:
            reduces += uses
    tp = tp_gathers = 0
    if n > 1:
        for i in range(cfg.n_layers):
            pre = f"layers.{i}."
            kind = ttransformer.layer_kind(cfg, i)
            if kind == "hymba":
                ta = _tp(plan[pre + "mixer.attn.wq"])
                ts = _tp(plan[pre + "mixer.ssm.conv_b"])
                tp += (ta or ts) + (1 if ta and ts else ta + ts) \
                    + 2 * ts
            elif kind in ("attn", "swa"):
                tp += 2 * _tp(plan[pre + "mixer.wq"])
            if cfg.is_moe:
                ep = cfg.n_experts % n == 0
                tp_gathers += ep
                tp += 2 * ep
                if cfg.n_shared_experts and _tp(
                        plan[pre + "ffn.shared.wu"]):
                    tp += 1 if ep else 2
            elif cfg.d_ff:
                tp += 2 * _tp(plan[pre + "ffn.wu"])
        head = plan["embed" if cfg.tie_embeddings else "lm_head"]
        tp += _tp(plan["embed"]) + 3 * _tp(head)
    gathers += runs * tp_gathers
    reduces += runs * tp
    reduces += sum(v > 1 for v in sizes.values())     # the norm
    moe_layers = cfg.n_layers if cfg.is_moe else 0
    if whole:
        waves = max(tstep.waves(B, cfg.microbatches, shape[0])) + 1
        reduces += 2 + (waves if moe_layers else 0)   # counts, stats, waves
    elif split:
        reduces += 2 + moe_layers               # count, stats, fractions
    calls = {"all_gather_single": gathers, "all_reduce": reduces}
    if scatters:
        calls["reduce_scatter_single"] = scatters
    return {k: v for k, v in calls.items() if v}


def test_collectives_a_step_counted():
    cases = []
    for arch, shape in (("hymba_1_5b", (2, 1)), ("hymba_1_5b", (1, 2)),
                        ("qwen3_moe_235b_a22b", (1, 2)),
                        ("qwen3_moe_235b_a22b", (2, 1)),
                        ("llama3_2_1b", (1, 2)), ("moonshot_v1_16b_a3b",
                                                  (1, 2))):
        cfg = _cfg(arch)
        st = tstep.init_state(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        rng = np.random.default_rng(2)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        cases.append((cfg, shape, torch_spmd.plain_state(st), batch))
    # 3 microbatches over 2 ranks (one all-reduce of the label counts; 3
    # waves of MoE counts) and 2 over 2
    rows6 = {k: torch.cat([v, v[:2]]) for k, v in cases[3][3].items()}
    for i, mb, batch in ((0, 3, rows6), (3, 3, rows6), (3, 2, None)):
        cfg, shape, plain, b = cases[i]
        cases.append((dataclasses.replace(cfg, microbatches=mb), shape,
                      plain, batch or b))
    res = shard_sim.spawn(torch_spmd.plan, 2, ([
        ("mesh_train", (cfg, plain, [batch], toptim.AdamWConfig(), shape))
        for cfg, shape, plain, batch in cases],))
    for outs, _ in res:
        for (cfg, shape, _, batch), steps in zip(cases, outs):
            calls = steps[0][2]
            rs = calls.pop("reduce_scatter_tensor", 0)
            if rs:
                calls["reduce_scatter_single"] = rs
            ag = calls.pop("all_gather_into_tensor", 0)
            if ag:
                calls["all_gather_single"] = ag
            assert calls == _expected_calls(
                cfg, shape, batch["tokens"].shape[0]), (cfg.name, shape,
                                                        cfg.microbatches,
                                                        calls)
