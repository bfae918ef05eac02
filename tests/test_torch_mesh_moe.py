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
  * The collectives a sharded step calls, counted by name against what
    the specs say it must call, with microbatches the batch ranks do not
    divide too (their counts' all-reduce, and one of the top-1 counts a
    wave for MoE).
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


def _expected_calls(cfg, shape, B=4):
    """The collectives one sharded step must call on a (data, model) mesh
    of ``shape`` on a batch of ``B`` rows it splits (smoke configs: remat
    "nothing", no chunked loss; with microbatches, one all-reduce of
    their label counts and, for MoE, one of the top-1 counts a wave in
    place of one a layer)."""
    sizes = {"data": shape[0], "model": shape[1]}
    sh, _ = tstep.state_shardings(cfg, _Mesh(shape))
    logical = ttransformer.param_specs(cfg)
    split = shape[0] > 1
    gathers = scatters = reduces = 0
    for n, s in sh["params"].items():
        keep = tstep._expert_dims(logical[n], s.spec)
        axes = [a for d, e in enumerate(s.spec) if d not in keep
                for a in ((e,) if isinstance(e, str) else e or ())]
        gathers += sum(sizes[a] > 1 for a in axes)
        if split:
            if "data" in axes:
                scatters += 1
            else:
                reduces += 1
    moe_layers = cfg.n_layers if cfg.is_moe else 0
    ep = cfg.is_moe and cfg.n_experts % shape[1] == 0 and shape[1] > 1
    gathers += moe_layers if ep else 0          # the slice's backward
    reduces += 2 * moe_layers if ep else 0      # the sum, the copy's bwd
    axes_over_1 = sum(v > 1 for v in sizes.values())
    reduces += axes_over_1                      # the norm
    if split and cfg.microbatches > 1:
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
                        ("qwen3_moe_235b_a22b", (2, 1))):
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
