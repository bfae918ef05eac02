"""MoE serving end to end: the smoke configurations of both MoE
architectures (qwen3-moe: QK-norm, GQA, no shared expert; moonshot: one
shared expert) through the port's ``transformer.forward`` (prefill, then
decode steps on the cache it left), the serve steps and
``ServeEngine.generate``, against the JAX package on the same weights
(carried across with ``convert.params_from_jax``) and the same tokens.

Every prompt position routes and takes capacity, right-padding included,
as in the reference.  Tolerances: float32 logits 1e-4 at every position
and identical greedy tokens; bfloat16 5e-2 on the logits a serve step
returns (the prefill's last position, then each decode step): the
reference's own tolerance for a serve step's logits (tests/test_archs.py,
decode against train).  Over all 20 prefill positions the bf16 rounding
noise of these two-layer models reaches 1.02 times that limit against the
reference's scanned forward, where the reference's scanned and unscanned
forwards of the same weights differ by up to 0.83 times it (both packages
round bf16 intermediates at other places; tests/test_torch_lm_slice.py).
The summed aux: rel 1e-5 in float32, 5e-3 in bfloat16 (it is computed
from the bf16 hidden states)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.serve.engine import ServeEngine as JEngine
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.train import step as tstep

torch.set_num_threads(1)
ARCHS = ["qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _models(arch, dtype, seed=0, **kw):
    kw |= dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _close(got, exp, dtype, ctx):
    np.testing.assert_allclose(got.float().numpy(), np.float32(exp),
                               atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=ctx)


def _counting_drops(monkeypatch, mod):
    """Wrap ``mod.moe_block`` so each call's ``dropped`` is recorded."""
    seen, orig = [], mod.moe_block

    def block(*a, **kw):
        out = orig(*a, **kw)
        seen.append(int(out[2]))
        return out

    monkeypatch.setattr(mod, "moe_block", block)
    return seen


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_then_decode_matches_jax(arch, dtype, cf,
                                                 monkeypatch):
    """Prefill 20 tokens, then decode 3: the prefill's logits (float32
    every position, bfloat16 the last), each decode step's and forward's
    summed aux; the prefill drops tokens, more of them at a capacity
    factor of 0.5."""
    jcfg, jp, tcfg, tp = _models(arch, dtype, capacity_factor=cf)
    B, S, extra = 2, 20, 3
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, S + extra)).astype(np.int32)
    jc, _ = jtransformer.init_cache(jcfg, B, S + extra)
    tc = ttransformer.init_cache(tcfg, B, S + extra, device="cpu")
    jl, jc, ja = jtransformer.forward(jcfg, jp, jnp.asarray(toks[:, :S]),
                                      mode="prefill", cache=jc)
    drops = _counting_drops(monkeypatch, tmoe)
    tl, tc, ta = ttransformer.forward(tcfg, tp, torch.from_numpy(toks[:, :S]),
                                      mode="prefill", cache=tc)
    assert len(drops) == tcfg.n_layers and ta.dtype == torch.float32
    assert sum(drops) > 0
    assert float(ta) == pytest.approx(float(ja), rel=TOL[dtype] / 10)
    assert float(ta) > 0
    if dtype == "float32":
        _close(tl, jl, dtype, "prefill logits")
    _close(tl[:, -1], np.float32(jl)[:, -1], dtype, "last prefill logits")
    for t in range(S, S + extra):
        tok = toks[:, t:t + 1]
        jl, jc, ja = jtransformer.forward(jcfg, jp, jnp.asarray(tok),
                                          mode="decode", cache=jc, pos=t)
        tl, tc, ta = ttransformer.forward(tcfg, tp, torch.from_numpy(tok),
                                          mode="decode", cache=tc, pos=t)
        _close(tl, jl, dtype, f"decode logits at pos {t}")
        assert float(ta) == pytest.approx(float(ja), rel=TOL[dtype] / 10)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_on_right_padded_prompts_match_jax(arch):
    """make_prefill / make_serve_step on prompts right-padded with 0, as
    the engine pads them: the pad positions route and take capacity in
    both packages (the capacity factor 0.5 makes them crowd real tokens
    out), so the logits agree only if the port counts them too."""
    jcfg, jp, tcfg, tp = _models(arch, "float32", capacity_factor=0.5)
    lens, S, max_seq = (17, 9, 4), 17, 24
    toks = np.zeros((3, S), np.int32)
    rng = np.random.default_rng(3)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, jcfg.vocab, n)
    jc, _ = jtransformer.init_cache(jcfg, 3, max_seq)
    tc = ttransformer.init_cache(tcfg, 3, max_seq, device="cpu")
    jl, jc = jstep.make_prefill(jcfg)(jp, jnp.asarray(toks), jc)
    tl, tc = tstep.make_prefill(tcfg)(tp, torch.from_numpy(toks), tc)
    _close(tl, jl, "float32", "prefill logits")
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    jl, _ = jstep.make_serve_step(jcfg)(jp, jc, jnp.asarray(tok), S)
    tl, _ = tstep.make_serve_step(tcfg)(tp, tc, torch.from_numpy(tok), S)
    _close(tl, jl, "float32", "decode logits")
    # without the pad positions the routes, and so the logits, change
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, S, tcfg.d_model)).astype(np.float32))
    p = tp["layers"][0]["ffn"]
    full = tmoe.moe_scatter(p, x, tcfg)[0][:, :9]
    cut = tmoe.moe_scatter(p, x[:, :9], tcfg)[0]
    assert (full - cut).abs().max() > 1e-3


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_jax_f32(arch, cf):
    """ServeEngine.generate with ragged prompts: the same greedy tokens as
    the reference engine, with and without drops."""
    jcfg, jp, tcfg, tp = _models(arch, "float32", capacity_factor=cf)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, jcfg.vocab, n).tolist() for n in (19, 13, 9)]
    exp = JEngine(jcfg, jp, max_batch=4, max_seq=40).generate(
        prompts, max_new=6)
    got = TEngine(tcfg, tp, max_batch=4, max_seq=40, device="cpu").generate(
        prompts, max_new=6)
    assert [g.tokens for g in got] == [e.tokens for e in exp]
    assert [(g.prompt_len, g.steps) for g in got] == \
        [(e.prompt_len, e.steps) for e in exp]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_params_tree_matches_params_from_jax(arch, dtype):
    """The port's own init gives the tree params_from_jax gives: the same
    keys, shapes and dtypes (the router float32 whatever param_dtype)."""
    jcfg, _, tcfg, tp = _models(arch, dtype)
    own = ttransformer.make_params(tcfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    spec = lambda m: {k: (tuple(v.shape), v.dtype)
                      for k, v in m.named_parameters()}
    assert spec(own) == spec(tp)
    ffn = own["layers"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["wg"].shape == (tcfg.n_experts, tcfg.d_model, tcfg.d_expert)
    assert ("shared" in ffn) == bool(tcfg.n_shared_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_are_supported(arch):
    """The full configurations pass the scope check and get their caches
    (parameters at full size do not fit this test's budget)."""
    cfg = tconfigs.get_config(arch)
    ttransformer.check_supported(cfg)
    cache = ttransformer.init_cache(cfg, 1, 4, device="cpu")
    assert len(cache) == cfg.n_layers
    assert cache[0]["k"].shape == (1, 4, cfg.n_kv_heads, cfg.head_dim)
