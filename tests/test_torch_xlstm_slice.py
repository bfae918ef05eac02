"""Recurrent serving end to end: xlstm-350m's smoke configuration
(alternating mLSTM and sLSTM blocks, no FFN, tied embeddings) and
hymba's smoke configuration with ``block_pattern=("mamba",)`` (the Mamba
mixer alone, with its FFN) through the port's ``transformer.forward``
(prefill, then decode steps on the state it left), the serve steps and
``ServeEngine.generate``, against the JAX package on the same weights
(carried across with ``convert.params_from_jax``) and the same tokens.

Right-padded prompts run the recurrence through the pad positions in
both packages, as the reference does.

Tolerances: float32 logits 1e-4 at every position, the states too, and
identical greedy tokens.  bfloat16 5e-2, the reference's own
decode-vs-train tolerance (tests/test_archs.py), on the xLSTM logits at
every position; the same law holds the port's decode steps against its
own train forward.  The mamba configuration's bf16 logits sit further
from the truth than that in the reference itself: against a float32
forward of the same bf16 weights they are off by up to 0.08-0.16
(seeds 0-2), and the reference's scanned and unscanned forwards differ
by 1.41 times the limit.  So in bf16 each package is also held to that
float32 forward, and the port's mean error must be no larger than 1.25
times the reference's (it is 0.88-1.05 times it at seeds 0-2; a single
element's error is noisier, up to 1.5 times the reference's largest).
Greedy tokens in bfloat16 agree up to
the steps where the reference's two best logits sit within 5e-2 of each
other: a bf16 logit's ulp is 2^-8 of its size, so such near-ties break
either way."""
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
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttransformer
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.train import step as tstep

torch.set_num_threads(1)
# (arch, config overrides): the xLSTM pattern, and the mamba block kind
ARCHS = {"xlstm": ("xlstm_350m", {}),
         "mamba": ("hymba_1_5b", {"block_pattern": ("mamba",)})}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STATE_KEYS = {"mlstm": {"C", "n", "m"}, "slstm": {"h", "c", "n", "m"},
              "mamba": {"ssm"}}


def _cfgs(name, dtype=None, **kw):
    arch, base = ARCHS[name]
    kw = base | kw
    if dtype:
        kw |= dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


def _models(name, dtype=None, seed=0, **kw):
    jcfg, tcfg = _cfgs(name, dtype, **kw)
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _close(got, exp, dtype, ctx):
    np.testing.assert_allclose(got.float().numpy(), np.float32(exp),
                               atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=ctx)


@pytest.mark.parametrize("name,attn_chunk,dtype", [
    ("xlstm", 512, "float32"), ("xlstm", 8, "float32"),
    ("mamba", 512, "float32"), ("xlstm", 512, "bfloat16"),
    ("xlstm", 8, "bfloat16")])
def test_forward_prefill_then_decode_matches_jax(name, attn_chunk, dtype):
    """Prefill 20 tokens, then decode 3: logits of every position of the
    prefill and of each decode step (attn_chunk 8: the mLSTM's parallel
    form in three query chunks, the last ragged)."""
    jcfg, jp, tcfg, tp = _models(name, dtype, attn_chunk=attn_chunk)
    B, S, extra = 2, 20, 3
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, S + extra)).astype(np.int32)
    jc, _ = jtransformer.init_cache(jcfg, B, S + extra)
    tc = ttransformer.init_cache(tcfg, B, S + extra, device="cpu")
    jl, jc, _ = jtransformer.forward(jcfg, jp, jnp.asarray(toks[:, :S]),
                                     mode="prefill", cache=jc)
    ops.reset_launch_counts()
    tl, tc, aux = ttransformer.forward(tcfg, tp, torch.from_numpy(toks[:, :S]),
                                       mode="prefill", cache=tc)
    assert ops.launch_counts()["ssm_scan"] == 0            # the CPU route
    assert float(aux) == 0.0 and len(tc) == tcfg.n_layers
    _close(tl, jl, dtype, "prefill logits")
    for t in range(S, S + extra):
        tok = toks[:, t:t + 1]
        jl, jc, _ = jtransformer.forward(jcfg, jp, jnp.asarray(tok),
                                         mode="decode", cache=jc, pos=t)
        tl, tc, _ = ttransformer.forward(tcfg, tp, torch.from_numpy(tok),
                                         mode="decode", cache=tc, pos=t)
        _close(tl, jl, dtype, f"decode logits at pos {t}")
    if dtype != "float32":
        return
    # the states the decode steps left, layer by layer
    for i, c in enumerate(tc):
        ref = jc[i % tcfg.period]
        for k, v in c.items():
            leaves = v.items() if isinstance(v, dict) else [(None, v)]
            for sub, t in leaves:
                r = ref[k] if sub is None else ref[k][sub]
                _close(t, np.asarray(r[i // tcfg.period]), dtype,
                       f"layer {i} state {k} {sub or ''}")


@pytest.mark.parametrize("name,dtype", [
    ("xlstm", "float32"), ("mamba", "float32"), ("xlstm", "bfloat16")])
def test_train_forward_matches_jax(name, dtype):
    jcfg, jp, tcfg, tp = _models(name, dtype)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    jl, _, _ = jtransformer.forward(jcfg, jp, jnp.asarray(toks))
    tl, cache, _ = ttransformer.forward(tcfg, tp, torch.from_numpy(toks))
    assert cache is None
    _close(tl, jl, dtype, "train logits")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(ARCHS))
def test_bf16_error_no_larger_than_the_references(name, seed):
    """bf16 weights and activations, a train forward of 20 tokens and a
    prefill of them followed by 3 decode steps: against the float32
    forward of the same (bf16-valued) weights, the port's mean error is
    at most 1.25 times the reference's."""
    jcfg, jp, tcfg, tp = _models(name, "bfloat16", seed=seed)
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    jcf = dataclasses.replace(jcfg, **f32)
    jpf = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    B, S, extra = 2, 20, 3
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, S + extra)).astype(np.int32)

    def jrun(cfg, p):
        out = [jtransformer.forward(cfg, p, jnp.asarray(toks[:, :S]))[0]]
        c, _ = jtransformer.init_cache(cfg, B, S + extra)
        lg, c, _ = jtransformer.forward(cfg, p, jnp.asarray(toks[:, :S]),
                                        mode="prefill", cache=c)
        out.append(lg)
        for t in range(S, S + extra):
            lg, c, _ = jtransformer.forward(cfg, p, jnp.asarray(
                toks[:, t:t + 1]), mode="decode", cache=c, pos=t)
            out.append(lg)
        return np.concatenate([np.float32(o).ravel() for o in out])

    def trun():
        x = torch.from_numpy(toks)
        out = [ttransformer.forward(tcfg, tp, x[:, :S])[0]]
        c = ttransformer.init_cache(tcfg, B, S + extra, device="cpu")
        lg, c, _ = ttransformer.forward(tcfg, tp, x[:, :S], mode="prefill",
                                        cache=c)
        out.append(lg)
        for t in range(S, S + extra):
            lg, c, _ = ttransformer.forward(tcfg, tp, x[:, t:t + 1],
                                            mode="decode", cache=c, pos=t)
            out.append(lg)
        return np.concatenate([o.float().numpy().ravel() for o in out])

    truth = jrun(jcf, jpf)
    ref, port = np.abs(jrun(jcfg, jp) - truth), np.abs(trun() - truth)
    assert port.mean() <= 1.25 * ref.mean(), (port.mean(), ref.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_matches_train_logits(name, dtype):
    """tests/test_archs.py's law on the port: prefill(S) then decode at
    S..S+2 equals the train forward at those positions (5e-2).  It holds
    the mLSTM's recurrent step against its parallel form and the state
    ``_mlstm_state_from_seq`` builds."""
    _, _, tcfg, tp = _models(name, dtype)
    B, S, extra = 2, 12, 3
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, (B, S + extra)))
    cache = ttransformer.init_cache(tcfg, B, S + extra, device="cpu")
    _, cache, _ = ttransformer.forward(tcfg, tp, toks[:, :S], mode="prefill",
                                       cache=cache)
    for t in range(S, S + extra):
        dec, cache, _ = ttransformer.forward(tcfg, tp, toks[:, t:t + 1],
                                             mode="decode", cache=cache,
                                             pos=t)
        full, _, _ = ttransformer.forward(tcfg, tp, toks[:, :t + 1])
        np.testing.assert_allclose(dec[:, 0].float().numpy(),
                                   full[:, t].float().numpy(), atol=5e-2,
                                   rtol=5e-2)


@pytest.mark.parametrize("name", list(ARCHS))
def test_serve_steps_on_right_padded_prompts_match_jax(name):
    """make_prefill / make_serve_step on prompts right-padded with 0, as
    the engine pads them: both packages run the recurrence through the
    pads, so a shorter prompt's state has absorbed them; the port keeps
    that (its logits differ from the unpadded prompt's)."""
    jcfg, jp, tcfg, tp = _models(name, "float32")
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
    for pos in (S, S + 1):
        jl, jc = jstep.make_serve_step(jcfg)(jp, jc, jnp.asarray(tok), pos)
        tl, tc = tstep.make_serve_step(tcfg)(tp, tc, torch.from_numpy(tok),
                                             pos)
        _close(tl, jl, "float32", f"decode logits at pos {pos}")
        tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    # the 9-token prompt alone, without the pads, ends elsewhere
    alone = ttransformer.init_cache(tcfg, 1, max_seq, device="cpu")
    short, _ = tstep.make_prefill(tcfg)(
        tp, torch.from_numpy(toks[1:2, :9]), alone)
    padded, _ = tstep.make_prefill(tcfg)(
        tp, torch.from_numpy(toks[1:2]),
        ttransformer.init_cache(tcfg, 1, max_seq, device="cpu"))
    assert (short - padded).abs().max() > 1e-3


@pytest.mark.parametrize("name", list(ARCHS))
def test_generate_greedy_matches_jax_f32(name):
    """ServeEngine.generate with ragged prompts: the same greedy tokens as
    the reference engine."""
    jcfg, jp, tcfg, tp = _models(name, "float32")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, jcfg.vocab, n).tolist() for n in (19, 13, 9)]
    exp = JEngine(jcfg, jp, max_batch=4, max_seq=40).generate(
        prompts, max_new=6)
    got = TEngine(tcfg, tp, max_batch=4, max_seq=40, device="cpu").generate(
        prompts, max_new=6)
    assert [g.tokens for g in got] == [e.tokens for e in exp]
    assert [(g.prompt_len, g.steps) for g in got] == \
        [(e.prompt_len, e.steps) for e in exp]


@pytest.mark.parametrize("name", list(ARCHS))
def test_greedy_tokens_bf16_match_jax_up_to_near_ties(name):
    """bfloat16, right-padded ragged prompts, 8 greedy steps through the
    serve steps, the port fed the reference's tokens: at every step each
    sequence's argmax is the reference's, or the reference's two best
    logits lie within the bf16 tolerance (a near-tie).  The setting has
    at least one step decided by a clear margin in every sequence."""
    jcfg, jp, tcfg, tp = _models(name, "bfloat16")
    lens, S, new = (19, 13, 9), 19, 8
    toks = np.zeros((3, S), np.int32)
    rng = np.random.default_rng(2)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, jcfg.vocab, n)
    jc, _ = jtransformer.init_cache(jcfg, 3, S + new)
    tc = ttransformer.init_cache(tcfg, 3, S + new, device="cpu")
    jl, jc = jstep.make_prefill(jcfg)(jp, jnp.asarray(toks), jc)
    tl, tc = tstep.make_prefill(tcfg)(tp, torch.from_numpy(toks), tc)
    clear = np.zeros(3, bool)
    for step in range(new):
        exp = np.float32(jl)
        top2 = np.sort(exp, axis=-1)[:, -2:]
        near = top2[:, 1] - top2[:, 0] < TOL["bfloat16"]
        got = tl.float().numpy().argmax(-1)
        want = exp.argmax(-1)
        bad = (got != want) & ~near
        assert not bad.any(), (step, got, want, top2)
        clear |= ~near
        tok = want[:, None].astype(np.int32)
        jl, jc = jstep.make_serve_step(jcfg)(jp, jc, jnp.asarray(tok),
                                             S + step)
        tl, tc = tstep.make_serve_step(tcfg)(tp, tc, torch.from_numpy(tok),
                                             S + step)
    assert clear.all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_make_params_tree_matches_params_from_jax(name, dtype):
    """The port's own init gives the tree params_from_jax gives: the same
    keys, shapes and dtypes (the mLSTM's wi, wf and the sLSTM's b, R
    float32 whatever param_dtype); bf16 leaves cross bit for bit."""
    jcfg, jp, tcfg, tp = _models(name, dtype)
    own = ttransformer.make_params(tcfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    spec = lambda m: {k: (tuple(v.shape), v.dtype)
                      for k, v in m.named_parameters()}
    assert spec(own) == spec(tp)
    for i, layer in enumerate(tp["layers"]):
        kind = ttransformer.layer_kind(tcfg, i)
        ref = jp["layers"][i % tcfg.period]["mixer"]
        for k, v in layer["mixer"].named_parameters():
            exp = np.asarray(ref[k][i // tcfg.period])
            assert str(v.dtype).removeprefix("torch.") == str(exp.dtype), k
            if v.dtype == torch.bfloat16:
                np.testing.assert_array_equal(v.view(torch.int16).numpy(),
                                              exp.view(np.int16))
            else:
                np.testing.assert_array_equal(v.numpy(), exp)
        if kind == "mlstm":
            assert {layer["mixer"][k].dtype for k in ("wi", "wf")} == \
                {torch.float32}
        if kind == "slstm":
            assert {layer["mixer"][k].dtype for k in ("b", "R")} == \
                {torch.float32}
    assert ("ffn" in own["layers"][0]) == (tcfg.d_ff > 0)


@pytest.mark.parametrize("name", list(ARCHS))
def test_init_cache_holds_what_each_kind_needs(name):
    """No KV leaves on mLSTM, sLSTM and mamba layers: each layer's cache
    has the reference's keys for its kind, at its shapes and dtypes."""
    jcfg, tcfg = _cfgs(name)
    jc, _ = jtransformer.init_cache(jcfg, 3, 40)
    tc = ttransformer.init_cache(tcfg, 3, 40, device="cpu")
    assert len(tc) == tcfg.n_layers
    for i, c in enumerate(tc):
        kind = ttransformer.layer_kind(tcfg, i)
        ref = jc[i % tcfg.period]
        assert set(c) == STATE_KEYS[kind] == set(ref)
        flat = lambda d: {k: v for k, v in d.items()
                          if not isinstance(v, dict)} | {
            f"{k}.{s}": w for k, v in d.items() if isinstance(v, dict)
            for s, w in v.items()}
        for k, v in flat(c).items():
            r = flat(ref)[k]
            assert tuple(v.shape) == tuple(r.shape[1:]), (i, k)
            assert str(v.dtype).removeprefix("torch.") == str(r.dtype), (i, k)
            assert not v.any(), (i, k)


@pytest.mark.parametrize("name", list(ARCHS))
def test_full_configs_are_supported(name):
    """The full configurations pass the scope check and get their caches,
    whose size does not depend on max_seq (parameters at full size do not
    fit this test's budget)."""
    arch, kw = ARCHS[name]
    cfg = dataclasses.replace(tconfigs.get_config(arch), **kw)
    ttransformer.check_supported(cfg)
    size = lambda S: sum(
        t.numel() * t.element_size() for c in ttransformer.init_cache(
            cfg, 1, S, device="cpu") for v in c.values()
        for t in (v.values() if isinstance(v, dict) else [v]))
    assert size(4) == size(64) > 0
    cache = ttransformer.init_cache(cfg, 1, 4, device="cpu")
    assert len(cache) == cfg.n_layers
    if name == "xlstm":
        assert cache[0]["C"].shape == (1, cfg.n_heads, cfg.head_dim,
                                       cfg.head_dim)
        assert cache[1]["h"].shape == (1, cfg.d_model)


def test_unknown_block_kind_raises():
    _, tcfg = _cfgs("xlstm", block_pattern=("mlstm", "gru"))
    with pytest.raises(ValueError, match="gru"):
        ttransformer.check_supported(tcfg)
