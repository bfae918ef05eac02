"""The encoder-decoder slice end to end: whisper's smoke configuration
through the port's ``transformer.forward`` in train, prefill and decode
modes and through the serve steps (``make_prefill`` with frames, then
``make_serve_step``), against the JAX package on the same weights
(carried across with ``convert.params_from_jax``), the same tokens and
the same frames; the reference's decode-equals-train law on the port;
chameleon's smoke configuration (the ``vq_tokens`` front end: image
tokens are ids of the shared vocab) through ``ServeEngine.generate``;
learned positions on decoder-only models; and ``generate``'s refusal of
an encoder-decoder, which the reference's ``generate`` cannot run either
(it passes no frames).

Frames are N(0, 1) from numpy, ``enc_seq`` 37 (not a multiple of 16), so
the encoder and the cross-attention see a ragged key count.
Tolerances: float32 logits 1e-4 and identical greedy tokens (the only
differences are the summation orders of contractions and the sinusoidal
table's last bits, tests/test_torch_encdec.py); bfloat16 logits 5e-2,
the reference's own decode-vs-train tolerance (tests/test_archs.py)."""
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
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ENC_SEQ, MAX_SEQ = 37, 32


def _models(arch, dtype="float32", seed=0, max_seq=MAX_SEQ, **kw):
    kw |= dict(param_dtype=dtype, compute_dtype=dtype)
    if arch == "whisper_large_v3":
        kw.setdefault("enc_seq", ENC_SEQ)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    ms = max_seq if jcfg.pos == "learned" else 0
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(seed), ms)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _inputs(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                 dtype=np.float32) if cfg.is_enc_dec \
        else None
    return toks, frames


def _pair(frames, dtype):
    if frames is None:
        return None, None
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(frames).astype(jd), torch.from_numpy(frames)


def _close(got, exp, dtype, ctx):
    np.testing.assert_allclose(got.float().numpy(), np.float32(exp),
                               atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=ctx)


# --------------------------------------------------------------------------
# whisper
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_forward_train_prefill_decode_matches_jax(dtype):
    """The train forward's logits at every position; a prefill of 12
    tokens (every position's logits and the cross caches it leaves), then
    3 decode steps reading them."""
    jcfg, jp, tcfg, tp = _models("whisper_large_v3", dtype)
    B, S, extra = 2, 12, 3
    toks, frames = _inputs(jcfg, B, S + extra)
    jf, tf = _pair(frames, dtype)
    jl, _, _ = jtransformer.forward(jcfg, jp, jnp.asarray(toks), frames=jf)
    tl, _, aux = ttransformer.forward(tcfg, tp, torch.from_numpy(toks),
                                      frames=tf)
    assert float(aux) == 0.0
    _close(tl, jl, dtype, "train logits")
    jc, _ = jtransformer.init_cache(jcfg, B, S + extra)
    tc = ttransformer.init_cache(tcfg, B, S + extra, device="cpu")
    jl, jc, _ = jtransformer.forward(jcfg, jp, jnp.asarray(toks[:, :S]),
                                     mode="prefill", cache=jc, frames=jf)
    ops.reset_launch_counts()
    tl, tc, _ = ttransformer.forward(tcfg, tp, torch.from_numpy(toks[:, :S]),
                                     mode="prefill", cache=tc, frames=tf)
    assert ops.launch_counts()["flash_attention"] == 0     # the CPU route
    _close(tl, jl, dtype, "prefill logits")
    for i, c in enumerate(tc):
        for key in ("cross_k", "cross_v"):
            _close(c[key], jc[0][key][i], dtype, f"layer {i} {key}")
    for t in range(S, S + extra):
        tok = toks[:, t:t + 1]
        jl, jc, _ = jtransformer.forward(jcfg, jp, jnp.asarray(tok),
                                         mode="decode", cache=jc, pos=t)
        tl, tc, _ = ttransformer.forward(tcfg, tp, torch.from_numpy(tok),
                                         mode="decode", cache=tc, pos=t)
        _close(tl, jl, dtype, f"decode logits at pos {t}")


def _greedy_jax(cfg, p, toks, frames, new):
    B, S = toks.shape
    cache, _ = jtransformer.init_cache(cfg, B, S + new)
    lg, cache = jstep.make_prefill(cfg)(p, jnp.asarray(toks), cache, frames)
    out = []
    for t in range(new):
        last = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
        out.append(last)
        if t < new - 1:
            lg, cache = jstep.make_serve_step(cfg)(
                p, cache, jnp.asarray(last[:, None]), S + t)
    return np.stack(out, 1)


def _greedy_port(cfg, p, toks, frames, new):
    B, S = toks.shape
    cache = ttransformer.init_cache(cfg, B, S + new, device="cpu")
    lg, cache = tstep.make_prefill(cfg)(p, torch.from_numpy(toks), cache,
                                        frames)
    out = []
    for t in range(new):
        last = lg.argmax(-1)
        out.append(last.numpy())
        if t < new - 1:
            lg, cache = tstep.make_serve_step(cfg)(p, cache, last[:, None],
                                                   S + t)
    return np.stack(out, 1)


def test_whisper_serve_steps_greedy_tokens_match_jax_f32():
    """The serving entry points of an encoder-decoder, each side on its
    own greedy tokens: prefill with frames, then 8 serve steps."""
    jcfg, jp, tcfg, tp = _models("whisper_large_v3")
    toks, frames = _inputs(jcfg, 3, 10, seed=4)
    jf, tf = _pair(frames, "float32")
    exp = _greedy_jax(jcfg, jp, toks, jf, 9)
    got = _greedy_port(tcfg, tp, toks, tf, 9)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_decode_matches_train_logits(dtype):
    """tests/test_archs.py's law on the port: prefill(S) with frames, then
    decode at S..S+2, equals the train forward at those positions
    (5e-2)."""
    _, _, tcfg, tp = _models("whisper_large_v3", dtype)
    B, S, extra = 2, 12, 3
    toks, frames = _inputs(tcfg, B, S + extra, seed=3)
    toks, frames = torch.from_numpy(toks), torch.from_numpy(frames)
    cache = ttransformer.init_cache(tcfg, B, S + extra, device="cpu")
    _, cache, _ = ttransformer.forward(tcfg, tp, toks[:, :S], mode="prefill",
                                       cache=cache, frames=frames)
    for t in range(S, S + extra):
        dec, cache, _ = ttransformer.forward(tcfg, tp, toks[:, t:t + 1],
                                             mode="decode", cache=cache,
                                             pos=t)
        full, _, _ = ttransformer.forward(tcfg, tp, toks[:, :t + 1],
                                          frames=frames)
        np.testing.assert_allclose(dec[:, 0].float().numpy(),
                                   full[:, t].float().numpy(), atol=5e-2,
                                   rtol=5e-2)


def test_generate_refuses_an_encoder_decoder():
    _, _, tcfg, tp = _models("whisper_large_v3")
    engine = TEngine(tcfg, tp, max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="make_prefill.*make_serve_step"):
        engine.generate([[1, 2, 3]], max_new=2)


# --------------------------------------------------------------------------
# chameleon, learned positions on decoder-only models
# --------------------------------------------------------------------------

def test_chameleon_generate_matches_jax_f32():
    """chameleon's smoke configuration (QK-norm, GQA 4/2): ragged prompts
    of ids anywhere in the shared vocab, 6 greedy tokens."""
    jcfg, jp, tcfg, tp = _models("chameleon_34b")
    assert tcfg.frontend == "vq_tokens"
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, n).tolist() for n in (9, 14, 5)]
    exp = JEngine(jcfg, jp, max_batch=4, max_seq=MAX_SEQ).generate(
        prompts, max_new=6)
    got = TEngine(tcfg, tp, max_batch=4, max_seq=MAX_SEQ,
                  device="cpu").generate(prompts, max_new=6)
    assert [g.tokens for g in got] == [e.tokens for e in exp]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chameleon_prefill_then_decode_matches_jax(dtype):
    jcfg, jp, tcfg, tp = _models("chameleon_34b", dtype)
    toks, _ = _inputs(jcfg, 2, 15)
    S = 12
    jc, _ = jtransformer.init_cache(jcfg, 2, 15)
    tc = ttransformer.init_cache(tcfg, 2, 15, device="cpu")
    jl, jc = jstep.make_prefill(jcfg)(jp, jnp.asarray(toks[:, :S]), jc)
    tl, tc = tstep.make_prefill(tcfg)(tp, torch.from_numpy(toks[:, :S]), tc)
    _close(tl, jl, dtype, "prefill logits")
    for t in range(S, 15):
        tok = toks[:, t:t + 1]
        jl, jc = jstep.make_serve_step(jcfg)(jp, jc, jnp.asarray(tok), t)
        tl, tc = tstep.make_serve_step(tcfg)(tp, tc, torch.from_numpy(tok),
                                             t)
        _close(tl, jl, dtype, f"decode logits at pos {t}")


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_235b_a22b"])
def test_learned_positions_match_jax_f32(arch):
    """``pos="learned"`` on decoder-only models (no rotation; ``dec_pos``
    rows added to the embeddings): the train forward's logits, then
    ``generate`` to the last learned position, each within the
    reference's tolerance and on the same tokens."""
    jcfg, jp, tcfg, tp = _models(arch, pos="learned", max_seq=16)
    toks, _ = _inputs(jcfg, 2, 16)
    jl, _, _ = jtransformer.forward(jcfg, jp, jnp.asarray(toks))
    tl, _, _ = ttransformer.forward(tcfg, tp, torch.from_numpy(toks))
    _close(tl, jl, "float32", "train logits")
    prompts = [toks[0, :11].tolist(), toks[1, :7].tolist()]
    exp = JEngine(jcfg, jp, max_batch=2, max_seq=16).generate(
        prompts, max_new=8)
    got = TEngine(tcfg, tp, max_batch=2, max_seq=16,
                  device="cpu").generate(prompts, max_new=8)
    assert [g.tokens for g in got] == [e.tokens for e in exp]
    assert got[0].steps == 16 - 11 + 1          # stopped at max_seq


@pytest.mark.parametrize("arch", ["whisper_large_v3", "chameleon_34b"])
def test_full_configs_pass_the_scope_check(arch):
    """The two configurations the port refused before this slice: the
    scope check passes at full size, and the port's parameter count at a
    smoke size equals param_count()'s formula's inputs' tree."""
    cfg = tconfigs.get_config(arch)
    ttransformer.check_supported(cfg)
    smoke = tconfigs.get_smoke(arch)
    p = ttransformer.make_params(smoke, torch.Generator().manual_seed(0),
                                 device="cpu", max_seq=8)
    jp, _ = jtransformer.make_params(jconfigs.get_smoke(arch),
                                     jax.random.key(0), 8)
    assert sum(t.numel() for t in p.parameters()) == \
        sum(a.size for a in jax.tree.leaves(jp))
