"""The serving slice end to end: smoke configurations through the port's
``transformer.forward`` (prefill, then decode steps on the cache it left)
and ``ServeEngine.generate``, against the JAX package on the same weights
(carried across with ``convert.params_from_jax``) and the same tokens.

hymba (sliding window 8, parallel attention + Mamba) is the slice's
target; gemma2 (softcap, swa/attn alternation, geglu, tied embeddings)
and llama (full attention) run the same modules.  Prompts are longer
than the window, so the prefill's ring roll and the decode ring both run.

Tolerances: float32 logits 1e-4 and identical greedy tokens (the only
differences are the summation orders of contractions); bfloat16 logits
5e-2, the reference's own decode-vs-train tolerance
(tests/test_archs.py): the port's attention keeps probabilities in
float32 for the value product, the reference casts them to bf16 first."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttransformer
from repro_torch.serve.engine import ServeEngine as TEngine

torch.set_num_threads(1)
ARCHS = ["hymba_1_5b", "gemma2_9b", "llama3_2_1b"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _models(arch, dtype, seed=0):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _close(got, exp, dtype, ctx):
    np.testing.assert_allclose(got.float().numpy(), np.float32(exp),
                               atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=ctx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_then_decode_matches_jax(arch, dtype):
    """Prefill 20 tokens (2.5 windows), then decode 3: logits of every
    position of the prefill and of each decode step."""
    jcfg, jp, tcfg, tp = _models(arch, dtype)
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
    assert ops.launch_counts()["flash_attention"] == 0    # the CPU route
    assert float(aux) == 0.0 and len(tc) == tcfg.n_layers
    _close(tl, jl, dtype, "prefill logits")
    for t in range(S, S + extra):
        tok = toks[:, t:t + 1]
        jl, jc, _ = jtransformer.forward(jcfg, jp, jnp.asarray(tok),
                                         mode="decode", cache=jc, pos=t)
        tl, tc, _ = ttransformer.forward(tcfg, tp, torch.from_numpy(tok),
                                         mode="decode", cache=tc, pos=t)
        _close(tl, jl, dtype, f"decode logits at pos {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_jax_f32(arch):
    """ServeEngine.generate with ragged prompts longer than the window:
    the same greedy tokens as the reference engine."""
    jcfg, jp, tcfg, tp = _models(arch, "float32")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, jcfg.vocab, n).tolist() for n in (19, 13, 9)]
    exp = JEngine(jcfg, jp, max_batch=4, max_seq=40).generate(
        prompts, max_new=6)
    got = TEngine(tcfg, tp, max_batch=4, max_seq=40, device="cpu").generate(
        prompts, max_new=6)
    assert [g.tokens for g in got] == [e.tokens for e in exp]
    assert [(g.prompt_len, g.steps) for g in got] == \
        [(e.prompt_len, e.steps) for e in exp]


def test_generate_eos_max_seq_and_sampling():
    """eos stops a sequence; max_seq caps decoding; temperature sampling
    is reproducible from its seed and stays in the vocabulary."""
    jcfg, jp, tcfg, tp = _models("hymba_1_5b", "float32")
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12, 13], [3, 4]]
    eng = TEngine(tcfg, tp, max_batch=2, max_seq=14, device="cpu")
    greedy = eng.generate(prompts, max_new=8)
    assert all(len(r.tokens) == len(p) + 1 + (14 - 9)
               for r, p in zip(greedy, prompts))       # capped at max_seq
    eos = greedy[0].tokens[len(prompts[0]) + 1]
    stopped = eng.generate(prompts, max_new=8, eos=eos)
    assert stopped[0].tokens == greedy[0].tokens[:len(prompts[0]) + 2]
    ref = JEngine(jcfg, jp, max_batch=2, max_seq=14).generate(
        prompts, max_new=8, eos=eos)
    assert [r.tokens for r in stopped] == [r.tokens for r in ref]
    a = eng.generate(prompts, max_new=4, temperature=1.0, seed=7)
    b = eng.generate(prompts, max_new=4, temperature=1.0, seed=7)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert all(0 <= t < tcfg.vocab for r in a for t in r.tokens)
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate(prompts * 2)
