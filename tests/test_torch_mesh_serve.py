"""The sharded serving entry points on spawned CPU ranks (gloo):
``make_prefill(cfg, mesh)``, ``make_serve_step(cfg, mesh)`` and
``ServeEngine(..., mesh=)`` on the (data, model) meshes (2, 1) and
(1, 2), for a dense model (smoke hymba: attention, SSM, a sliding
window) and an MoE one (smoke qwen3-moe, whose 8 experts split 4 a rank
on (1, 2)), in float32 from the JAX package's weights
(``convert.params_from_jax``).

Each rank holds its blocks of the parameters (``shard_params``) and the
cache of its rows.  A batch of 4 splits over (2, 1), two rows a rank,
whose logits the steps gather back; on (1, 2) every rank holds every
row.  Every rank's logits, of the prefill and of three decode steps on
the same tokens, are held to the one-device port's and to
``jax.jit(repro.train.step.make_prefill / make_serve_step)``'s within
the serving band of tests/test_torch_moe_slice.py (1e-4, float32); the
engine's greedy tokens equal the one-device engine's and the reference
engine's, for 4 prompts (split over (2, 1)) and for 3 (not split).
"""
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
from repro_torch.core import shard_sim
from repro_torch.models import transformer as ttransformer
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.train import step as tstep

import torch_spmd

torch.set_num_threads(1)
ARCHS = ["hymba_1_5b", "qwen3_moe_235b_a22b"]
SHAPES = [(2, 1), (1, 2)]
B, S, MAX_SEQ, STEPS = 4, 12, 24, 3
TOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _models(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **F32)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **F32)
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _inputs(vocab):
    """Right-padded prompt tokens (B, S), the decode steps' (B, 1)
    tokens, and two prompt lists (4 prompts, then 3)."""
    rng = np.random.default_rng(5)
    toks = np.zeros((B, S), np.int64)
    for i, n in enumerate((S, 7, 9, 5)):
        toks[i, :n] = rng.integers(1, vocab, n)
    steps = [rng.integers(1, vocab, (B, 1)) for _ in range(STEPS)]
    prompts = [rng.integers(1, vocab, n).tolist() for n in (11, 6, 9, 4)]
    return toks, steps, [prompts, prompts[:3]]


def _one_device(tcfg, tp, toks, steps, prompts):
    """The same calls on one device: (logits a call, tokens a list)."""
    cache = ttransformer.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    with torch.no_grad():
        lg, cache = tstep.make_prefill(tcfg)(tp, torch.from_numpy(toks),
                                             cache)
        out = [lg]
        for i, t in enumerate(steps):
            lg, cache = tstep.make_serve_step(tcfg)(
                tp, cache, torch.from_numpy(t), S + i)
            out.append(lg)
    eng = TEngine(tcfg, tp, max_batch=B, max_seq=MAX_SEQ, device="cpu")
    return out, [[g.tokens for g in eng.generate(p, max_new=STEPS + 2)]
                 for p in prompts]


def _jax(jcfg, jp, toks, steps, prompts):
    """The reference's jitted serve steps and its engine."""
    jc, _ = jtransformer.init_cache(jcfg, B, MAX_SEQ)
    lg, jc = jax.jit(jstep.make_prefill(jcfg))(
        jp, jnp.asarray(toks, jnp.int32), jc)
    out, decode = [np.asarray(lg)], jax.jit(jstep.make_serve_step(jcfg))
    for i, t in enumerate(steps):
        lg, jc = decode(jp, jc, jnp.asarray(t, jnp.int32),
                        jnp.int32(S + i))
        out.append(np.asarray(lg))
    eng = JEngine(jcfg, jp, max_batch=B, max_seq=MAX_SEQ)
    return out, [[g.tokens for g in eng.generate(p, max_new=STEPS + 2)]
                 for p in prompts]


@pytest.fixture(scope="module")
def runs():
    """Every (arch, shape) case through one spawn of two ranks, with its
    one-device and JAX counterparts."""
    cases, refs = [], {}
    for arch in ARCHS:
        jcfg, jp, tcfg, tp = _models(arch)
        toks, steps, prompts = _inputs(tcfg.vocab)
        refs[arch] = (_one_device(tcfg, tp, toks, steps, prompts),
                      _jax(jcfg, jp, toks, steps, prompts))
        plain = {n: t.detach() for n, t in tp.named_parameters()}
        cases += [(arch, shape, (
            tcfg, plain, torch.from_numpy(toks),
            [torch.from_numpy(t) for t in steps], prompts, shape, MAX_SEQ))
            for shape in SHAPES]
    res = shard_sim.spawn(torch_spmd.plan, 2, ([
        ("mesh_serve", args) for _, _, args in cases],))
    return cases, refs, res


@pytest.mark.parametrize("shape", SHAPES, ids=["data2", "model2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_one_device_and_jax(runs, arch, shape):
    cases, refs, res = runs
    i = [(a, s) for a, s, _ in cases].index((arch, shape))
    (one, one_tokens), (jx, jx_tokens) = refs[arch]
    assert one_tokens == jx_tokens            # the references agree
    for r, (outs, mods) in enumerate(res):
        assert not mods                       # the port stands alone
        logits, tokens, rows, calls = outs[i]
        tag = (arch, shape, r)
        assert rows == (B // 2 if shape == (2, 1) else B), tag
        assert len(logits) == 1 + STEPS
        for k, (got, o, j) in enumerate(zip(logits, one, jx)):
            assert got.shape == o.shape == (B, o.shape[-1]), (tag, k)
            np.testing.assert_allclose(got.numpy(), o.numpy(), atol=TOL,
                                       rtol=TOL, err_msg=f"{tag} call {k}")
            np.testing.assert_allclose(got.numpy(), j, atol=TOL, rtol=TOL,
                                       err_msg=f"{tag} call {k} vs JAX")
        assert tokens == one_tokens, tag
        # the step gathers its parameters from the blocks each call
        gathers = sum(calls.get(n, 0) for n in torch_spmd.GATHERS)
        assert gathers > 0, (tag, calls)
