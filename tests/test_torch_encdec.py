"""The encoder-decoder's modules in the port, each against its JAX twin on
the same numpy inputs and the same weights (carried across with
``convert.params_from_jax``): the sinusoidal table, the bidirectional
``enc`` attention block, cross-attention in prefill and decode, the
encoder, the parameter tree (``enc``, ``cross``, ``ln_x``, ``dec_pos``)
bit for bit, the cross caches, and the learned positions' edges.

The encoder runs at ``enc_seq`` 37, not a multiple of 16, so the kernel's
plain version sees a ragged key count.

Tolerances: float32 1e-5 (both packages round the same ops; contractions
sum in their own order), bfloat16 5e-2, the reference's own bf16
decode-vs-train tolerance (tests/test_archs.py).  The sinusoidal table
has a floor of its own: XLA:CPU's float32 exp, sin and cos are not
correctly rounded, the port's are (taken in float64, rounded once), and
at whisper's 1,500 positions the angles reach 1,500 rad, where one ulp
of a frequency moves a sine by about 1e-4.  The reference's own eager
and jitted tables differ by that much; the floor, 1.22e-4, is pinned
between ``SIN_FLOOR_LO`` and ``SIN_FLOOR`` below."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.train import step as tstep

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "whisper_large_v3"
ENC_SEQ, MAX_SEQ = 37, 24
# the reference's float32 table against a correctly rounded one at
# 1,500 x 1,280 (and its eager table against its jitted one): measured
# 1.22e-4, pinned between these two
SIN_FLOOR_LO, SIN_FLOOR = 1.2e-4, 1.25e-4


def _np(x):
    return np.float32(x) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, exp, dtype, ctx=""):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(exp), atol=tol, rtol=tol,
                               err_msg=ctx)


def _pair(a, dtype):
    return (jnp.asarray(a).astype(JD[dtype]),
            torch.from_numpy(np.float32(a)).to(TD[dtype]))


def _cfg(dtype="float32", **kw):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, enc_seq=ENC_SEQ) | kw
    return (dataclasses.replace(jconfigs.get_smoke(ARCH), **kw),
            dataclasses.replace(tconfigs.get_smoke(ARCH), **kw))


def _models(dtype="float32", seed=0, **kw):
    jcfg, tcfg = _cfg(dtype, **kw)
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(seed), MAX_SEQ)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _exact_table(seq, dim):
    """The reference's formula with its float32 products and division,
    exp, sin and cos in numpy's float64, each rounded once."""
    half = dim // 2
    e = (np.float32(-math.log(10000.0)) * np.arange(half, dtype=np.float32)
         / np.float32(max(half - 1, 1))).astype(np.float32)
    freq = np.exp(e.astype(np.float64)).astype(np.float32)
    ang = (np.arange(seq, dtype=np.float32)[:, None] * freq).astype(
        np.float64)
    return np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32)


# --------------------------------------------------------------------------
# sinusoidal positions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,dim", [(16, 64), (ENC_SEQ, 64), (1500, 1280)])
def test_sinusoidal_pos_matches_jax(seq, dim, dtype):
    """The smoke sizes within 1e-5 in float32 and equal in bf16; whisper's
    1,500 x 1,280 within SIN_FLOOR in float32, and in bf16 within one
    bf16 ulp of a value under 1 (2^-8), where the floor moves a rounding."""
    exp = np.float32(jlayers.sinusoidal_pos(seq, dim, JD[dtype]))
    got = tlayers.sinusoidal_pos(seq, dim, TD[dtype], "cpu")
    assert got.dtype == TD[dtype] and tuple(got.shape) == (seq, dim)
    err = np.abs(_np(got) - exp).max()
    if dtype == "float32":
        assert err <= (SIN_FLOOR if seq == 1500 else 1e-5), err
    else:
        assert err <= (2.0 ** -8 if seq == 1500 else 0.0), err


def test_sinusoidal_floor_is_the_references():
    """The port's table at 1,500 x 1,280 is the correctly rounded one, bit
    for bit; the reference's eager and jitted float32 tables each differ
    from it by 1.22e-4 (between SIN_FLOOR_LO and SIN_FLOOR), and from
    each other by more than 1e-5: the floor is XLA:CPU's
    transcendentals, not the port."""
    exact = _exact_table(1500, 1280)
    got = tlayers.sinusoidal_pos(1500, 1280, device="cpu").numpy()
    np.testing.assert_array_equal(got, exact)
    eager = np.asarray(jlayers.sinusoidal_pos(1500, 1280))
    jit = np.asarray(jax.jit(jlayers.sinusoidal_pos,
                             static_argnums=(0, 1))(1500, 1280))
    for name, ref in (("eager", eager), ("jit", jit)):
        assert SIN_FLOOR_LO < np.abs(ref - exact).max() <= SIN_FLOOR, name
    assert np.abs(eager - jit).max() > 1e-5


# --------------------------------------------------------------------------
# attention: the encoder's block and cross-attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_enc_attention_block_matches_jax(pos, dtype):
    """The ``enc`` kind is bidirectional over all 37 frames; its queries
    and keys are rotated only with ``pos="rope"``."""
    jcfg, jp, tcfg, tp = _models(dtype, pos=pos)
    jl = jax.tree.map(lambda a: a[0], jp["enc"]["layers"])
    tl = tp["enc"]["layers"][0]
    jx, tx = _pair(np.random.default_rng(1).standard_normal(
        (2, ENC_SEQ, jcfg.d_model)), dtype)
    jo, _ = jlayers.attention_block(jl["mixer"], jx, jcfg, kind="enc",
                                    mode="train")
    to, none = tlayers.attention_block(tl["mixer"], tx, tcfg, kind="enc",
                                       mode="train")
    assert none is None
    _close(to, jo, dtype)
    # not causal: the first frame's output reads the last frame
    tx2 = tx.clone()
    tx2[:, -1] += 1
    to2, _ = tlayers.attention_block(tl["mixer"], tx2, tcfg, kind="enc",
                                     mode="train")
    assert (to2[:, 0] != to[:, 0]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 12])
def test_cross_attention_matches_jax(S, dtype):
    """Decoder queries (S = 12 in prefill, 1 in decode) over 37 projected
    encoder frames, non-causal, through the port's flash route."""
    jcfg, jp, tcfg, tp = _models(dtype)
    jl = jax.tree.map(lambda a: a[0], jp["layers"][0])
    tl = tp["layers"][0]
    assert set(tl["cross"]._parameters) == {"wq", "wk", "wv", "wo"}
    rng = np.random.default_rng(S)
    H, hd = jcfg.n_heads, jcfg.head_dim
    jx, tx = _pair(rng.standard_normal((2, S, jcfg.d_model)), dtype)
    jk, tk = _pair(rng.standard_normal((2, ENC_SEQ, H, hd)), dtype)
    jv, tv = _pair(rng.standard_normal((2, ENC_SEQ, H, hd)), dtype)
    jo = jlayers.cross_attention(jl["cross"], jx, jk, jv, jcfg)
    to = tlayers.cross_attention(tl["cross"], tx, tk, tv, tcfg)
    assert to.dtype == TD[dtype] and tuple(to.shape) == (2, S, jcfg.d_model)
    _close(to, jo, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    """Frames plus the sinusoidal table, two ``enc`` blocks, the final
    norm."""
    jcfg, jp, tcfg, tp = _models(dtype)
    jf, tf = _pair(np.random.default_rng(2).standard_normal(
        (2, ENC_SEQ, jcfg.d_model)), dtype)
    exp = jtransformer.encode(jcfg, jp, jf)
    got = ttransformer.encode(tcfg, tp, tf)
    assert got.dtype == TD[dtype]
    _close(got, exp, dtype)


# --------------------------------------------------------------------------
# parameters, caches, learned positions
# --------------------------------------------------------------------------

def _bits(t, a):
    a = np.asarray(a)
    assert str(t.dtype).removeprefix("torch.") == str(a.dtype)
    if t.dtype == torch.bfloat16:
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_enc_cross_dec_pos_bits(dtype):
    """Encoder layer j is slice j of the reference's one stack; a decoder
    layer's ``ln_x`` and ``cross`` come with it; ``dec_pos`` whole; every
    leaf bit for bit.  The port's own init builds the same tree: keys,
    shapes and dtypes."""
    jcfg, jp, tcfg, tp = _models(dtype)
    assert len(tp["enc"]["layers"]) == tcfg.enc_layers == 2
    for j, layer in enumerate(tp["enc"]["layers"]):
        for name, t in layer.named_parameters():
            a = jp["enc"]["layers"]
            for part in name.split("."):
                a = a[part]
            _bits(t, np.asarray(a)[j])
    _bits(tp["enc"]["final_norm"], jp["enc"]["final_norm"])
    _bits(tp["dec_pos"], jp["dec_pos"])
    assert tuple(tp["dec_pos"].shape) == (MAX_SEQ, tcfg.d_model)
    for i, layer in enumerate(tp["layers"]):
        ref = jp["layers"][0]
        _bits(layer["ln_x"], np.asarray(ref["ln_x"])[i])
        for k in ("wq", "wk", "wv", "wo"):
            _bits(layer["cross"][k], np.asarray(ref["cross"][k])[i])
    own = ttransformer.make_params(tcfg, torch.Generator().manual_seed(0),
                                   device="cpu", max_seq=MAX_SEQ)
    spec = lambda m: {k: (tuple(v.shape), v.dtype)
                      for k, v in m.named_parameters()}
    assert spec(own) == spec(tp)
    assert "ffn" in own["enc"]["layers"][0] and \
        "cross" not in own["enc"]["layers"][0]


def test_moe_encoder_blocks_are_dense():
    """In an MoE encoder-decoder the encoder's blocks keep a dense MLP
    and the decoder's take the experts, as in the reference."""
    kw = dict(n_experts=4, top_k=2, d_expert=32)
    jcfg, jp, tcfg, tp = _models("float32", **kw)
    assert set(tp["enc"]["layers"][0]["ffn"]._parameters) == \
        set(jp["enc"]["layers"]["ffn"])
    assert "router" in tp["layers"][0]["ffn"]
    own = ttransformer.make_params(tcfg, torch.Generator().manual_seed(0),
                                   device="cpu", max_seq=MAX_SEQ)
    spec = lambda m: {k: (tuple(v.shape), v.dtype)
                      for k, v in m.named_parameters()}
    assert spec(own) == spec(tp)


def test_init_cache_holds_cross_leaves():
    """Every decoder layer holds zero ``cross_k``/``cross_v`` of (B,
    enc_seq, n_heads, hd) beside its self-attention cache, as the
    reference's (stacked over periods there)."""
    jcfg, tcfg = _cfg()
    jc, _ = jtransformer.init_cache(jcfg, 3, MAX_SEQ)
    tc = ttransformer.init_cache(tcfg, 3, MAX_SEQ, device="cpu")
    assert len(tc) == tcfg.n_layers
    for c in tc:
        assert set(c) == set(jc[0]) == {"k", "v", "pos_ids", "cross_k",
                                        "cross_v"}
        for k, v in c.items():
            assert tuple(v.shape) == tuple(jc[0][k].shape[1:]), k
            assert str(v.dtype).removeprefix("torch.") == \
                str(jc[0][k].dtype), k
            assert not v.any() if k != "pos_ids" else (v == -1).all()
    assert tuple(tc[0]["cross_k"].shape) == (3, ENC_SEQ, tcfg.n_heads,
                                             tcfg.head_dim)


def test_learned_positions_and_frames_refuse_what_the_reference_cannot():
    """max_seq <= 0 at init, a decode position outside the table (the
    reference clamps it), a prompt longer than the table (the reference
    fails to broadcast) and an encoder-decoder's prefill without frames
    (the reference fails in ``encode``) each raise ValueError."""
    jcfg, jp, tcfg, tp = _models()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="max_seq"):
        ttransformer.make_params(tcfg, gen, device="cpu")
    cache = ttransformer.init_cache(tcfg, 1, MAX_SEQ, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    for pos in (MAX_SEQ, -1):
        with pytest.raises(ValueError, match="decode position"):
            ttransformer.forward(tcfg, tp, tok, mode="decode", cache=cache,
                                 pos=pos)
    frames = torch.zeros((1, ENC_SEQ, tcfg.d_model))
    with pytest.raises(ValueError, match="learned positions"):
        ttransformer.forward(tcfg, tp, torch.zeros((1, MAX_SEQ + 1),
                                                   dtype=torch.int64),
                             frames=frames)
    with pytest.raises(ValueError, match="frames"):
        tstep.make_prefill(tcfg)(tp, tok, cache)
    # the last row is served
    _, cache = tstep.make_prefill(tcfg)(tp, tok, cache, frames)
    logits, _ = tstep.make_serve_step(tcfg)(tp, cache, tok, MAX_SEQ - 1)
    assert torch.isfinite(logits).all()
