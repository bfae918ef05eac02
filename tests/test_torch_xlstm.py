"""The recurrent mixers of the port (``repro_torch.models.ssm``): the two
xLSTM mixers (mLSTM, sLSTM) and the Mamba mixer as a ``mamba`` layer,
function by function against ``repro.models.ssm`` on the same numpy
inputs and the same parameters (carried across from the reference's
``_mlstm_params``, ``_slstm_params`` and ``_block_params``).

Tolerances: float32 1e-4 (the products and the running sum of the log
forget gates add in another order; the parallel form takes exp of
differences of that sum), bfloat16 5e-2 (the reference's own bf16
decode-vs-train tolerance, tests/test_archs.py).  States are compared at
the same tolerances; the init states exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.analysis import graph_audit
from repro_torch.convert import _param_tensor
from repro_torch.kernels import ops
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch="xlstm_350m", dtype="float32", **kw):
    kw |= dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


def _conv(tree):
    """A reference tree (dicts of jax arrays) as the port's, bit for bit."""
    if isinstance(tree, dict):
        return {k: _conv(v) for k, v in tree.items()}
    return _param_tensor(np.asarray(tree), "cpu")


def _params(fn, jcfg, seed=0):
    jp, _ = fn(jcfg, jax.random.key(seed))
    return jp, _conv(jp)


def _x(shape, dtype, seed=1, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    return jnp.asarray(a).astype(JD[dtype]), torch.from_numpy(a).to(TD[dtype])


def _close(got, exp, dtype, ctx=""):
    np.testing.assert_allclose(got.float().numpy(), np.float32(exp),
                               atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=ctx)


def _states_close(got, exp, dtype, ctx=""):
    assert set(got) == set(exp), ctx
    for k in exp:
        assert got[k].dtype == torch.float32 or k == "conv", (ctx, k)
        assert tuple(got[k].shape) == tuple(exp[k].shape), (ctx, k)
        _close(got[k], exp[k], dtype, f"{ctx} state {k}")


def _random_state(init, seed, positive=()):
    """Random float32 states shaped as ``init``'s (keys in ``positive``
    drawn above 1, as a normalizer n past its floor)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in init.items():
        a = rng.standard_normal(np.shape(v)).astype(np.float32)
        if k in positive:
            a = 1.0 + np.abs(a)
        out[k] = a
    return ({k: jnp.asarray(a) for k, a in out.items()},
            {k: torch.from_numpy(a) for k, a in out.items()})


# --------------------------------------------------------------------------
# init states
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
def test_init_states_match(kind, dtype):
    """Every recurrent state is float32 (mamba's conv tail excepted, in
    the compute dtype) and zero, m included, whatever the compute dtype."""
    arch = "hymba_1_5b" if kind == "mamba" else "xlstm_350m"
    jcfg, tcfg = _cfgs(arch, dtype)
    fn = {"mlstm": "mlstm_init_state", "slstm": "slstm_init_state",
          "mamba": "ssm_init_state"}[kind]
    exp = getattr(jssm, fn)(jcfg, 3, JD[dtype])
    got = getattr(tssm, fn)(tcfg, 3, TD[dtype], "cpu")
    assert set(got) == set(exp)
    for k in exp:
        assert str(got[k].dtype).removeprefix("torch.") == \
            str(exp[k].dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.float32(exp[k]))


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def test_log_sigmoid_matches_jax():
    a = np.concatenate([np.random.default_rng(2).standard_normal(10_000)
                        * 8, [-200.0, -30.0, 0.0, 30.0, 200.0]]).astype(
        np.float32)
    got = tssm._log_sigmoid(torch.from_numpy(a)).numpy()
    exp = np.asarray(jax.nn.log_sigmoid(jnp.asarray(a)))
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_qkvg_matches(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jtransformer._mlstm_params, jcfg)
    jx, tx = _x((2, 7, jcfg.d_model), dtype)
    exp = jssm._mlstm_qkvg(jp, jx, jcfg)
    got = tssm._mlstm_qkvg(tp, tx, tcfg)
    for name, g, e in zip("q k v i f o".split(), got, exp):
        assert str(g.dtype).removeprefix("torch.") == str(e.dtype), name
        _close(g, e, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attn_chunk", [0, 5, 8, 512])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mlstm_parallel_form_matches(mode, attn_chunk, dtype):
    """S = 20: chunk 0 (one chunk of S), 5 (divides S), 8 (a ragged last
    chunk whose padded queries are sliced away), 512 (the default, one
    chunk); prefill's final (C, n, m) too."""
    jcfg, tcfg = _cfgs(dtype=dtype, attn_chunk=attn_chunk)
    jp, tp = _params(jtransformer._mlstm_params, jcfg)
    jx, tx = _x((2, 20, jcfg.d_model), dtype)
    e_out, e_st = jssm.mlstm_mixer(jp, jx, jcfg, mode=mode)
    g_out, g_st = tssm.mlstm_mixer(tp, tx, tcfg, mode=mode)
    assert g_out.dtype == TD[dtype]
    _close(g_out, e_out, dtype, "out")
    if mode == "train":
        assert g_st is None and e_st is None
    else:
        _states_close(g_st, e_st, dtype, "prefill")


def test_mlstm_chunking_does_not_change_the_result():
    """The port's chunked forms agree with its unchunked one (the queries
    of a chunk see the same keys)."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jtransformer._mlstm_params, jcfg)
    _, tx = _x((2, 33, tcfg.d_model), "float32", seed=4)
    base, _ = tssm.mlstm_mixer(tp, tx, tcfg, mode="train", chunk=33)
    for chunk in (1, 4, 11, 32, 64):
        out, _ = tssm.mlstm_mixer(tp, tx, tcfg, mode="train", chunk=chunk)
        torch.testing.assert_close(out, base, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_decode_matches(dtype):
    """Three decode steps from a random state (n large enough, m spread
    about 0, so both sides of the floor run)."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jtransformer._mlstm_params, jcfg)
    js, ts = _random_state(jssm.mlstm_init_state(jcfg, 2, jnp.float32), 5)
    for t in range(3):
        jx, tx = _x((2, 1, jcfg.d_model), dtype, seed=10 + t)
        e_out, js = jssm.mlstm_mixer(jp, jx, jcfg, mode="decode", state=js)
        g_out, ts = tssm.mlstm_mixer(tp, tx, tcfg, mode="decode", state=ts)
        _close(g_out, e_out, dtype, f"step {t}")
        _states_close(ts, js, dtype, f"step {t}")


def test_mlstm_head_dim_not_a_power_of_four():
    """head_dim 8: k / sqrt(8) is inexact; the port multiplies by the
    float32 reciprocal (kernels.ref.div_const), within 1e-4 of the
    reference's division."""
    jcfg, tcfg = _cfgs(head_dim=8)
    jp, tp = _params(jtransformer._mlstm_params, jcfg)
    jx, tx = _x((2, 12, jcfg.d_model), "float32")
    e_out, e_st = jssm.mlstm_mixer(jp, jx, jcfg, mode="prefill")
    g_out, g_st = tssm.mlstm_mixer(tp, tx, tcfg, mode="prefill")
    _close(g_out, e_out, "float32")
    _states_close(g_st, e_st, "float32")


def test_mlstm_state_from_seq_matches():
    """The final state from random keys, values and gates, with large
    input gates (m well above 0) and small ones (m at its floor 0)."""
    rng = np.random.default_rng(6)
    B, S, H, hd = 2, 17, 3, 5
    kf, vf = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
              for _ in range(2))
    i_t = (rng.standard_normal((B, S, H)) * 6).astype(np.float32)
    logf = -np.abs(rng.standard_normal((B, S, H))).astype(np.float32)
    cum = np.cumsum(logf, axis=1, dtype=np.float32)
    exp = jssm._mlstm_state_from_seq(*map(jnp.asarray, (kf, vf, i_t, logf,
                                                        cum)), B, H, hd)
    got = tssm._mlstm_state_from_seq(*map(torch.from_numpy, (kf, vf, i_t,
                                                             logf, cum)),
                                     B, H, hd)
    _states_close(got, exp, "float32")
    assert (got["m"] > 0).any() and (got["m"] == 0).any()


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_slstm_sequence_matches(mode, dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jtransformer._slstm_params, jcfg)
    jx, tx = _x((2, 20, jcfg.d_model), dtype)
    e_out, e_st = jssm.slstm_mixer(jp, jx, jcfg, mode=mode)
    g_out, g_st = tssm.slstm_mixer(tp, tx, tcfg, mode=mode)
    assert g_out.dtype == TD[dtype]
    _close(g_out, e_out, dtype, "out")
    if mode == "train":
        assert g_st is None and e_st is None
    else:
        _states_close(g_st, e_st, dtype, "prefill")


def test_slstm_long_sequence_matches():
    """300 sequential steps, float32, inputs scaled up so the exponential
    gates saturate and m moves."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jtransformer._slstm_params, jcfg, seed=3)
    jx, tx = _x((2, 300, jcfg.d_model), "float32", seed=7, scale=3.0)
    e_out, e_st = jssm.slstm_mixer(jp, jx, jcfg, mode="prefill")
    g_out, g_st = tssm.slstm_mixer(tp, tx, tcfg, mode="prefill")
    _close(g_out, e_out, "float32", "out")
    _states_close(g_st, e_st, "float32", "prefill")


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_decode_matches(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jtransformer._slstm_params, jcfg)
    js, ts = _random_state(jssm.slstm_init_state(jcfg, 2, jnp.float32), 8,
                           positive=("n",))
    for t in range(3):
        jx, tx = _x((2, 1, jcfg.d_model), dtype, seed=20 + t)
        e_out, js = jssm.slstm_mixer(jp, jx, jcfg, mode="decode", state=js)
        g_out, ts = tssm.slstm_mixer(tp, tx, tcfg, mode="decode", state=ts)
        _close(g_out, e_out, dtype, f"step {t}")
        _states_close(ts, js, dtype, f"step {t}")


def test_slstm_prefill_equals_its_decode_steps():
    """The sequence loop is the decode step: prefill(S) == S decode steps
    from the zero state, within 1e-6 (the input and output products of
    the whole sequence and of one position add in other orders)."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jtransformer._slstm_params, jcfg)
    _, tx = _x((2, 9, tcfg.d_model), "float32", seed=9)
    out, st = tssm.slstm_mixer(tp, tx, tcfg, mode="prefill")
    s = tssm.slstm_init_state(tcfg, 2, torch.float32, "cpu")
    for t in range(9):
        o, s = tssm.slstm_mixer(tp, tx[:, t:t + 1], tcfg, mode="decode",
                                state=s)
        torch.testing.assert_close(o[:, 0], out[:, t], rtol=1e-6, atol=1e-6)
    for k in st:
        torch.testing.assert_close(s[k], st[k], rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the mamba block kind
# --------------------------------------------------------------------------

def _mamba_layer(dtype):
    jcfg, tcfg = _cfgs("hymba_1_5b", dtype, block_pattern=("mamba",))
    jp, _ = jtransformer._block_params(jcfg, "mamba", jax.random.key(4))
    return jcfg, tcfg, jp, _conv(jp)


def _japply(jcfg, p, x, mode, cache):
    return jtransformer._apply_block(jcfg, "mamba", p, x, mode=mode,
                                     cache=cache, pos=0, enc_out=None,
                                     mesh=None, mesh_axes=None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mamba_layer_matches(mode, dtype):
    """A ``mamba`` layer (rms norm, Mamba mixer, residual; no attention)
    through the scan's plain version on the CPU."""
    jcfg, tcfg, jp, tp = _mamba_layer(dtype)
    assert "ffn" in tp and "attn" not in tp["mixer"]
    jx, tx = _x((2, 20, jcfg.d_model), dtype)
    e_x, e_c, _ = _japply(jcfg, jp, jx, mode, None)
    ops.reset_launch_counts()
    g_x, g_c, aux = ttransformer._apply_block(tcfg, "mamba", tp, tx,
                                              mode=mode, cache=None, pos=0)
    assert ops.launch_counts()["ssm_scan"] == 0          # the CPU route
    assert aux is None
    _close(g_x, e_x, dtype, "hidden")
    if mode == "prefill":
        _states_close(g_c["ssm"], e_c["ssm"], dtype, "ssm")
    else:
        assert not g_c and not e_c


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_layer_decode_matches(dtype):
    jcfg, tcfg, jp, tp = _mamba_layer(dtype)
    jx, tx = _x((2, 6, jcfg.d_model), dtype)
    _, jc, _ = _japply(jcfg, jp, jx, "prefill", None)
    _, tc, _ = ttransformer._apply_block(tcfg, "mamba", tp, tx,
                                         mode="prefill", cache=None, pos=0)
    for t in range(3):
        jx, tx = _x((2, 1, jcfg.d_model), dtype, seed=30 + t)
        e_x, jc, _ = _japply(jcfg, jp, jx, "decode", jc)
        g_x, tc, _ = ttransformer._apply_block(tcfg, "mamba", tp, tx,
                                               mode="decode", cache=tc,
                                               pos=6 + t)
        _close(g_x, e_x, dtype, f"step {t}")
        _states_close(tc["ssm"], jc["ssm"], dtype, f"step {t}")


# --------------------------------------------------------------------------
# no host read in a step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixers_read_nothing_back_to_the_host(kind, mode):
    jcfg, tcfg = _cfgs()
    fn = {"mlstm": jtransformer._mlstm_params,
          "slstm": jtransformer._slstm_params}[kind]
    _, tp = _params(fn, jcfg)
    mixer = getattr(tssm, f"{kind}_mixer")
    init = getattr(tssm, f"{kind}_init_state")
    S = 1 if mode == "decode" else 10
    _, tx = _x((2, S, tcfg.d_model), "float32")
    state = init(tcfg, 2, torch.float32, "cpu") if mode == "decode" \
        else None
    inv = graph_audit.record(mixer, tp, tx, tcfg, mode=mode, state=state)
    assert inv.count(graph_audit.HOST_SYNC_OPS) == 0
    assert inv.n_ops > 0
