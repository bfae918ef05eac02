"""The LM substrate's modules in the port, each against its JAX twin on the
same numpy inputs and the same weights (carried across with
``convert.params_from_jax``): the config copies, the layer functions,
self-attention in prefill (S < W, S = W, S > W) and decode on the ring
cache, the Mamba mixer in prefill and decode; plus the configuration the
port refuses, the ones it refused until the encoder-decoder slice, the
device rule and the package's independence from JAX.

Tolerances: float32 1e-5 (both packages round the same ops; contractions
sum in their own order), bfloat16 5e-2, the reference's own bf16
decode-vs-train tolerance (tests/test_archs.py): the two packages round
bf16 intermediates at different places, and the SSM state carries those
differences through every step."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import config as jconfig
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.serve.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _cfg(arch="llama3_2_1b", dtype="float32", **kw):
    kw |= dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


def _layer_params(jcfg, tcfg, seed=0):
    """Reference parameters and the port's copy; returns the first layer's
    block of each."""
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jl = jax.tree.map(lambda a: a[0], jp["layers"][0])
    return jp, tp, jl, tp["layers"][0]


# --------------------------------------------------------------------------
# configuration copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ModelConfig", "ShapeSpec"])
def test_model_config_mirrors_reference_field_for_field(name):
    jf = dataclasses.fields(getattr(jconfig, name))
    tf = dataclasses.fields(getattr(tconfig, name))
    assert [(f.name, f.default) for f in tf] == \
        [(f.name, f.default) for f in jf]
    assert tconfig.SHAPES == {k: tconfig.ShapeSpec(**dataclasses.asdict(v))
                              for k, v in jconfig.SHAPES.items()}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_pinned_to_reference(arch):
    """CONFIG and SMOKE of every architecture, field for field, and the
    derived sizes the port reads."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    for getter in ("get_config", "get_smoke"):
        j = getattr(jconfigs, getter)(arch)
        t = getattr(tconfigs, getter)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.q_dim, t.kv_dim, t.d_ssm, t.param_count()) == \
            (j.q_dim, j.kv_dim, j.d_ssm, j.param_count())
        assert tconfig.sub_quadratic(t) == jconfig.sub_quadratic(j)


# --------------------------------------------------------------------------
# layer functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_softcap_match(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((2, 7, 3, 16)), dtype)
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(tlayers.rms_norm(tx, torch.from_numpy(w), 1e-6),
           jlayers.rms_norm(jx, jnp.asarray(w), 1e-6), dtype, "rms_norm")
    pos = rng.integers(0, 300, (2, 7))
    for theta in (1e4, 5e5):
        _close(tlayers.apply_rope(tx, torch.from_numpy(pos), theta),
               jlayers.apply_rope(jx, jnp.asarray(pos), theta), dtype,
               f"apply_rope theta={theta}")
    _close(tlayers.softcap(tx * 40, 30.0), jlayers.softcap(jx * 40, 30.0),
           dtype, "softcap")


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp_matches(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {k: rng.standard_normal(s).astype(np.float32) / 4
         for k, s in (("wg", (16, 32)), ("wu", (16, 32)), ("wd", (32, 16)))}
    got = tlayers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), act)
    exp = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), act)
    _close(got, exp, "float32")


@pytest.mark.parametrize("bias,qk_norm", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_qkv_proj_matches(bias, qk_norm):
    jcfg, tcfg = _cfg(attn_bias=bias, qk_norm=qk_norm)
    _, _, jl, tl = _layer_params(jcfg, tcfg)
    jm, tm = dict(jl["mixer"]), tl["mixer"]
    rng = np.random.default_rng(2)
    if bias:      # the init zeroes the biases; give them values
        for k in ("bq", "bk", "bv"):
            b = rng.standard_normal(tm[k].shape).astype(np.float32)
            jm[k] = jnp.asarray(b)
            tm[k].copy_(torch.from_numpy(b))
    jx, tx = _pair(rng.standard_normal((2, 6, jcfg.d_model)), "float32")
    for g, e, name in zip(tlayers.qkv_proj(tm, tx, tcfg),
                          jlayers.qkv_proj(jm, jx, jcfg), "qkv"):
        _close(g, e, "float32", name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [5, 8, 13, 16])
def test_attention_block_prefill_and_ring_decode(S, dtype):
    """Sliding-window attention (W = 8) in prefill for S < W, S = W,
    S > W with S % W != 0 and S = 2W, then three decode steps on the ring
    cache the prefill left: outputs and every cache leaf."""
    jcfg, tcfg = _cfg(dtype=dtype, block_pattern=("swa",), sliding_window=8)
    _, _, jl, tl = _layer_params(jcfg, tcfg)
    rng = np.random.default_rng(S)
    B, extra, max_seq = 2, 3, 24
    jx, tx = _pair(rng.standard_normal((B, S + extra, jcfg.d_model)), dtype)
    jc = jax.tree.map(lambda a: a[0],
                      jtransformer.init_cache(jcfg, B, max_seq)[0][0])
    tc = ttransformer.init_cache(tcfg, B, max_seq, device="cpu")[0]
    jo, jc = jlayers.attention_block(jl["mixer"], jx[:, :S], jcfg,
                                     kind="swa", mode="prefill", cache=jc)
    to, tc = tlayers.attention_block(tl["mixer"], tx[:, :S], tcfg,
                                     kind="swa", mode="prefill", cache=tc)
    _close(to, jo, dtype, "prefill out")
    for t in range(S, S + extra):
        for key in ("k", "v"):
            _close(tc[key], jc[key], dtype, f"cache {key} before pos {t}")
        np.testing.assert_array_equal(tc["pos_ids"].numpy(),
                                      np.asarray(jc["pos_ids"]))
        jo, jc = jlayers.attention_block(jl["mixer"], jx[:, t:t + 1], jcfg,
                                         kind="swa", mode="decode",
                                         cache=jc, pos=t)
        to, tc = tlayers.attention_block(tl["mixer"], tx[:, t:t + 1], tcfg,
                                         kind="swa", mode="decode",
                                         cache=tc, pos=t)
        _close(to, jo, dtype, f"decode out at pos {t}")


def test_attention_train_mode_full_causal():
    jcfg, tcfg = _cfg(arch="gemma2_9b")       # softcap 50, attn kind
    _, _, jl, tl = _layer_params(jcfg, tcfg)
    jx, tx = _pair(np.random.default_rng(3).standard_normal(
        (2, 11, jcfg.d_model)), "float32")
    jo, _ = jlayers.attention_block(jl["mixer"], jx, jcfg, kind="attn",
                                    mode="train")
    to, none = tlayers.attention_block(tl["mixer"], tx, tcfg, kind="attn",
                                       mode="train")
    assert none is None
    _close(to, jo, "float32")


def test_causal_conv_matches():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for pv in (None, prev):
        got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                None if pv is None else torch.from_numpy(pv))
        exp = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if pv is None else jnp.asarray(pv))
        for g, e in zip(got, exp):
            _close(g, e, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_mixer_prefill_then_decode(dtype):
    """hymba's SSM mixer: prefill (through ops.ssm_scan) then three decode
    steps from the state it left; outputs, conv tail and state h."""
    jcfg, tcfg = _cfg(arch="hymba_1_5b", dtype=dtype)
    _, _, jl, tl = _layer_params(jcfg, tcfg)
    jp, tp = jl["mixer"]["ssm"], tl["mixer"]["ssm"]
    rng = np.random.default_rng(5)
    S, extra = 10, 3
    jx, tx = _pair(rng.standard_normal((2, S + extra, jcfg.d_model)), dtype)
    jo, js = jssm.mamba_mixer(jp, jx[:, :S], jcfg, mode="prefill")
    to, ts = tssm.mamba_mixer(tp, tx[:, :S], tcfg, mode="prefill")
    _close(to, jo, dtype, "prefill out")
    for t in range(S, S + extra):
        _close(ts["conv"], js["conv"], dtype, "conv tail")
        _close(ts["h"], js["h"], dtype, "state h")
        jo, js = jssm.mamba_mixer(jp, jx[:, t:t + 1], jcfg, mode="decode",
                                  state=js)
        to, ts = tssm.mamba_mixer(tp, tx[:, t:t + 1], tcfg, mode="decode",
                                  state=ts)
        _close(to, jo, dtype, f"decode out at {t}")
    _, none = tssm.mamba_mixer(tp, tx, tcfg, mode="train")
    assert none is None


def test_params_from_jax_layer_order_and_bits():
    """gemma2 alternates (swa, attn): layer i is pattern position i % 2 at
    period i // 2; bf16 leaves cross bit for bit."""
    jcfg, tcfg = jconfigs.get_smoke("gemma2_9b"), \
        tconfigs.get_smoke("gemma2_9b")
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(3))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert len(tp["layers"]) == tcfg.n_layers == 4
    for i, layer in enumerate(tp["layers"]):
        wq = np.asarray(jp["layers"][i % 2]["mixer"]["wq"][i // 2])
        got = layer["mixer"]["wq"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      wq.view(np.int16))
    assert "lm_head" not in tp                     # tied embeddings
    assert not any(p.requires_grad for p in tp.parameters())


# --------------------------------------------------------------------------
# scope, device rule, independence from JAX
# --------------------------------------------------------------------------

class _RankZero:
    """A mesh as ``make_prefill``/``make_serve_step`` read it when they
    make a sharded step, without a process group: rank 0 of ("data",
    "model") of the given sizes."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape):
        self.shape = shape

    def get_coordinate(self):
        return [0, 0]

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


def test_weights_stationary_decode_serves_and_builds_sharded():
    """``serve_weights_stationary`` changes nothing on one device, which
    serves it; over a mesh the serve steps build for it, taking the
    parameters under ``serve_rules``: no leaf split over the batch axes
    (no FSDP), the heads and vocab over "model"."""
    from repro_torch.train import step as tstep
    cfg = dataclasses.replace(tconfigs.get_smoke("llama3_2_1b"),
                              serve_weights_stationary=True)
    mesh = _RankZero((2, 2))
    assert callable(tstep.make_prefill(cfg, mesh))
    assert callable(tstep.make_serve_step(cfg, mesh))
    sh, _ = tstep.serve_shardings(cfg, mesh)
    specs = {n: s.spec for n, s in sh["params"].items()}
    axes = {a for sp in specs.values() for e in sp if e is not None
            for a in ((e,) if isinstance(e, str) else e)}
    assert axes == {"model"}, specs
    assert specs["embed"] == ("model",)
    assert specs["layers.0.mixer.wq"] == (None, "model")
    params = ttransformer.make_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    cache = ttransformer.init_cache(cfg, 1, 4, device="cpu")
    logits, _ = tstep.make_serve_step(cfg)(
        params, cache, torch.zeros((1, 1), dtype=torch.int64), 0)
    plain = dataclasses.replace(cfg, serve_weights_stationary=False)
    want, _ = tstep.make_serve_step(plain)(
        params, ttransformer.init_cache(cfg, 1, 4, device="cpu"),
        torch.zeros((1, 1), dtype=torch.int64), 0)
    assert logits.shape == (1, cfg.vocab)
    assert torch.equal(logits, want)


@pytest.mark.parametrize("arch,cfg_kw", [
    ("qwen3_moe_235b_a22b", {"pos": "learned"}),
    ("whisper_large_v3", {}),
    ("chameleon_34b", {}),
    ("llama3_2_1b", {"pos": "learned"}),
])
def test_once_refused_configs_run_and_match_jax(arch, cfg_kw):
    """The configurations the port refused until ROADMAP Queue 1 item 16
    landed (learned positions, the encoder-decoder, the ``vq_tokens``
    front end) run through the port's train forward, equal to JAX's in
    float32 (1e-4, the slices' logits tolerance)."""
    jcfg, tcfg = _cfg(arch, **cfg_kw)
    max_seq = 12 if jcfg.pos == "learned" else 0
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(0), max_seq)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    frames = rng.standard_normal((2, jcfg.enc_seq, jcfg.d_model),
                                 dtype=np.float32) if jcfg.is_enc_dec \
        else None
    jl, _, _ = jtransformer.forward(
        jcfg, jp, jnp.asarray(toks),
        frames=None if frames is None else jnp.asarray(frames))
    tl, _, _ = ttransformer.forward(
        tcfg, tp, torch.from_numpy(toks),
        frames=None if frames is None else torch.from_numpy(frames))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)


def test_device_rule_serving():
    """Without a card, building parameters or an engine with no device
    raises; it never moves to the CPU on its own."""
    cfg = tconfigs.get_smoke("hymba_1_5b")
    params = ttransformer.make_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttransformer.make_params(cfg, torch.Generator().manual_seed(0))
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_serving_modules_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.models.moe\n"      # first: no import cycle
            "import repro_torch.serve.engine, repro_torch.models.transformer\n"
            "import repro_torch.train.step, repro_torch.configs.hymba_1_5b\n"
            "import repro_torch.sharding.spmd, repro_torch.launch.mesh\n"
            "import repro_torch.launch.train, repro_torch.data.pipeline\n"
            "import repro_torch.ckpt.checkpoint, repro_torch.launch.dryrun\n"
            "import repro_torch.roofline.analysis, repro_torch.roofline.table\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
