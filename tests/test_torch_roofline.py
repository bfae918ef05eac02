"""The port's roofline (``repro_torch.roofline``) and the ``skip_attention``
probe against the JAX package, on the CPU.

  * ``model_flops``, ``extrapolate``, ``recurrent_flop_correction`` and
    ``param_count(active_only=...)`` equal the reference's for every
    architecture and supported shape; ``table`` (a copy) gives the
    reference's strings on the same rows.
  * ``skip_attention``: ``attention_block`` of the ``attn``, ``swa``,
    ``hymba`` and ``enc`` kinds in train and prefill equals JAX's within
    1e-4 (float32; no cache comes back), decode is the unablated step, and
    a smoke forward's logits equal JAX's.
  * The dry run's counts (subprocesses over a fake process group): a fake
    trace of a smoke train step on a (1, 1) mesh records the operations
    and bytes of a real CPU trace of it (the kernels' plain versions
    folded), and on the 16 x 16 mesh the 1- and 2-period probes
    extrapolate to the full-depth count of a 4-layer smoke model (hymba
    in each mode; qwen3-moe trained on 2 microbatches over 16 ranks;
    whisper's prefill, 4 + 4 layers, its encoder's sinusoidal table on
    fake tensors).
"""
import dataclasses
import json
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
from repro.models import transformer as jtransformer
from repro.roofline import analysis as janalysis
from repro.roofline import table as jtable
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import table as ttable

ROOT = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(1)
TOL = 1e-4


def _pairs():
    for arch in jconfigs.ARCH_IDS:
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for s in jconfig.supported_shapes(jcfg):
            yield arch, jcfg, tcfg, s, tconfig.SHAPES[s.name]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_roofline_formulas_match_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for active in (False, True):
        assert tcfg.param_count(active_only=active) == \
            jcfg.param_count(active_only=active)
    names = [s.name for s in tconfig.supported_shapes(tcfg)]
    assert names == [s.name for s in jconfig.supported_shapes(jcfg)]
    for name in names:
        js, ts = jconfig.SHAPES[name], tconfig.SHAPES[name]
        assert tanalysis.model_flops(tcfg, ts) == \
            janalysis.model_flops(jcfg, js)
        for chips in (1, 256, 512):
            for remat in ("dots", "full"):
                jc = dataclasses.replace(jcfg, remat=remat)
                tc = dataclasses.replace(tcfg, remat=remat)
                assert tanalysis.recurrent_flop_correction(tc, ts, chips) == \
                    janalysis.recurrent_flop_correction(jc, js, chips)
    rng = np.random.default_rng(3)
    keys = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")

    def probe():
        return {"flops": float(rng.uniform(1e9, 1e12)),
                "bytes": float(rng.uniform(1e9, 1e12)),
                "coll": float(rng.uniform(0, 1e9)),
                "coll_by_type": {k: float(rng.uniform(0, 1e9))
                                 for k in keys}}
    for _ in range(4):
        p1, p2 = probe(), probe()
        assert tanalysis.extrapolate(p1, p2, jcfg.n_periods) == \
            janalysis.extrapolate(p1, p2, jcfg.n_periods)


def _rows():
    rng = np.random.default_rng(5)
    rows = []
    for i, (arch, jcfg, _, s, _) in enumerate(_pairs()):
        mesh = {"data": 16, "model": 16} if i % 2 else \
            {"pod": 2, "data": 16, "model": 16}
        terms = rng.uniform(1e-5, 3.0, 3)
        rows.append({"arch": jcfg.name, "shape": s.name, "kind": s.kind,
                     "mesh": mesh, "t_compute": terms[0],
                     "t_memory": terms[1], "t_collective": terms[2],
                     "dominant": ("t_compute", "t_memory",
                                  "t_collective")[int(np.argmax(terms))],
                     "step_time_est": float(terms.max()),
                     "useful_flop_ratio": rng.uniform(0, 1),
                     "roofline_fraction": rng.uniform(0, 1),
                     "bytes_per_device": rng.uniform(1e8, 1e12),
                     "tag": "" if i % 3 else "x"})
    return rows


def test_table_is_the_reference_copy(tmp_path, capsys):
    rows = _rows()
    for flt in (None, "pod", "multipod"):
        assert ttable.markdown(rows, flt) == jtable.markdown(rows, flt)
    for x in (2.5, 0.25, 3e-4, 7e-7):
        assert ttable.fmt_s(x) == jtable.fmt_s(x)
    for i, r in enumerate(rows):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    (tmp_path / "zz.json").write_text(json.dumps({"cell": "c",
                                                  "error": "e"}))
    for tag in ("", "x"):
        assert ttable.load(str(tmp_path), tag) == jtable.load(str(tmp_path),
                                                              tag)
    outs = []
    for mod in (ttable, jtable):
        old = sys.argv
        sys.argv = ["table", str(tmp_path)]
        try:
            mod.main()
        finally:
            sys.argv = old
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


# --------------------------------------------------------------------------
# the skip_attention probe
# --------------------------------------------------------------------------

def _models(arch, **kw):
    kw = dict(param_dtype="float32", compute_dtype="float32", **kw)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    max_seq = 16 if jcfg.pos == "learned" else 0
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(0), max_seq)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _mixers(arch, kind, jp, tp):
    """The first layer's attention parameters of ``kind``, both sides."""
    if kind == "enc":
        return (jax.tree.map(lambda a: a[0], jp["enc"]["layers"])["mixer"],
                tp["enc"]["layers"][0]["mixer"])
    jl = jax.tree.map(lambda a: a[0], jp["layers"][0])["mixer"]
    tl = tp["layers"][0]["mixer"]
    return (jl["attn"], tl["attn"]) if kind == "hymba" else (jl, tl)


def _close(got, exp, ctx=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.float32(exp),
                               atol=TOL, rtol=TOL, err_msg=ctx)


@pytest.mark.parametrize("arch,kind", [
    ("llama3_2_1b", "attn"), ("gemma2_9b", "swa"), ("hymba_1_5b", "hymba"),
    ("whisper_large_v3", "enc")])
def test_skip_attention_block_matches_jax(arch, kind):
    jcfg, jp, tcfg, tp = _models(arch, skip_attention=True)
    jm, tm = _mixers(arch, kind, jp, tp)
    B, S = 2, 11
    x = np.random.default_rng(7).standard_normal((B, S, jcfg.d_model))
    jx, tx = jnp.asarray(x, jnp.float32), torch.from_numpy(np.float32(x))
    for mode in ("train", "prefill"):
        cache = None
        if mode == "prefill" and kind != "enc":
            cache = ttransformer.init_cache(tcfg, B, 16, device="cpu")[0]
        jo, jc = jlayers.attention_block(jm, jx, jcfg, kind=kind, mode=mode,
                                         cache=None)
        to, tc = tlayers.attention_block(tm, tx, tcfg, kind=kind, mode=mode,
                                         cache=cache)
        assert jc is None and tc is None, (kind, mode)
        _close(to, jo, f"{kind} {mode}")
    if kind == "enc":
        return
    # decode: the flag changes nothing, in either package
    plain = dataclasses.replace(tcfg, skip_attention=False)
    jplain = dataclasses.replace(jcfg, skip_attention=False)
    cache = ttransformer.init_cache(tcfg, B, 16, device="cpu")[0]
    jcache = jax.tree.map(lambda a: a[0],
                          jtransformer.init_cache(jcfg, B, 16)[0][0])
    jcache = {k: jcache[k] for k in ("k", "v", "pos_ids")}
    tcache = {k: cache[k] for k in ("k", "v", "pos_ids")}
    _, tcache = tlayers.attention_block(tm, tx[:, :5], plain, kind=kind,
                                        mode="prefill", cache=tcache)
    _, jcache = jlayers.attention_block(jm, jx[:, :5], jplain, kind=kind,
                                        mode="prefill", cache=jcache)
    got = [tlayers.attention_block(tm, tx[:, 5:6], c, kind=kind,
                                   mode="decode", cache=tcache, pos=5)
           for c in (tcfg, plain)]
    jo, _ = jlayers.attention_block(jm, jx[:, 5:6], jcfg, kind=kind,
                                    mode="decode", cache=jcache, pos=5)
    assert torch.equal(got[0][0], got[1][0])
    for key in ("k", "v", "pos_ids"):
        assert torch.equal(got[0][1][key], got[1][1][key])
    _close(got[0][0], jo, f"{kind} decode")


@pytest.mark.parametrize("arch", ["hymba_1_5b", "llama3_2_1b",
                                  "whisper_large_v3"])
def test_skip_attention_forward_matches_jax(arch):
    """Train-mode logits and a prefill's logits of a smoke model with the
    attention ablated (hymba keeps its SSM half; whisper's encoder is
    ablated, its cross-attention is not)."""
    jcfg, jp, tcfg, tp = _models(arch, skip_attention=True)
    rng = np.random.default_rng(11)
    B, S = 2, 12
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if jcfg.is_enc_dec:
        fr = rng.standard_normal((B, jcfg.enc_seq, jcfg.d_model))
        kw_j["frames"] = jnp.asarray(fr, jnp.float32)
        kw_t["frames"] = torch.from_numpy(np.float32(fr))
    jl, _, _ = jtransformer.forward(jcfg, jp, jnp.asarray(toks),
                                    mode="train", **kw_j)
    tl, _, _ = ttransformer.forward(tcfg, tp, torch.from_numpy(toks),
                                    mode="train", **kw_t)
    _close(tl, jl, f"{arch} train")
    if jcfg.is_enc_dec:
        return
    jc, _ = jtransformer.init_cache(jcfg, B, 16)
    tc = ttransformer.init_cache(tcfg, B, 16, device="cpu")
    jl, _, _ = jtransformer.forward(jcfg, jp, jnp.asarray(toks),
                                    mode="prefill", cache=jc)
    tl, _, _ = ttransformer.forward(tcfg, tp, torch.from_numpy(toks),
                                    mode="prefill", cache=tc)
    _close(tl, jl, f"{arch} prefill")


# --------------------------------------------------------------------------
# the dry run's counts, in subprocesses over a fake process group
# --------------------------------------------------------------------------

_COUNTS = r"""
import dataclasses, json, sys
import numpy as np
import torch
from repro_torch import configs
from repro_torch.analysis import graph_audit
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.config import ShapeSpec
from repro_torch.roofline import analysis
from repro_torch.train import step

torch.set_num_threads(1)
dryrun.init_fake(256)
out = {}
one = make_local_mesh(1, 1, device="cpu")
shp = ShapeSpec("smoke_train", "train", 16, 4)
for arch in ("hymba_1_5b", "qwen3_moe_235b_a22b"):
    cfg = dataclasses.replace(configs.get_smoke(arch), remat="dots",
                              param_dtype="float32", compute_dtype="float32")
    with dryrun.fake_mode():
        fn, args, _ = dryrun._lower_one(cfg, shp, one, "meta")
        fake = graph_audit.record(fn, *args)
    state = step.init_state(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    real = graph_audit.record(step.make_train_step(cfg, one), state, batch)
    # the rotary table is made once on the host and moved to the device
    # once (cached): on the CPU the move is none
    stats = [analysis.raw_stats(graph_audit.Inventory(
        [s for s in inv.sites if "(_inv_freq)" not in s.src]))
        for inv in (fake, real)]
    out[arch] = {"fake": stats[0], "real": stats[1],
                 "kernels": real.folded().summary()["kernels"]}
pod = make_production_mesh(device="cuda")
hymba = dataclasses.replace(configs.get_smoke("hymba_1_5b"), n_layers=4,
                            remat="dots")
moe = dataclasses.replace(configs.get_smoke("qwen3_moe_235b_a22b"),
                          n_layers=4, microbatches=2)
whisper = dataclasses.replace(configs.get_smoke("whisper_large_v3"),
                              n_layers=4, enc_layers=4)
for key, cfg, shp in (
        ("train", hymba, ShapeSpec("t", "train", 16, 16)),
        ("prefill", hymba, ShapeSpec("p", "prefill", 16, 16)),
        ("decode", hymba, ShapeSpec("d", "decode", 16, 16)),
        ("moe train, 2 microbatches", moe, ShapeSpec("t", "train", 16, 16)),
        ("whisper prefill", whisper, ShapeSpec("p", "prefill", 16, 16))):
    p1, p2, full = (dryrun._trace(c, shp, pod, "meta")[0] for c in (
        dryrun._probe_cfg(cfg, 1), dryrun._probe_cfg(cfg, 2), cfg))
    out[key] = {"extrapolated": analysis.extrapolate(p1, p2, cfg.n_periods),
                "full": full}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _COUNTS], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["hymba_1_5b", "qwen3_moe_235b_a22b"])
def test_fake_trace_counts_equal_a_real_cpu_trace(counts, arch):
    c = counts[arch]
    assert c["fake"] == c["real"], arch
    assert c["fake"]["flops"] > 0 and c["fake"]["coll"] == 0
    if arch == "hymba_1_5b":        # the kernels, one node each
        assert c["kernels"] == {
            "repro_torch.flash_attention": 4,
            "repro_torch.flash_attention_backward": 2,
            "repro_torch.ssm_scan": 4, "repro_torch.ssm_scan_backward": 2}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode",
                                  "moe train, 2 microbatches",
                                  "whisper prefill"])
def test_probes_extrapolate_to_full_depth(counts, kind):
    c = counts[kind]
    assert c["extrapolated"] == c["full"], kind
    assert c["full"]["coll"] > 0            # the 16 x 16 mesh's gathers


def test_live_bytes_counts_storages_and_the_in_place_backward():
    """Storages count from the op that makes them until they are freed;
    gather's backward (new_zeros, then scatter_add out of place under a
    Python mode) counts one (64, 128) buffer, as the eager program's
    in-place write holds."""
    x = torch.randn(64, 128, requires_grad=True)
    idx = torch.randint(0, 128, (64, 1))
    mem = tanalysis.LiveBytes()
    base = mem.add(x, idx)
    assert base == 64 * 128 * 4 + 64 * 8
    buf = 64 * 128 * 4
    with mem:
        y = x.gather(1, idx)
        (g,) = torch.autograd.grad(y.sum(), x)
        z = torch.empty(1000, dtype=torch.float64)     # 8,000 B -> 8,192
        assert mem.now - base >= buf + 8192
        del z
    assert buf <= mem.peak - base < 2 * buf
    del y
    assert mem.now == base + buf                          # g alone
    del g
    assert mem.now == base
