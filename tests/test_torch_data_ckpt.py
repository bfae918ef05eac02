"""The port's data pipeline and checkpoints (``repro_torch.data.pipeline``,
``repro_torch.ckpt.checkpoint``) against the reference's laws
(tests/test_distribution.py) and on-disk layout: batches are a pure
function of (seed, step, shard), shifted, masked at the end, disjoint
across shards, with the reference's Zipf marginal (a frequency test that
JAX's own draws also pass); checkpoints round-trip (bf16 bits included),
collect to ``keep``, ignore ``tmp.*``, survive an in-place step after an
async save, resume to the straight run, lay out a state as the
reference's Checkpointer does, and restore on another mesh."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import get_batch as jget_batch
from repro_torch import configs as tconfigs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core import shard_sim
from repro_torch.data.pipeline import (DataConfig, batch_iterator, get_batch,
                                       zipf_pmf)
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep

import torch_spmd

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------

def test_data_deterministic_and_shifted():
    dc = DataConfig(vocab=128, seq_len=32, global_batch=4, seed=7)
    a = get_batch(dc, step=5, device="cpu")
    b = get_batch(dc, step=5, device="cpu")
    c = get_batch(dc, step=6, device="cpu")
    assert a["tokens"].dtype == a["labels"].dtype == torch.int32
    assert a["tokens"].shape == a["labels"].shape == (4, 32)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == -1).all()
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 128
    # the iterator replays get_batch from any step
    it = batch_iterator(dc, start_step=5, device="cpu")
    s, first = next(it)
    assert s == 5 and torch.equal(first["tokens"], a["tokens"])
    assert next(it)[0] == 6


def test_data_shards_disjoint_streams():
    dc = DataConfig(vocab=128, seq_len=16, global_batch=8, seed=0,
                    n_shards=2)
    s0 = get_batch(dc, 0, shard=0, device="cpu")
    s1 = get_batch(dc, 0, shard=1, device="cpu")
    assert s0["tokens"].shape == (4, 16)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    with pytest.raises(ValueError):
        get_batch(dc, 0, shard=2, device="cpu")
    with pytest.raises(ValueError):
        get_batch(dataclasses.replace(dc, global_batch=7), 0, device="cpu")


def _zipf_statistic(tokens, vocab, alpha, top=15):
    """Pearson's chi-square of the token counts against the Zipf pmf:
    the ``top`` most likely ranks alone and the rest in one bin."""
    counts = np.bincount(np.asarray(tokens).ravel(), minlength=vocab)
    p = zipf_pmf(vocab, alpha)
    obs = np.append(counts[:top], counts[top:].sum())
    exp = np.append(p[:top], p[top:].sum()) * counts.sum()
    return float(((obs - exp) ** 2 / exp).sum())


def test_zipf_marginal_matches_the_reference():
    """16 degrees of freedom less one: 44.3 is the 1 - 1e-4 quantile.  The
    port's draws and JAX's pass; a uniform draw fails by far."""
    vocab, alpha = 64, 1.2
    dc = DataConfig(vocab=vocab, seq_len=255, global_batch=64, seed=3)
    port = np.concatenate([get_batch(dc, s, device="cpu")["tokens"].numpy()
                           for s in range(2)])
    jdc = JDataConfig(vocab=vocab, seq_len=255, global_batch=64, seed=3)
    ref = np.concatenate([np.asarray(jget_batch(jdc, s)["tokens"])
                          for s in range(2)])
    assert _zipf_statistic(port, vocab, alpha) < 44.3
    assert _zipf_statistic(ref, vocab, alpha) < 44.3
    uniform = np.random.default_rng(0).integers(0, vocab, port.shape)
    assert _zipf_statistic(uniform, vocab, alpha) > 1e3
    p = zipf_pmf(vocab, alpha)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    np.testing.assert_allclose(p, ranks ** -alpha / (ranks ** -alpha).sum(),
                               rtol=1e-12)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _state(arch="smollm_360m", seed=0, **kw):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    return cfg, tstep.init_state(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")


def _leaves(state):
    return torch_spmd.plain_state(state)


def _assert_states_equal(a, b):
    pa, pb = _leaves(a), _leaves(b)
    assert list(pa["params"]) == list(pb["params"])
    for n, t in pa["params"].items():
        assert t.dtype == pb["params"][n].dtype
        assert torch.equal(t, pb["params"][n]), n
    for k in ("m", "v"):
        for n, t in pa["opt"][k].items():
            assert torch.equal(t, pb["opt"][k][n]), (k, n)
    assert torch.equal(pa["step"], pb["step"])


def test_ckpt_roundtrip_and_gc(tmp_path):
    cfg, state = _state()
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3):
        ck.save(state, s)
    assert sorted(ck.all_steps()) == [2, 3]          # GC keeps last 2
    restored, step = ck.restore(state)
    assert step == 3
    _assert_states_equal(state, restored)
    assert all(p.requires_grad for p in restored["params"].parameters())
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(state)


def test_ckpt_atomic_no_partial(tmp_path):
    """tmp dirs never count as checkpoints."""
    ck = Checkpointer(tmp_path)
    (tmp_path / "tmp.99").mkdir()
    assert ck.latest_step() is None


def test_ckpt_bf16_bits_roundtrip(tmp_path):
    """bfloat16 parameters keep every bit, NaN payloads and signed zeros
    included; the manifest says "bfloat16" and the file holds uint16."""
    cfg, state = _state(param_dtype="bfloat16")
    embed = state["params"]["embed"]
    bits = torch.from_numpy(np.array([0x7FC1, 0xFFC0, 0x8000, 0x0001,
                                      0x7F80], np.uint16).view(np.int16))
    with torch.no_grad():
        embed.view(-1)[:5].view(torch.int16).copy_(bits)
    ck = Checkpointer(tmp_path)
    ck.save(state, 1)
    man = json.loads((tmp_path / "step_0000000001" /
                      "manifest.json").read_text())
    rec = next(m for m in man["leaves"] if m["path"] == "['params']['embed']")
    assert rec["dtype"] == "bfloat16"
    raw = np.load(tmp_path / "step_0000000001" / f"{rec['name']}.npy")
    assert raw.dtype == np.uint16
    restored, _ = ck.restore(state)
    got = restored["params"]["embed"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), embed.detach().view(torch.int16))


def test_async_save_survives_the_next_in_place_step(tmp_path):
    """The train step writes parameters and moments in place; an async
    save's copy is complete when save returns."""
    cfg, state = _state()
    ts = tstep.make_train_step(cfg, opt_cfg=toptim.AdamWConfig(
        warmup_steps=0))
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    state, _ = ts(state, get_batch(dc, 0, device="cpu"))
    snap = _leaves(state)
    snap = {"params": {k: v.clone() for k, v in snap["params"].items()},
            "m": {k: v.clone() for k, v in snap["opt"]["m"].items()}}
    ck = Checkpointer(tmp_path)
    ck.save(state, 1, blocking=False)
    state, _ = ts(state, get_batch(dc, 1, device="cpu"))     # in place
    ck.wait()
    got = _leaves(ck.restore(state)[0])
    moved = _leaves(state)
    for n, t in snap["params"].items():
        assert torch.equal(got["params"][n], t), n
    for n, t in snap["m"].items():
        assert torch.equal(got["opt"]["m"][n], t), n
    assert not torch.equal(moved["opt"]["m"]["embed"], snap["m"]["embed"])
    assert int(got["step"]) == 1


def test_resume_replays_identically(tmp_path):
    """train k steps, checkpoint, train k more: equal to 2k straight."""
    cfg = tconfigs.get_smoke("llama3_2_1b")
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=3)
    ts = tstep.make_train_step(cfg)

    _, state = _state("llama3_2_1b", seed=1)
    for s in range(6):
        state, _ = ts(state, get_batch(dc, s, device="cpu"))
    straight = _leaves(state)["params"]

    _, state = _state("llama3_2_1b", seed=1)
    ck = Checkpointer(tmp_path)
    for s in range(3):
        state, _ = ts(state, get_batch(dc, s, device="cpu"))
    ck.save(state, 3)
    resumed, start = ck.restore(state)
    for s in range(start, 6):
        resumed, _ = ts(resumed, get_batch(dc, s, device="cpu"))
    d = max(float((straight[n].float() - t.float()).abs().max())
            for n, t in _leaves(resumed)["params"].items())
    assert d < 1e-5


def test_manifest_and_files_equal_the_reference(tmp_path):
    """One state of nested dicts saved by both packages: the same
    manifest.json, the same file names and the same .npy bytes."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((4, 3)).astype(np.float32)
    b16 = rng.standard_normal((2, 5)).astype(ml_dtypes.bfloat16)
    i32 = rng.integers(-5, 5, (3,)).astype(np.int32)
    tree = {"params": {"w": f32, "b": b16, "layers.0.k": i32},
            "opt": {"m": {"w": f32 * 2}}, "step": np.int32(7)}
    jstate = jax.tree.map(jnp.asarray, tree)

    def port(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    tstate = jax.tree.map(port, tree)
    JCheckpointer(tmp_path / "jax").save(jstate, 5)
    Checkpointer(tmp_path / "port").save(tstate, 5)
    jd, td = tmp_path / "jax" / "step_0000000005", \
        tmp_path / "port" / "step_0000000005"
    assert (jd / "manifest.json").read_text() \
        == (td / "manifest.json").read_text()
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir())
    for n in names:
        assert (jd / n).read_bytes() == (td / n).read_bytes(), n
    # and the port restores the reference's files
    back, step = Checkpointer(tmp_path / "jax").restore(tstate)
    assert step == 5
    assert torch.equal(back["params"]["b"].view(torch.int16),
                       tstate["params"]["b"].view(torch.int16))
    assert torch.equal(back["opt"]["m"]["w"], tstate["opt"]["m"]["w"])


def test_restore_on_another_mesh(tmp_path):
    """A state saved from its blocks on (2, 1) restores on (1, 2), and on
    one rank without a mesh, equal to the state saved."""
    cfg, state = _state("qwen3_moe_235b_a22b")
    _, other = _state("qwen3_moe_235b_a22b", seed=5)
    plain = torch_spmd.plain_state(state)
    res = shard_sim.spawn(torch_spmd.ckpt_reshard, 2, (
        cfg, plain, torch_spmd.plain_state(other), str(tmp_path), (2, 1),
        (1, 2)))
    for full, at in res:
        assert at == 7
        for n, t in plain["params"].items():
            assert torch.equal(full["params"][n], t), n
        for k in ("m", "v"):
            for n, t in plain["opt"][k].items():
                assert torch.equal(full["opt"][k][n], t), (k, n)
    one, at = Checkpointer(tmp_path).restore(other)
    assert at == 7
    _assert_states_equal(one, state)
