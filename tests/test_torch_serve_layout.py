"""The port's decode layouts on the CPU: the sequence-sharded cache (a
full cache's slots and the SSM's channels over "model", the reference's
``transformer.init_cache`` specs) and the weights-stationary serve layout
(``partition.serve_rules``).

  * Rank 0's cache blocks of every decode_32k leaf on the 16 x 16 pod
    (``launch.dryrun.cache_specs`` in a subprocess with a fake process
    group of 256 ranks) equal ``NamedSharding.shard_shape`` of the
    reference's ``launch.dryrun.cache_specs`` (a JAX subprocess with its
    512 host devices), for llama3.2-1b, hymba-1.5b, gemma2-9b and
    whisper-large-v3; the parameters' blocks under ``serve_rules`` equal
    the reference's ``state_shardings(..., rules=serve_rules(mesh))``
    for moonshot and llama.
  * The flash-decode combine in one process: a cache cut into 2 and 4
    parts, one of them with no written slot, merged, equals ``attend``
    over the whole.
  * Two spawned gloo ranks (one spawn) run ``make_prefill`` /
    ``make_serve_step(cfg, mesh)`` and ``ServeEngine(mesh=)`` in float32
    from the JAX package's weights: smoke llama on (1, 2) with a cache
    whose second half holds no written slot, with one whose decode writes
    land on rank 1, and with one of 17 slots, which "model" does not
    divide and which stays whole; smoke hymba on (1, 2), its SSM channels
    kept; smoke qwen3-moe on (2, 1) with ``serve_weights_stationary``.
    Four spawned gloo ranks (a second spawn) run the layouts the
    reference deploys, where both splits meet: llama on (2, 2) (rows over
    "data", slots over "model") and qwen3-moe with the flag on (2, 2)
    (experts over "model", their "e_ff" over "data").  Every rank's logits equal the one-device port's and
    ``jax.jit(repro.train.step.make_prefill / make_serve_step)``'s within
    1e-4, and the engine's greedy tokens the one-device and reference
    engines'.  A decode step gathers no SSM state and, under the flag, no
    parameter; the combine takes two all-reduces a layer.
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
from repro.models import transformer as jtransformer
from repro.serve.engine import ServeEngine as JEngine
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core import shard_sim
from repro_torch.models import layers
from repro_torch.models import transformer as ttransformer
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.train import step as tstep

import torch_spmd

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, STEPS, JAX_MAX_SEQ = 4, 8, 3, 32
TOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
# (case, arch, config overrides, mesh, max_seq): llama's rank 1 holds
# slots 16-31 (none written by the prompt or the three steps), 8-15 (the
# steps' writes land there) or, at 17 slots, the whole cache
CASES = [
    ("llama empty rank", "llama3_2_1b", {}, (1, 2), 32),
    ("llama", "llama3_2_1b", {}, (1, 2), 16),
    ("llama whole", "llama3_2_1b", {}, (1, 2), 17),
    ("hymba", "hymba_1_5b", {}, (1, 2), 16),
    ("qwen3-moe ws", "qwen3_moe_235b_a22b",
     {"serve_weights_stationary": True}, (2, 1), 16),
    ("llama 2x2", "llama3_2_1b", {}, (2, 2), 16),
    ("qwen3-moe ws 2x2", "qwen3_moe_235b_a22b",
     {"serve_weights_stationary": True}, (2, 2), 16),
]
SHAPE_ARCHS = ("llama3_2_1b", "hymba_1_5b", "gemma2_9b", "whisper_large_v3")
SERVE_ARCHS = ("llama3_2_1b", "moonshot_v1_16b_a3b")

_PORT = r"""
import json
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import partition
dryrun.init_fake(256)
mesh = make_production_mesh(device="cuda")
out = {"cache": {}, "serve": {}}

def leaves(c, pre):
    for k, t in c.items():
        if isinstance(t, dict):
            yield from leaves(t, pre + [k])
        elif k != "slots":
            yield ".".join(pre + [k]), list(t.shape)

with dryrun.fake_mode():
    for a in %r:
        cache = dryrun.cache_specs(configs.get_config(a), "decode_32k", mesh)
        out["cache"][a] = dict(kv for i, c in enumerate(cache)
                               for kv in leaves(c, [str(i)]))
    for a in %r:
        st = dryrun.state_specs(configs.get_config(a), mesh,
                                rules=partition.serve_rules(mesh))
        out["serve"][a] = {n: list(p.shape) for n, p in
                           st["params"].named_parameters()}
print(json.dumps(out))
""" % (SHAPE_ARCHS, SERVE_ARCHS)

_JAX = r"""
import json
from repro.launch import dryrun      # first: its 512 host devices
import jax
from repro import configs
from repro.launch.mesh import make_production_mesh
from repro.sharding import partition
from repro.train import step
mesh = make_production_mesh()

def keyed(path):
    return [getattr(k, "key", getattr(k, "idx", None)) for k in path]

out = {"cache": {}, "serve": {}}
for a in %r:
    shapes, sh = dryrun.cache_specs(configs.get_config(a), "decode_32k",
                                    mesh)
    out["cache"][a] = [[keyed(p), list(s.shard_shape(l.shape))]
                       for (p, l), s in zip(
                           jax.tree_util.tree_leaves_with_path(shapes),
                           jax.tree_util.tree_leaves(sh))]
for a in %r:
    sh, shapes = step.state_shardings(configs.get_config(a), mesh, 0,
                                      partition.serve_rules(mesh))
    out["serve"][a] = [[keyed(p), list(s.shard_shape(l.shape))]
                       for (p, l), s in zip(
                           jax.tree_util.tree_leaves_with_path(
                               shapes["params"]),
                           jax.tree_util.tree_leaves(sh["params"]))]
print(json.dumps(out))
""" % (SHAPE_ARCHS, SERVE_ARCHS)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


def _models(arch, over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **F32, **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **F32, **over)
    jp, _ = jtransformer.make_params(jcfg, jax.random.key(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _inputs(vocab):
    """Right-padded prompt tokens (B, S), the decode steps' (B, 1)
    tokens, and four prompts for the engine."""
    rng = np.random.default_rng(7)
    toks = np.zeros((B, S), np.int64)
    for i, n in enumerate((S, 5, 7, 3)):
        toks[i, :n] = rng.integers(1, vocab, n)
    steps = [rng.integers(1, vocab, (B, 1)) for _ in range(STEPS)]
    prompts = [rng.integers(1, vocab, n).tolist() for n in (11, 6, 9, 4)]
    return toks, steps, prompts


def _one_device(tcfg, tp, toks, steps, prompts, max_seq):
    cache = ttransformer.init_cache(tcfg, B, max_seq, device="cpu")
    with torch.no_grad():
        lg, cache = tstep.make_prefill(tcfg)(tp, torch.from_numpy(toks),
                                             cache)
        out = [lg]
        for i, t in enumerate(steps):
            lg, cache = tstep.make_serve_step(tcfg)(
                tp, cache, torch.from_numpy(t), S + i)
            out.append(lg)
    eng = TEngine(tcfg, tp, max_batch=B, max_seq=max_seq, device="cpu")
    return out, [g.tokens for g in eng.generate(prompts, max_new=STEPS + 2)]


def _jax(jcfg, jp, toks, steps, prompts):
    jc, _ = jtransformer.init_cache(jcfg, B, JAX_MAX_SEQ)
    lg, jc = jax.jit(jstep.make_prefill(jcfg))(
        jp, jnp.asarray(toks, jnp.int32), jc)
    out, decode = [np.asarray(lg)], jax.jit(jstep.make_serve_step(jcfg))
    for i, t in enumerate(steps):
        lg, jc = decode(jp, jc, jnp.asarray(t, jnp.int32), jnp.int32(S + i))
        out.append(np.asarray(lg))
    eng = JEngine(jcfg, jp, max_batch=B, max_seq=JAX_MAX_SEQ)
    return out, [g.tokens for g in eng.generate(prompts, max_new=STEPS + 2)]


@pytest.fixture(scope="module")
def shapes():
    """The port's and the reference's block shapes, from two subprocesses
    run side by side."""
    procs = [subprocess.Popen([sys.executable, "-c", code], env=_env(),
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for code in (_PORT, _JAX)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


def _port_names(cfg, path, shard):
    """{port name: block shape} of one reference leaf: a stacked leaf
    of pattern position j is a leaf a layer i (i % period == j), its
    stacked dim unsplit."""
    if path[0] == "layers":
        _, j, *rest = path
        return {".".join(["layers", str(i), *rest]): tuple(shard[1:])
                for i in range(cfg.n_layers) if i % cfg.period == j}
    if path[:2] == ["enc", "layers"]:
        return {".".join(["enc", "layers", str(i), *path[2:]]):
                tuple(shard[1:]) for i in range(cfg.enc_layers)}
    return {".".join(path): tuple(shard)}


@pytest.mark.parametrize("arch", SHAPE_ARCHS)
def test_rank0_cache_blocks_equal_the_references(shapes, arch):
    port, ref = shapes
    cfg = jconfigs.get_config(arch)
    want = {}
    for path, shard in ref["cache"][arch]:
        j, rest = path[0], [str(k) for k in path[1:]]
        for i in range(cfg.n_layers):
            if i % cfg.period == j:
                want[".".join([str(i), *rest])] = tuple(shard[1:])
    got = {n: tuple(s) for n, s in port["cache"][arch].items()}
    assert got == want, arch


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_rules_param_blocks_equal_the_references(shapes, arch):
    port, ref = shapes
    cfg = jconfigs.get_config(arch)
    want = {}
    for path, shard in ref["serve"][arch]:
        want.update(_port_names(cfg, path, shard))
    got = {n: tuple(s) for n, s in port["serve"][arch].items()}
    assert got == want, arch


def _merge(parts):
    """The flash-decode combine of ``attend_partial``'s (m, l, o) parts in
    one process: ``spmd.decode_combine``'s two sums, over a list."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    num = den = 0.0
    for mp, lp, op in parts:
        w = torch.exp(mp - m)
        num = num + op * w[..., None]
        den = den + lp * w
    return num / den[..., None]


@pytest.mark.parametrize("n", [2, 4])
def test_flash_decode_combine_equals_whole_attend(n):
    """Parts of a cache (the last with no written slot) merged by their
    statistics equal ``attend`` over the whole cache; so does a part
    holding every valid key beside empty ones."""
    g = torch.Generator().manual_seed(n)
    Bq, H, KV, hd, W, pos = 3, 8, 2, 16, 24, 11
    q = torch.randn(Bq, 1, H, hd, generator=g)
    k = torch.randn(Bq, W, KV, hd, generator=g)
    v = torch.randn(Bq, W, KV, hd, generator=g)
    ids = torch.arange(W)[None].expand(Bq, W)
    kv_pos = torch.where(ids <= pos, ids, -1)
    kv_pos[1, 3] = -1                                   # a hole
    want = layers.attend(q, k, v, causal=True, q_offset=pos,
                         kv_positions=kv_pos, attn_softcap=30.0)
    w = W // n
    parts = [layers.attend_partial(
        q, k[:, i * w:(i + 1) * w], v[:, i * w:(i + 1) * w], q_offset=pos,
        kv_positions=kv_pos[:, i * w:(i + 1) * w], attn_softcap=30.0)
        for i in range(n)]
    m, l, o = parts[-1]                                 # no valid slot
    assert (l == 0).all() and (o == 0).all()
    assert (m == layers.NEG_INF).all()
    got = _merge(parts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def runs():
    """Every case through one spawn a world size (two ranks, then four),
    with its one-device and JAX counterparts (JAX's once an
    architecture)."""
    refs, args, jaxes = {}, {}, {}
    for name, arch, over, shape, max_seq in CASES:
        jcfg, jp, tcfg, tp = _models(arch, over)
        toks, steps, prompts = _inputs(tcfg.vocab)
        if arch not in jaxes:
            jaxes[arch] = _jax(jcfg, jp, toks, steps, prompts)
        refs[name] = (_one_device(tcfg, tp, toks, steps, prompts, max_seq),
                      jaxes[arch], tcfg)
        plain = {n: t.detach() for n, t in tp.named_parameters()}
        args.setdefault(shape[0] * shape[1], []).append((name, (
            "serve_layout", (tcfg, plain, torch.from_numpy(toks),
                             [torch.from_numpy(t) for t in steps], prompts,
                             shape, max_seq))))
    res = {}
    for world, cases in args.items():
        ranks = shard_sim.spawn(torch_spmd.plan, world,
                                ([a for _, a in cases],))
        for i, (name, _) in enumerate(cases):
            res[name] = [(outs[i], mods) for outs, mods in ranks]
    return refs, res


def _case(runs, name):
    refs, res = runs
    i = [c[0] for c in CASES].index(name)
    return CASES[i], refs[name], res[name]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_decode_layout_matches_one_device_and_jax(runs, name):
    (_, arch, over, shape, max_seq), ((one, one_tok), (jx, jx_tok), cfg), \
        ranks = _case(runs, name)
    assert one_tok == jx_tok                  # the references agree
    for r, (out, mods) in enumerate(ranks):
        assert not mods                       # the port stands alone
        tag = (name, r)
        assert len(out["logits"]) == 1 + STEPS
        for k, (got, o, j) in enumerate(zip(out["logits"], one, jx)):
            assert got.shape == o.shape == (B, cfg.vocab), (tag, k)
            np.testing.assert_allclose(got.numpy(), o.numpy(), atol=TOL,
                                       rtol=TOL, err_msg=f"{tag} call {k}")
            np.testing.assert_allclose(got.numpy(), j, atol=TOL, rtol=TOL,
                                       err_msg=f"{tag} call {k} vs JAX")
        assert out["tokens"] == one_tok, tag


def test_full_cache_slots_split_over_model(runs):
    """llama on (1, 2): each rank holds half the slots (its ``slots`` ids)
    and its decode step combines in two all-reduces a layer after one
    all-gather of the queries; at 17 slots the cache stays whole and
    decode attends as on one device."""
    cfg = dataclasses.replace(tconfigs.get_smoke("llama3_2_1b"), **F32)
    kv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    for name, W in (("llama empty rank", 32), ("llama", 16)):
        _, _, ranks = _case(runs, name)
        for r, (out, _) in enumerate(ranks):
            c = out["cache"]
            assert c["0.k"] == c["0.v"] == (B, W // 2, kv, hd)
            assert c["0.pos_ids"] == (B, W // 2)
            assert c["0.slots"] == (W // 2,)
            for calls in out["decode"]:
                red = [s for n, s, _ in calls if n == "all_reduce"]
                assert red.count((B, 1, cfg.n_heads)) == L, calls
                assert red.count((B, 1, cfg.n_heads, hd + 1)) == L, calls
                # the all-gather takes its dim first: heads, rows, 1, hd
                q = [s for n, s, _ in calls if n in torch_spmd.GATHERS
                     and s == (cfg.n_heads // 2, B, 1, hd)]
                assert len(q) == L, calls
    _, _, ranks = _case(runs, "llama whole")
    for out, _ in ranks:
        assert out["cache"]["0.k"] == (B, 17, kv, hd)
        assert "0.slots" not in out["cache"]
        for calls in out["decode"]:
            assert (B, 1, cfg.n_heads) not in [s for _, s, _ in calls]


def test_ssm_channels_stay_a_ranks_block(runs):
    """hymba on (1, 2): the cache holds the rank's half of the SSM's
    channels, and no decode step gathers a state."""
    cfg = dataclasses.replace(tconfigs.get_smoke("hymba_1_5b"), **F32)
    Dh, K, N = cfg.d_ssm // 2, cfg.ssm_conv, cfg.ssm_state
    conv, h = (B, K - 1, Dh), (B, Dh, N)
    # either block as an all-gather takes it: its channels' dim first
    states = {conv, h, (Dh, B, K - 1), (Dh, B, N)}
    _, _, ranks = _case(runs, "hymba")
    for out, _ in ranks:
        assert out["cache"]["0.ssm.conv"] == conv
        assert out["cache"]["0.ssm.h"] == h
        for calls in out["decode"]:
            gathered = [s for n, s, _ in calls if n in torch_spmd.GATHERS]
            assert gathered, calls              # the step does gather
            assert not states & set(gathered), gathered


def test_weights_stationary_decode_gathers_no_parameter(runs):
    """qwen3-moe with ``serve_weights_stationary`` on (2, 1): the
    experts' "e_ff" halved on each rank, nothing gathered by the steps'
    ``Gatherer``; a decode step's all-gathers are the MoE layers' input
    rows and the logits' rows, and each MoE layer reduce-scatters its
    rows back."""
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3_moe_235b_a22b"),
                              **F32)
    _, _, ranks = _case(runs, "qwen3-moe ws")
    rows = B // 2
    for out, _ in ranks:
        assert out["param_gathers"] == (0, 0), out["param_gathers"]
        assert out["cache"]["0.k"][0] == rows
        for calls in out["decode"]:
            gathered = [s for n, s, _ in calls if n in torch_spmd.GATHERS]
            assert gathered.count((rows, 1, cfg.d_model)) == cfg.n_layers
            assert set(gathered) == {(rows, 1, cfg.d_model),
                                     (rows, cfg.vocab)}, gathered
            rs = [s for n, s, _ in calls if n.startswith("reduce_scatter")]
            assert rs == [(B, 1, cfg.d_model)] * cfg.n_layers, calls


def test_combined_layouts_split_both_axes(runs):
    """On (2, 2) each rank holds its rows and half the slots; llama's
    decode step combines in two all-reduces a layer over its rows, and
    qwen3-moe under the flag gathers no parameter, gathers its MoE input
    rows over "data" and reduce-scatters them back, a layer each."""
    cfg = dataclasses.replace(tconfigs.get_smoke("llama3_2_1b"), **F32)
    kv, hd, L, rows = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers, B // 2
    _, _, ranks = _case(runs, "llama 2x2")
    assert len(ranks) == 4
    for out, _ in ranks:
        assert out["cache"]["0.k"] == (rows, 8, kv, hd)
        assert out["cache"]["0.slots"] == (8,)
        for calls in out["decode"]:
            red = [s for n, s, _ in calls if n == "all_reduce"]
            assert red.count((rows, 1, cfg.n_heads)) == L, calls
            assert red.count((rows, 1, cfg.n_heads, hd + 1)) == L, calls
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3_moe_235b_a22b"),
                              **F32)
    _, _, ranks = _case(runs, "qwen3-moe ws 2x2")
    for out, _ in ranks:
        assert out["param_gathers"] == (0, 0), out["param_gathers"]
        assert out["cache"]["0.k"][:2] == (rows, 8)
        for calls in out["decode"]:
            gathered = [s for n, s, _ in calls if n in torch_spmd.GATHERS]
            assert gathered.count((rows, 1, cfg.d_model)) == cfg.n_layers
            rs = [s for n, s, _ in calls if n.startswith("reduce_scatter")]
            assert rs == [(B, 1, cfg.d_model)] * cfg.n_layers, calls
