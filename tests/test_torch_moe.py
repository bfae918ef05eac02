"""The MoE layer of the port (``repro_torch.models.moe``), function by
function against ``repro.models.moe`` on the same numpy inputs and the
same parameters (carried across from the reference's ``_moe_params``),
and the reference's own laws (tests/test_moe.py) held on the port.

Tolerances: routes, positions, dispatch maps, gathered rows and
``dropped`` exactly (integer work, or copies); gates 1e-6 and aux rel
1e-5 (float32 softmax and logsumexp, summed in another order); the layer's
output float32 1e-5 and bfloat16 5e-2 (the reference's own bf16
decode-vs-train tolerance, tests/test_archs.py: both packages round the
bf16 products, but at other places); scatter against the port's own
einsum oracle 2e-2, as tests/test_moe.py holds the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                       # pragma: no cover
    HAVE_HYPOTHESIS = False

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import _param_tensor
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ["qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b"]   # moonshot: shared


def _cfgs(arch="qwen3_moe_235b_a22b", dtype="float32", **kw):
    kw |= dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


def _params(jcfg, seed=0):
    """The reference's MoE parameters and the port's copy, bit for bit."""
    jp, _ = jtransformer._moe_params(jcfg, jax.random.key(seed))
    conv = lambda t: {k: conv(v) for k, v in t.items()} \
        if isinstance(t, dict) else _param_tensor(np.asarray(t), "cpu")
    return jp, conv(jp)


def _x(shape, dtype, seed=1):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(JD[dtype]), torch.from_numpy(a).to(TD[dtype])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") \
        else np.float32(x)


def _topi(jcfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, jcfg.n_experts, (B, S, jcfg.top_k)).astype(np.int32)


def _distinct_topi(jcfg, B, S, seed):
    """Routes as top_k gives them: k distinct experts a token."""
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.permutation(jcfg.n_experts)[:jcfg.top_k]
                               for _ in range(S)]) for _ in range(B)]
                    ).astype(np.int32)


# --------------------------------------------------------------------------
# function by function against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,cf", [(1, 1.25), (16, 1.25), (64, 0.5),
                                  (1536, 1.25), (7, 8.0)])
def test_capacity_matches(S, cf):
    for arch in ARCHS:
        for get in ("get_smoke", "get_config"):
            jcfg = dataclasses.replace(getattr(jconfigs, get)(arch),
                                       capacity_factor=cf)
            tcfg = dataclasses.replace(getattr(tconfigs, get)(arch),
                                       capacity_factor=cf)
            assert tmoe.capacity(tcfg, S) == jmoe.capacity(jcfg, S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg)
    jx, tx = _x((3, 40, jcfg.d_model), dtype)
    jt, jg, ja = jmoe.route(jp, jx, jcfg)
    tt, tg, ta = tmoe.route(tp, tx, tcfg)
    assert tt.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)


@pytest.mark.parametrize("B,S,k,E", [(2, 16, 2, 8), (1, 1, 8, 128),
                                     (3, 300, 6, 64), (1, 1100, 4, 8),
                                     (2, 1100, 4, 64)])
def test_positions_in_expert_matches(B, S, k, E):
    """Exact; S*k = 4,400 > 4,096 crosses the reference's chunk boundary."""
    jcfg, tcfg = _cfgs(n_experts=E, top_k=k)
    topi = _topi(jcfg, B, S, seed=S + E)
    got = tmoe._positions_in_expert(torch.from_numpy(topi), tcfg)
    exp = jmoe._positions_in_expert(jnp.asarray(topi), jcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_dispatch_matches(cf, dtype):
    """The inverse map exactly, overflow sliced away; the gathered rows
    bit for bit (empty slots zero)."""
    jcfg, tcfg = _cfgs(dtype=dtype, capacity_factor=cf)
    B, S = 2, 24
    topi = _distinct_topi(jcfg, B, S, 3)
    C = jmoe.capacity(jcfg, S)
    jpos = jmoe._positions_in_expert(jnp.asarray(topi), jcfg)
    tpos = torch.from_numpy(np.array(jpos))
    jx, tx = _x((B, S, jcfg.d_model), dtype)
    jh, jinv = jmoe._dispatch(jx, jnp.asarray(topi), jpos, jpos < C, C, jcfg)
    th, tinv = tmoe._dispatch(tx, torch.from_numpy(topi), tpos, tpos < C, C,
                              tcfg)
    assert cf > 1 or (np.asarray(jpos) >= C).any()       # drops at cf 0.5
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    assert th.dtype == TD[dtype] and th.shape == (B, jcfg.n_experts, C,
                                                   jcfg.d_model)
    np.testing.assert_array_equal(_np(th), _np(jh))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches(dtype):
    jcfg, tcfg = _cfgs("moonshot_v1_16b_a3b", dtype)
    jp, tp = _params(jcfg)
    jh, th = _x((2, jcfg.n_experts, 5, jcfg.d_model), dtype, seed=4)
    got = tmoe._expert_ffn(tp, th, tcfg)
    assert got.dtype == TD[dtype]
    np.testing.assert_allclose(_np(got), _np(jmoe._expert_ffn(jp, jh, jcfg)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_combine_local_matches(cf, dtype):
    """Gate-weighted sum of each token's kept choices, the k choices added
    one at a time in the expert output's dtype."""
    jcfg, tcfg = _cfgs(dtype=dtype, capacity_factor=cf)
    B, S, E = 2, 24, jcfg.n_experts
    C = jmoe.capacity(jcfg, S)
    topi = _distinct_topi(jcfg, B, S, 5)
    pos = np.array(jmoe._positions_in_expert(jnp.asarray(topi), jcfg))
    gates = np.random.default_rng(6).dirichlet(
        np.ones(jcfg.top_k), (B, S)).astype(np.float32)
    jeo, teo = _x((B, E, C, jcfg.d_model), dtype, seed=7)
    exp = jmoe._combine_local(jeo, jnp.asarray(topi), jnp.asarray(pos),
                              jnp.asarray(pos < C), jnp.asarray(gates), 0,
                              E, S)
    got = tmoe._combine_local(teo, torch.from_numpy(topi),
                              torch.from_numpy(pos),
                              torch.from_numpy(pos < C),
                              torch.from_numpy(gates), 0, E, S)
    assert got.dtype == TD[dtype]
    np.testing.assert_allclose(_np(got), _np(exp), atol=TOL[dtype] / 10,
                               rtol=TOL[dtype] / 10)


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["moe_scatter", "moe_einsum"])
def test_moe_layer_matches(impl, arch, dtype, cf):
    """out, aux and dropped of the whole layer; cf 0.5 drops tokens."""
    jcfg, tcfg = _cfgs(arch, dtype, capacity_factor=cf)
    jp, tp = _params(jcfg)
    jx, tx = _x((2, 32, jcfg.d_model), dtype, seed=8)
    jo, ja, jd = getattr(jmoe, impl)(jp, jx, jcfg)
    to, ta, td = getattr(tmoe, impl)(tp, tx, tcfg)
    assert to.dtype == TD[dtype] and to.shape == tx.shape
    assert td.dtype == torch.int32 and int(td) == int(jd)
    assert cf > 1 or int(td) > 0
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)
    np.testing.assert_allclose(_np(to), _np(jo), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("impl,oracle", [("einsum", True), ("scatter", False),
                                         ("dense", False)])
def test_moe_block_picks_as_the_reference(impl, oracle, monkeypatch):
    _, tcfg = _cfgs(moe_impl=impl)
    called = []
    monkeypatch.setattr(tmoe, "moe_einsum",
                        lambda *a: called.append("einsum") or "e")
    monkeypatch.setattr(tmoe, "moe_scatter",
                        lambda *a: called.append("scatter") or "s")
    tmoe.moe_block({}, None, tcfg)
    assert called == (["einsum"] if oracle else ["scatter"])


def _ctx(**sizes):                 # a mesh's sizes alone, at rank 0
    from repro_torch.sharding import spmd
    return spmd.Ctx(None, sizes, {a: 0 for a in sizes})


def test_mesh_with_model_shards_is_refused():
    """With more than one model shard dividing E, the experts are split
    (tests/test_torch_mesh_moe.py runs them on spawned ranks): the full
    expert weights are refused, so is the one-hot oracle, which holds
    every expert.  A mesh with one model shard, or one whose shards do not
    divide E, runs the local path."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    _, tx = _x((2, 8, tcfg.d_model), "float32")
    with pytest.raises(ValueError, match="this rank runs"):
        tmoe.moe_scatter(tp, tx, tcfg, _ctx(data=1, model=2))
    with pytest.raises(ValueError, match="this rank runs"):
        tmoe.moe_block(tp, tx, tcfg, _ctx(data=2, model=4))
    with pytest.raises(ValueError, match="every expert"):
        tmoe.moe_block(tp, tx, dataclasses.replace(tcfg, moe_impl="einsum"),
                       _ctx(data=1, model=2))
    ref = tmoe.moe_scatter(tp, tx, tcfg)
    for ctx in (_ctx(data=4, model=1), _ctx(data=2), _ctx(model=3)):
        got = tmoe.moe_block(tp, tx, tcfg, ctx)
        torch.testing.assert_close(got[0], ref[0], atol=0, rtol=0)


# --------------------------------------------------------------------------
# the reference's laws (tests/test_moe.py) on the port
# --------------------------------------------------------------------------

def _port(cf=None, seed=0, **kw):
    """The port's own parameters for the qwen3 smoke config with ``kw``."""
    tcfg = dataclasses.replace(tconfigs.get_smoke("qwen3_moe_235b_a22b"),
                               **kw)
    init = ttransformer._Init(tcfg, torch.Generator().manual_seed(seed),
                              torch.device("cpu"))
    return tcfg, ttransformer._moe_params(tcfg, init)


def _tx(shape, seed=1, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("B,S,E,k,cf", [
    (2, 16, 8, 2, 1.25),
    (1, 32, 4, 1, 1.0),
    (3, 8, 8, 4, 2.0),
    (2, 1, 8, 2, 1.25),          # decode shape
])
def test_scatter_matches_einsum(B, S, E, k, cf):
    cfg, p = _port(n_experts=E, top_k=k, capacity_factor=cf)
    x = _tx((B, S, cfg.d_model), dtype=torch.bfloat16)
    a, aux_a, drop_a = tmoe.moe_scatter(p, x, cfg)
    b, aux_b, drop_b = tmoe.moe_einsum(p, x, cfg)
    torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)
    assert int(drop_a) == int(drop_b)
    assert float(aux_a) == pytest.approx(float(aux_b), rel=1e-5)


def test_high_capacity_is_dropless():
    cfg, p = _port(capacity_factor=8.0)
    _, _, dropped = tmoe.moe_scatter(p, _tx((2, 32, cfg.d_model)), cfg)
    assert int(dropped) == 0


def test_capacity_drops_monotone():
    cfg_lo, p = _port(capacity_factor=0.5)
    cfg_hi = dataclasses.replace(cfg_lo, capacity_factor=1.5)
    x = _tx((2, 64, cfg_lo.d_model))
    _, _, d_lo = tmoe.moe_scatter(p, x, cfg_lo)
    _, _, d_hi = tmoe.moe_scatter(p, x, cfg_hi)
    assert int(d_lo) > int(d_hi)


def test_shared_experts_add_dense_path():
    cfg, p = _port(n_shared_experts=1)
    x = _tx((2, 8, cfg.d_model), dtype=torch.bfloat16)
    out_with, _, _ = tmoe.moe_scatter(p, x, cfg)
    p2 = {k: v for k, v in p.items() if k != "shared"}
    cfg2 = dataclasses.replace(cfg, n_shared_experts=0)
    out_wo, _, _ = tmoe.moe_scatter(p2, x, cfg2)
    assert (out_with.float() - out_wo.float()).abs().max() > 1e-3


def _check_positions_unique(seed, S):
    cfg, _ = _port()
    topi = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.n_experts, (2, S, cfg.top_k)))
    pos = tmoe._positions_in_expert(topi, cfg)
    t, q = topi.reshape(2, -1).numpy(), pos.reshape(2, -1).numpy()
    for b in range(2):
        for e in range(cfg.n_experts):
            sel = q[b][t[b] == e]
            assert len(np.unique(sel)) == len(sel)          # no collisions
            if len(sel):
                assert set(sel) == set(range(len(sel)))     # dense 0..n-1


if HAVE_HYPOTHESIS:
    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 99), S=st.integers(1, 24))
    def test_positions_in_expert_are_unique_per_expert(seed, S):
        _check_positions_unique(seed, S)
else:
    @pytest.mark.parametrize("seed,S", [(0, 1), (7, 8), (42, 24)])
    def test_positions_in_expert_are_unique_per_expert(seed, S):
        _check_positions_unique(seed, S)


def test_router_gates_normalized():
    cfg, p = _port()
    topi, gates, aux = tmoe.route(p, _tx((2, 8, cfg.d_model)), cfg)
    torch.testing.assert_close(gates.sum(-1), torch.ones(2, 8), atol=1e-5,
                               rtol=1e-5)
    assert (topi < cfg.n_experts).all() and (topi >= 0).all()
    assert torch.isfinite(aux)


def test_route_flip_rule():
    """The card-vs-CPU rule of tests/torch_kernel_inputs.py on the CPU:
    every MoE layer's route is recorded; equal runs give no flip; a
    differing route is returned where the CPU's gap is under the bound and
    raises where it is not."""
    from torch_kernel_inputs import ROUTE_GAP, recorded_routes, route_flips
    cfg = tconfigs.get_smoke("moonshot_v1_16b_a3b")
    p = ttransformer.make_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12)))
    runs = []
    for _ in range(2):
        with recorded_routes(tmoe) as calls:
            ttransformer.forward(cfg, p, toks)
        runs.append(calls)
    assert tmoe.route.__name__ == "route" and len(runs[0]) == cfg.n_layers
    assert route_flips(runs[0], runs[1]) == []
    topi, gap = runs[1][1]
    moved = topi.clone()
    moved[1, 5, 0] = (moved[1, 5, 0] + 1) % cfg.n_experts
    near = gap.clone()
    near[1, 5] = ROUTE_GAP / 2
    flips = route_flips([runs[0][0], (moved, gap)],
                        [runs[1][0], (topi, near)])
    assert len(flips) == 1 and flips[0][:3] == (1, 1, 5)
    assert flips[0][3] == pytest.approx(ROUTE_GAP / 2)
    with pytest.raises(AssertionError, match="not a near-tie"):
        route_flips([runs[0][0], (moved, gap)], runs[1])
