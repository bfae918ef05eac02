"""The model side of ``repro_torch.sharding.partition`` and the port's
logical specs against the JAX package: the reference's rule tests
(tests/test_distribution.py) mirrored, a sweep of logical specs, shapes
and ("pod", "data", "model") meshes whose port specs equal the
reference's ``PartitionSpec``s as tuples, ``param_specs``/``cache_specs``
of every architecture's smoke config equal to the reference's
``make_params``/``init_cache`` specs without the stacked axis, the
state's shardings and meta shapes, and ``sharding/spmd.py``'s pieces on
spawned CPU ranks (gloo)."""

import jax
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                       # pragma: no cover
    HAVE_HYPOTHESIS = False

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.sharding import partition as jpart
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.core import shard_sim
from repro_torch.models import transformer as ttransformer
from repro_torch.sharding import partition as tpart
from repro_torch.train import step as tstep

import torch_spmd

torch.set_num_threads(1)


class JMesh:                     # the reference's FakeMesh
    def __init__(self, **axes):
        self.axis_names, self.shape = tuple(axes), dict(axes)


class TMesh:                     # a DeviceMesh's names and sizes alone
    def __init__(self, **axes):
        self.mesh_dim_names, self.shape = tuple(axes), tuple(axes.values())


def _meshes(**axes):
    return JMesh(**axes), TMesh(**axes)


# --------------------------------------------------------------------------
# the reference's rule tests, mirrored
# --------------------------------------------------------------------------

def test_resolve_spec_basic():
    rules = {"vocab": ("model",), "embed": ("data",), "ff": ("model",)}
    assert tpart.resolve_spec(("vocab", "embed"), (1600, 512),
                              TMesh(data=4, model=8), rules) \
        == ("model", "data")


def test_resolve_spec_divisibility_fallback():
    rules = {"vocab": ("model",), "embed": ("data",)}
    assert tpart.resolve_spec(("vocab", "embed"), (1601, 512),
                              TMesh(data=4, model=8), rules) == (None, "data")


def test_resolve_spec_single_use_rail():
    rules = {"a": ("model",), "b": ("model",)}
    assert tpart.resolve_spec(("a", "b"), (64, 64), TMesh(data=4, model=8),
                              rules) == ("model",)


def test_batch_pspec_fallback_for_tiny_batch():
    m = TMesh(data=4, model=8)
    assert tpart.batch_pspec(m, 1) == ()
    assert tpart.batch_pspec(m, 8) == ("data",)
    assert tpart.batch_pspec(TMesh(pod=2, data=4, model=8), 8) \
        == (("pod", "data"),)


def test_serve_rules_weights_stationary():
    m = TMesh(data=4, model=8)
    rules = tpart.serve_rules(m)
    assert rules["embed"] is None
    assert tpart.resolve_spec(("expert", "embed", "e_ff"), (64, 512, 1408),
                              m, rules) == ("model", None, "data")


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("axes", [dict(data=4, model=8),
                                  dict(pod=2, data=4, model=8),
                                  dict(data=1, model=2)])
def test_rules_equal_the_reference(axes, fsdp):
    jm, tm = _meshes(**axes)
    assert tpart.batch_axes(tm) == jpart.batch_axes(jm)
    assert tpart.default_rules(tm, fsdp=fsdp) \
        == jpart.default_rules(jm, fsdp=fsdp)
    assert tpart.serve_rules(tm) == jpart.serve_rules(jm)
    for B in (None, 1, 6, 8, 16):
        assert tpart.batch_pspec(tm, B) == tuple(jpart.batch_pspec(jm, B))


# --------------------------------------------------------------------------
# a sweep of specs, shapes and meshes
# --------------------------------------------------------------------------

NAMES = [None, "vocab", "heads", "kv", "kv_heads", "ff", "expert", "e_ff",
         "ssm", "embed", "batch", "kv_seq", "seq"]


def _check_sweep(logical, dims, pod, data, model, serve):
    jm, tm = _meshes(**({"pod": pod} if pod else {}), data=data, model=model)
    jr = jpart.serve_rules(jm) if serve else jpart.default_rules(jm)
    tr = tpart.serve_rules(tm) if serve else tpart.default_rules(tm)
    shape = tuple(dims[:len(logical)])
    got = tpart.resolve_spec(tuple(logical), shape, tm, tr)
    exp = jpart.resolve_spec(tuple(logical), shape, jm, jr)
    assert got == tuple(exp), (logical, shape, got, exp)
    assert tpart.is_spec(got)


if HAVE_HYPOTHESIS:
    @settings(max_examples=150, deadline=None)
    @given(logical=st.lists(st.sampled_from(NAMES), min_size=0, max_size=4),
           dims=st.lists(st.sampled_from([1, 2, 3, 6, 8, 12, 16, 64, 96]),
                         min_size=4, max_size=4),
           pod=st.sampled_from([0, 1, 2]), data=st.sampled_from([1, 2, 4]),
           model=st.sampled_from([1, 2, 3, 8]), serve=st.booleans())
    def test_resolve_spec_sweep_equals_reference(logical, dims, pod, data,
                                                 model, serve):
        _check_sweep(logical, dims, pod, data, model, serve)
else:
    @pytest.mark.parametrize("logical,dims,pod,data,model,serve", [
        (["expert", "embed", "e_ff"], [64, 96, 12, 1], 2, 4, 8, True),
        (["vocab", "embed"], [96, 64, 1, 1], 2, 2, 3, False),
        (["batch", "kv_seq", "kv_heads", None], [8, 16, 2, 64], 0, 4, 8,
         False),
        (["embed", "heads"], [3, 16, 1, 1], 1, 2, 8, False)])
    def test_resolve_spec_sweep_equals_reference(logical, dims, pod, data,
                                                 model, serve):
        _check_sweep(logical, dims, pod, data, model, serve)


# --------------------------------------------------------------------------
# logical specs of every architecture
# --------------------------------------------------------------------------

def _ref_leaf(tree, parts):
    for k in parts:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_param_specs_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    max_seq = 32 if jcfg.pos == "learned" else 0
    jshapes, jspecs = jstep._params_shapes_specs(jcfg, max_seq)
    got = ttransformer.param_specs(tcfg, max_seq)
    meta = ttransformer.make_params(tcfg, None, device="meta",
                                    max_seq=max_seq)
    assert list(got) == [n for n, _ in meta.named_parameters()]
    for name, p in meta.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":              # stacked over periods
            i = int(parts[1])
            ref = _ref_leaf(jspecs["layers"][i % tcfg.period], parts[2:])
            shape = _ref_leaf(jshapes["layers"][i % tcfg.period],
                              parts[2:]).shape
            ref, shape = ref[1:], shape[1:]
        elif parts[:2] == ["enc", "layers"]:  # stacked over enc_layers
            ref = _ref_leaf(jspecs["enc"]["layers"], parts[3:])[1:]
            shape = _ref_leaf(jshapes["enc"]["layers"], parts[3:]).shape[1:]
        else:
            ref = _ref_leaf(jspecs, parts)
            shape = _ref_leaf(jshapes, parts).shape
        assert got[name] == tuple(ref), (arch, name, got[name], ref)
        assert tuple(p.shape) == tuple(shape), (arch, name)


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_cache_specs_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    B, S = 2, 8
    _, jspecs = jtransformer.init_cache(jcfg, B, S)
    got = ttransformer.cache_specs(tcfg, B, S)
    caches = ttransformer.init_cache(tcfg, B, S, device="cpu")
    assert len(got) == len(caches) == tcfg.n_layers

    def drop(tree):
        return {k: drop(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tuple(tree[1:])

    def shapes_match(sp, c):
        if isinstance(sp, dict):
            assert set(sp) == set(c)
            for k in sp:
                shapes_match(sp[k], c[k])
        else:
            assert len(sp) == c.dim()

    for i, (sp, c) in enumerate(zip(got, caches)):
        assert sp == drop(jspecs[i % tcfg.period]), (arch, i)
        shapes_match(sp, c)


def test_state_shardings_cover_all_leaves():
    tcfg = tconfigs.get_smoke("llama3_2_1b")
    mesh = TMesh(data=2, model=2)
    sh, shapes = tstep.state_shardings(tcfg, mesh)
    flat = lambda t: t if not isinstance(t, dict) else \
        [x for v in t.values() for x in (flat(v) if isinstance(v, dict)
                                         else [v])]
    leaves = flat(shapes)
    shardings = flat(sh)
    assert len(shardings) == len(leaves) == 3 * len(shapes["params"]) + 1
    assert all(isinstance(s, tpart.Sharding) and s.mesh is mesh
               for s in shardings)
    assert sh["step"].spec == ()
    # the reference's counts on a one-device mesh: one sharding a leaf
    jsh, jshapes = jstep.state_shardings(
        jconfigs.get_smoke("llama3_2_1b"), jax.make_mesh((1, 1),
                                                         ("data", "model")))
    assert len(jax.tree.leaves(jshapes)) == 3 * len(
        jax.tree.leaves(jshapes["params"])) + 1


@pytest.mark.parametrize("axes", [dict(data=2, model=2),
                                  dict(pod=2, data=2, model=4)])
def test_tree_pspecs_equal_the_reference(axes):
    """Every leaf of a smoke MoE and a hybrid config, resolved on a fake
    mesh, against the reference's ``tree_pspecs`` of its stacked tree."""
    jm, tm = _meshes(**axes)
    for arch in ("qwen3_moe_235b_a22b", "hymba_1_5b"):
        jcfg = jconfigs.get_smoke(arch)
        tcfg = tconfigs.get_smoke(arch)
        jshapes, jspecs = jstep._params_shapes_specs(jcfg, 0)
        jps = jpart.tree_pspecs(jspecs, jshapes, jm)
        sh, _ = tstep.state_shardings(tcfg, tm)
        for name, s in sh["params"].items():
            parts = name.split(".")
            if parts[0] == "layers":
                ref = _ref_leaf(jps["layers"][int(parts[1]) % tcfg.period],
                                parts[2:])
                # the stacked axis is never split: drop its entry
                assert ref[:1] in ((), (None,))
                ref = tuple(ref)[1:]
            else:
                ref = tuple(_ref_leaf(jps, parts))
            assert s.spec == ref, (arch, name, s.spec, ref)


def test_state_shapes_allocate_nothing():
    """The full hymba-1.5b state (1.5 B parameters, 18 GB with moments)
    comes back as meta tensors."""
    cfg = tconfigs.get_config("hymba_1_5b")
    shapes, specs = tstep.state_shapes_and_specs(cfg)
    leaves = list(shapes["params"].values()) \
        + [t for k in ("m", "v") for t in shapes["opt"][k].values()] \
        + [shapes["step"]]
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in shapes["params"].values())
    assert n > 1.4e9
    assert set(specs["params"]) == set(shapes["params"])
    assert all(shapes["opt"][k][n].dtype == torch.float32
               for k in ("m", "v") for n in shapes["params"])


# --------------------------------------------------------------------------
# sharding/spmd.py on spawned CPU ranks
# --------------------------------------------------------------------------

def test_spmd_pieces_on_meshes():
    """Block and gather round-trip for specs over one axis and two; a split
    batch's gradient reduce equals the block of the summed gradient; a
    replicated gradient only cuts; the norm of blocks counts a replicated
    leaf once; the expert-parallel region (slice, copy, sum) gives the
    one-device value and gradient, the sum's gradient not scaled by the
    shard count.  On (2,1), (1,2) and (2,2)."""
    r2 = shard_sim.spawn(torch_spmd.plan, 2, ([
        ("spmd_laws", ((2, 1),)), ("spmd_laws", ((1, 2),))],))
    r4 = shard_sim.spawn(torch_spmd.spmd_laws, 4, ((2, 2),))
    runs = [x for res, _ in r2 for x in res] + r4
    for out in runs:
        assert all(out["roundtrip"])
        assert max(out["reduce_split"]) <= 1e-6
        assert all(out["reduce_replicated"])
        got, exp = out["norm"]
        assert abs(got - exp) <= 1e-6 * exp
        dy, dg, top = out["ep"]
        assert dy <= 1e-5 and dg <= 1e-6 * top
    assert all(not mods for _, mods in r2)
