"""The port's replica sweeps (``repro_torch.core.montecarlo``) against the
reference's (``repro.core.montecarlo``, a jitted ``jax.vmap`` of its
engine on the CPU).

Each scenario is one of the reference's own replica batches: the five
non-slow cases of tests/test_montecarlo.py (the R = 3 batch, the tau
sweep -- here with taus of shape (R,) and (R, N) -- and the k = 4
fat-tree ROUND_ROBIN batch; the topology refusal, a mesh of 1 and the
fault-model helpers below; the 2-D mesh case is in
tests/test_torch_sharding.py), the two replica cases of tests/test_telemetry.py,
tests/test_thermal.py::test_replica_sweep_carries_thermal_stats, and
tests/test_trace.py's rich scenario at R = 2 with two arrival seeds and a
64-slot ring, so both rings wrap.  The port starts from the reference's
``batched_state`` carried across with ``convert`` (and its own
``batched_state`` must equal it leaf for leaf).

Tolerances: discrete leaves exact; TOL_LEAVES at rtol 1e-5; with
throttling armed, CLOCK_LEAVES at rtol 1e-5 too, as the thermal slice
holds them (torch_port_util); rings record for record
(``assert_ring_matches``); ``replica_stats`` key by key (counts exact,
floats rtol 1e-5).  Each port replica is also held against a solo port
run of the same inputs: discrete state exact, floats rtol 1e-5."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.core import jobs as jjobs
from repro.core import montecarlo as jmc
from repro.core import topology as jtopo
from repro.core import types as jtypes
from repro.core.types import SimConfig
from repro_torch.convert import state_from_numpy
from repro_torch.core import engine as tengine
from repro_torch.core import jobs as tjobs
from repro_torch.core import montecarlo as tmc
from repro_torch.core import topology as ttopo
from repro_torch.core import types as ttypes
from repro_torch.core.types import tree_leaves

from torch_kernel_inputs import MC_SCENARIOS, mc_config, mc_scenario
from torch_port_util import (CLOCK_LEAVES, RTOL, assert_bitwise,
                             assert_state_matches, jax_tree, port_cfg)


@pytest.fixture(scope="module")
def jax_runs():
    """name -> (scenario, the reference's initial and final trees, its
    replica_stats): each reference run once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            kw, nested, arrs, specs, taus, net = mc_scenario(name, jjobs)
            jcfg = mc_config(jtypes, kw, nested)
            topo = jtopo.fat_tree(4, link_cap=1.25e9) if net else None
            sb, tc = jmc.batched_state(jcfg, arrs, specs, taus=taus,
                                       topo=topo)
            out = jmc.run_replicas(jcfg, sb, tc)
            cache[name] = ((jcfg, arrs, taus, net), jax_tree(sb),
                           jax_tree(out), jmc.replica_stats(out, jcfg))
        return cache[name]
    return get


def _port_side(name, jax_runs):
    (jcfg, arrs, taus, net), init, final, stats = jax_runs(name)
    pcfg = port_cfg(jcfg)
    topo = ttopo.fat_tree(4, link_cap=1.25e9) if net else None
    tc = tengine.consts(pcfg, "cpu", topo)
    start = state_from_numpy(init, pcfg, device="cpu")
    return pcfg, topo, tc, start, (jcfg, arrs, taus, init, final, stats)


def _tol(cfg):
    return CLOCK_LEAVES if cfg.thermal.throttling else ()


@pytest.mark.parametrize("name", MC_SCENARIOS)
def test_replica_batch_matches_reference(name, jax_runs):
    """The port's batched_state equals the reference's; the port's
    run_replicas from it equals the reference's final batch leaf for leaf,
    rings included; replica_stats agree key by key."""
    pcfg, topo, tc, start, (jcfg, arrs, taus, init, final, jstats) = \
        _port_side(name, jax_runs)
    specs = mc_scenario(name, tjobs)[3]
    own, own_tc = tmc.batched_state(pcfg, arrs, specs, taus=taus,
                                    topo=topo, device="cpu")
    assert_state_matches(own, init, f"{name}: batched_state")
    out = tmc.run_replicas(pcfg, start, tc)
    assert_state_matches(out, final, f"{name}: final", tol=_tol(pcfg))
    stats = tmc.replica_stats(out, pcfg)
    assert set(stats) == set(jstats), name
    for key, exp in jstats.items():
        got = stats[key]
        assert np.shape(got) == np.shape(exp), f"{name}: {key} shape"
        if np.asarray(exp).dtype.kind == "f":
            np.testing.assert_allclose(got, exp, rtol=RTOL, atol=1e-6,
                                       err_msg=f"{name}: {key}")
        else:
            np.testing.assert_array_equal(got, exp, err_msg=f"{name}: {key}")
    if name == "telemetry_empty":
        assert (stats["finished"] == 0).all()
        assert np.isnan(stats["mean_latency"]).all()
        assert np.isnan(stats["p99_latency"]).all()
    if name == "traced_rich_cap64":
        assert (stats["trace_dropped"] > 0).all()      # both rings wrapped


@pytest.mark.parametrize("name", MC_SCENARIOS)
def test_each_replica_equals_a_solo_run(name, jax_runs):
    """Replica r of the batch == the port's solo run of replica r's
    inputs: discrete state exact (steps and events too, so a replica that
    finished early stayed frozen while the others ran), floats rtol 1e-5."""
    pcfg, topo, tc, start, _ = _port_side(name, jax_runs)
    out = tmc.run_replicas(pcfg, start, tc)
    for r in range(start.t.shape[0]):
        solo = tengine.run(tmc.replica_state(start, r), pcfg, tc)
        for (path, g), (_, s) in zip(tree_leaves(tmc.replica_state(out, r)),
                                     tree_leaves(solo)):
            ctx = f"{name}: replica {r} {path}"
            assert g.shape == s.shape and g.dtype == s.dtype, ctx
            if g.dtype.is_floating_point:
                np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=RTOL,
                                           atol=0, err_msg=ctx)
            else:
                np.testing.assert_array_equal(g.numpy(), s.numpy(),
                                              err_msg=ctx)


def test_batched_state_requires_topo_in_network_mode():
    cfg = port_cfg(SimConfig(n_servers=4, n_cores=1, max_jobs=8,
                             tasks_per_job=2, has_network=True))
    specs = [tjobs.dag_chain([0.01, 0.01], edge_bytes=1e6)] * 2
    with pytest.raises(ValueError, match="topo"):
        tmc.batched_state(cfg, np.zeros((1, 2)), specs, device="cpu")


def test_run_replicas_refuses_a_mesh_and_a_single_state(tmp_path):
    """A single state is refused.  A mesh, refused before rack sharding
    (Queue 1 item 10) was ported, now runs: on a mesh of 1 (a one-rank
    gloo group) the batch equals run_replicas without a mesh, whether the
    mesh axis is the rack axis (every replica on the rank) or a replica
    axis (one block of all R); a batch that does not split over the
    mesh is refused."""
    kw, nested, arrs, specs, _, _ = mc_scenario("replicas_r3", tjobs)
    cfg = mc_config(ttypes, kw, nested)
    sb, tc = tmc.batched_state(cfg, arrs, specs, device="cpu")
    exp = tmc.run_replicas(cfg, sb, tc)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        for axis in ("racks", "replicas"):
            mesh = init_device_mesh("cpu", (1,), mesh_dim_names=(axis,))
            assert_bitwise(tmc.run_replicas(cfg, sb, tc, mesh=mesh), exp,
                           f"mesh of 1 along {axis}")
        fake = SimpleNamespace(mesh_dim_names=("replicas",), size=lambda d: 2)
        with pytest.raises(ValueError, match="do not split"):
            tmc.run_replicas(cfg, sb, tc, mesh=fake)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="replica batch"):
        tmc.run_replicas(cfg, tmc.replica_state(sb, 0), tc)


def test_fault_model_helpers_equal_the_reference():
    for args in ((1000.0, 500.0, 100, 0), (50.0, 20.0, 7, 3)):
        np.testing.assert_array_equal(tmc.poisson_failure_times(*args),
                                      jmc.poisson_failure_times(*args))
    for args in ((3600.0, 50.0), (1e5, 12.5)):
        assert tmc.young_daly_interval(*args) == \
            jmc.young_daly_interval(*args)


def test_summarize_takes_a_replica_batch(jax_runs):
    """telemetry.summarize on a batch: every scalar becomes (R,), every
    series (R, W), each replica's equal to its solo summary."""
    from repro_torch.core import telemetry as ttelem
    pcfg, _, tc, start, _ = _port_side("telemetry_hist", jax_runs)
    out = tmc.run_replicas(pcfg, start, tc)
    both = ttelem.summarize(out, pcfg)
    R = start.t.shape[0]
    for r in range(R):
        one = ttelem.summarize(tmc.replica_state(out, r), pcfg)
        for f in dataclasses.fields(one):
            a, b = getattr(both, f.name), getattr(one, f.name)
            if f.name == "times":
                np.testing.assert_array_equal(a, b)
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a[r], b, err_msg=f.name)
            else:
                assert np.shape(a) == (R,), f.name
                np.testing.assert_equal(a[r], b, err_msg=f.name)

