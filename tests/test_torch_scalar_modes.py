"""The seed scalar hot loops (``SimConfig(use_vectorized_hot_loop=False)``)
through the port's other engine modes: THERMAL_AWARE placement with the
thermal subsystem, the float64 clock (network mode too, which has no JAX
counterpart: the reference raises there), a replica batch against
``jax.vmap`` of the reference's scalar step, and rack-sharded runs on two
CPU ranks against ``engine.run``.

Tolerances: port against JAX as the guardrails hold them (``TOL_LEAVES``
at rtol 1e-5, everything else exact); scalar against vectorized within
the reference's ``_final_states_equal`` (rtol/atol 1e-6, every leaf);
sharded against unsharded bit for bit."""
import dataclasses

import pytest
import torch

from repro.core import jobs as jjobs
from repro.core import montecarlo as jmc
from repro.core import topology as jtopo
from repro.core import types as jtypes
from repro.core.types import SimConfig
from repro_torch.convert import state_from_numpy
from repro_torch.core import engine as tengine
from repro_torch.core import jobs as tjobs
from repro_torch.core import montecarlo as tmc
from repro_torch.core import shard_sim
from repro_torch.core import topology as ttopo

import torch_spmd
from torch_kernel_inputs import mc_config, mc_scenario
from torch_port_util import (SCALAR, SCALAR_FARM_SCENARIOS,
                             SCALAR_NET_SCENARIOS, assert_bitwise,
                             assert_state_matches, close_leaves, jax_tree,
                             port_cfg, port_run, port_simulate,
                             thermal_scenario, thermal_three_way)


def test_scalar_thermal_aware_matches_jax_and_vectorized():
    """tests/test_thermal.py's THERMAL_AWARE scenario in scalar mode
    through both packages' farm.simulate (and the oracle, as the
    vectorized case is held), and against the port's vectorized run."""
    thermal_three_way("thermal_aware", **SCALAR)
    pcfg, arr, specs, tau, topo = thermal_scenario("thermal_aware", "port")
    _, vec = port_simulate(pcfg, arr, specs, topo=topo, tau=tau)
    _, sca = port_simulate(dataclasses.replace(pcfg, **SCALAR), arr, specs,
                           topo=topo, tau=tau)
    close_leaves(sca, vec, "thermal_aware")


@pytest.mark.parametrize("name", ["star_packet", "overflow_dag"])
def test_scalar_f64_clock_equals_vectorized(name):
    """On a float64 clock the scalar run equals the vectorized one; a
    flow's ``rem`` stays float32 and its ``extra`` follows the clock."""
    if name in SCALAR_NET_SCENARIOS:
        kw, arr, _, tau, _ = SCALAR_NET_SCENARIOS[name](jjobs, jtopo)
        _, _, specs, _, topo = SCALAR_NET_SCENARIOS[name](tjobs, ttopo)
    else:
        kw, arr, _, tau = SCALAR_FARM_SCENARIOS[name](jjobs)
        specs, topo = SCALAR_FARM_SCENARIOS[name](tjobs)[2], None
    pcfg = port_cfg(SimConfig(**kw), time_dtype=torch.float64)
    vec = port_run(pcfg, arr, specs, tau, topo=topo)
    sca = port_run(dataclasses.replace(pcfg, **SCALAR), arr, specs, tau,
                   topo=topo)
    assert bool(sca.done) and sca.t.dtype == torch.float64
    assert sca.flows.rem.dtype == torch.float32
    assert sca.flows.extra.dtype == torch.float64
    close_leaves(sca, vec, f"{name} f64")


@pytest.mark.parametrize("name", ["replicas_r3", "fat_tree_rr"])
def test_scalar_replica_batch_matches_vmap(name):
    """tests/test_montecarlo.py's R = 3 batch and its k=4 fat-tree
    ROUND_ROBIN batch (R = 2: the spawn loop on a replica axis) in scalar
    mode against jax.vmap of the reference's scalar step, leaf for leaf,
    and against the port's vectorized batch."""
    kw, nested, arrs, jspecs, taus, net = mc_scenario(name, jjobs)
    jcfg = dataclasses.replace(mc_config(jtypes, kw, nested), **SCALAR)
    jt = jtopo.fat_tree(4, link_cap=1.25e9) if net else None
    tt = ttopo.fat_tree(4, link_cap=1.25e9) if net else None
    sb, tc = jmc.batched_state(jcfg, arrs, jspecs, taus=taus, topo=jt)
    final = jax_tree(jmc.run_replicas(jcfg, sb, tc))
    pcfg = port_cfg(jcfg)
    start = state_from_numpy(jax_tree(sb), pcfg, device="cpu")
    assert start.t.shape == (arrs.shape[0],)
    out = tmc.run_replicas(pcfg, start, tengine.consts(pcfg, "cpu", tt))
    assert_state_matches(out, final, f"{name}: scalar batch vs vmap")
    vcfg = dataclasses.replace(pcfg, use_vectorized_hot_loop=True)
    vec = tmc.run_replicas(vcfg, start, tengine.consts(vcfg, "cpu", tt))
    close_leaves(out, vec, f"{name}: scalar vs vectorized batch")


def test_scalar_run_sharded_equals_engine_run():
    """Rack sharding in scalar mode on two ranks: the star (two racks,
    flows across them) and the SINGLE_TIMER farm; every rank's final
    state equals ``engine.run``'s bit for bit."""
    names = ("rr_star", "lb_sleep")
    results = shard_sim.spawn(torch_spmd.plan, 2, (
        [("sharded_runs", (names, "cpu", SCALAR))],))
    for name in names:
        cfg, state, tc = torch_spmd.shard_initial(name, cfg_kw=SCALAR)
        assert not cfg.use_vectorized_hot_loop
        ref = tengine.run(state, cfg, tc)
        assert bool(ref.done)
        for r, (res, mods) in enumerate(results):
            assert not mods, mods
            assert_bitwise(res[0][name][0], ref, f"{name} rank {r}")
