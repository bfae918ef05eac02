"""The port's rack-sharded engine (``repro_torch.core.shard_sim``) against
its own single-device engine and against the reference's.

The contract is the reference's (``src/repro/core/shard_sim.py``): a
sharded run on any number of ranks is bit-identical -- every state leaf,
the flight recorder's ring included -- to ``engine.run`` on one device,
because each macro-step gathers the rack blocks and runs the unmodified
step on the full arrays.  Here that is held exactly, port sharded
against port unsharded, on a mesh of 1 in this process (a one-rank gloo
group) and on 2, 4 and 8 CPU ranks (``tests/torch_spmd.py``: spawned
processes, gloo, no JAX imported in them).

Against JAX the reference's single-device ``engine.run`` is the oracle:
its own 8-device test cannot run on this JAX, and its sharded engine
equals its single-device one by construction.  The port is held to it
at its usual tolerances (``torch_port_util``): discrete state exactly,
TOL_LEAVES at rtol 1e-5, and with throttling armed CLOCK_LEAVES too.

Each rank counts the ``torch.distributed`` calls it makes: one
``all_gather`` per sharded leaf a macro-step, one more set for the final
state, and no other collective.  The recording of one sharded macro-step
(``shard_sim.sharded_step_graph``, the port's counterpart of the
reference's jaxpr audit) is a second witness of the same contract.  The fast tests mirror tests/test_sharding.py's: padding and
inert filler rows, provenance and digest, the mesh-of-1 identity with
the ring on, the spec rules and the layout refusals."""
import dataclasses
import types as pytypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import engine as jengine
from repro.core import farm as jfarm
from repro.core import jobs as jjobs
from repro.core import network as jnet
from repro.core import shard_sim as jshard
from repro.core import topology as jtopo
from repro.core import types as jtypes
from repro.sharding import partition as jpart
from repro_torch.core import engine as tengine
from repro_torch.core import farm as tfarm
from repro_torch.core import jobs as tjobs
from repro_torch.core import montecarlo as tmc
from repro_torch.core import shard_sim, traceio, workload
from repro_torch.core.types import (PartitionConfig, SchedPolicy, SimConfig,
                                    SrvState, ThermalConfig, TraceConfig,
                                    tree_leaves)
from repro_torch.analysis.graph_audit import (ALL_GATHER_OPS,
                                              COLLECTIVE_OPS, HOST_SYNC_OPS)
from repro_torch.sharding import partition

import torch_spmd
from torch_kernel_inputs import SHARD_SCENARIOS, shard_scenario
from torch_port_util import (CLOCK_LEAVES, assert_bitwise,
                             assert_results_equal, assert_state_matches,
                             jax_tree)

AXIS = partition.SIM_AXIS


@pytest.fixture
def mesh1(tmp_path):
    """A one-rank gloo group in this process and its 1-D "racks" mesh,
    destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield shard_sim.make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _workload(n_jobs=80, lam=60.0, seed=3):
    rng = np.random.default_rng(seed)
    arr = workload.poisson_arrivals(lam, n_jobs, seed=seed)
    specs = [tjobs.dag_single(rng.exponential(0.02)) for _ in range(n_jobs)]
    return arr, specs


def _built_state(cfg, arr, specs, topo=None, racks=None):
    jt = tjobs.build_jobs(cfg, np.asarray(arr), specs, device="cpu")
    return tengine.init_state(cfg, jt, topo, racks)


# ==========================================================================
# pad_to_racks + inert filler rows
# ==========================================================================

def test_pad_to_racks_rounds_up_to_shardable_blocks():
    cfg = SimConfig(n_servers=13, n_cores=2,
                    thermal=ThermalConfig(enabled=True, rack_size=3))
    p = tfarm.pad_to_racks(cfg, n_shards=4)
    assert p.n_servers == 24 and p.present == 13 and p.has_padding
    assert p.partition.n_shards == 4
    assert p.n_servers % (p.thermal.rack_size * 4) == 0
    assert tfarm.pad_to_racks(p) is p
    p2 = tfarm.pad_to_racks(SimConfig(n_servers=13, n_cores=2), n_shards=8)
    assert p2.n_servers == 16 and p2.present == 13
    cfg3 = SimConfig(n_servers=16, n_cores=2,
                     partition=PartitionConfig(n_shards=8))
    assert tfarm.pad_to_racks(cfg3) is cfg3


def test_padded_rows_boot_off_and_disabled():
    cfg = tfarm.pad_to_racks(SimConfig(n_servers=5, n_cores=2), n_shards=8)
    state, _ = _built_state(cfg, np.zeros(1), [tjobs.dag_single(0.01)])
    st = state.farm.srv_state.numpy()
    en = state.farm.srv_enabled.numpy()
    assert (st[:5] == SrvState.IDLE).all() and en[:5].all()
    assert (st[5:] == SrvState.OFF).all() and not en[5:].any()
    assert int(state.sched.n_enabled) == 5


def test_padded_farm_matches_unpadded_results(mesh1):
    """Filler rows are inert: the same jobs finish with the same
    latencies, no energy accrues on the pad; the padded farm run sharded
    on a mesh of 1 equals it run unsharded."""
    base = SimConfig(n_servers=5, n_cores=2, max_jobs=64, max_events=20_000,
                     sched_policy=SchedPolicy.LOAD_BALANCE)
    padded = tfarm.pad_to_racks(base, n_shards=8)
    pad = dataclasses.replace(padded, partition=PartitionConfig())
    arr, specs = _workload(n_jobs=50, lam=80.0)
    ra = tfarm.simulate(base, arr, specs, device="cpu")
    rb = tfarm.simulate(pad, arr, specs, device="cpu")
    assert rb.n_finished == ra.n_finished == 50
    np.testing.assert_allclose(rb.latencies, ra.latencies)
    assert np.isclose(rb.server_energy, ra.server_energy, rtol=1e-6)
    assert (rb.energy_per_server[5:] == 0.0).all()
    assert (rb.wake_count[5:] == 0).all()
    rc = tfarm.simulate(padded, arr, specs, device="cpu", mesh=mesh1)
    assert_results_equal(rc, rb, "padded, mesh of 1")


# ==========================================================================
# RunInfo provenance + digest
# ==========================================================================

def test_run_info_provenance_and_digest(mesh1):
    jcfg = jtypes.SimConfig(n_servers=4, n_cores=2, max_jobs=32,
                            max_events=5000)
    cfg = SimConfig(n_servers=4, n_cores=2, max_jobs=32, max_events=5000)
    arr, specs = _workload(n_jobs=10, lam=40.0)
    res = tfarm.simulate(cfg, arr, specs, device="cpu")
    ri = res.run_info
    assert ri.devices == 1 and ri.mesh_shape == () and ri.mesh_axes == ()
    assert ri.sharding == "" and len(ri.config_digest) == 40
    assert ri.config_digest == jfarm.config_digest(jcfg)
    c8 = dataclasses.replace(cfg, partition=PartitionConfig(n_shards=8))
    assert tfarm.config_digest(c8) == ri.config_digest
    assert tfarm.config_digest(dataclasses.replace(cfg, n_servers=8)) \
        != ri.config_digest
    sh = tfarm.simulate(cfg, arr, specs, device="cpu", mesh=mesh1)
    si = sh.run_info
    assert (si.devices, si.mesh_shape, si.mesh_axes, si.sharding) == \
        (1, (1,), (AXIS,), "P('racks',)")
    assert_results_equal(sh, res, "mesh of 1")


# ==========================================================================
# mesh-of-1 identity, spec rules, guards
# ==========================================================================

def test_mesh_of_one_is_bitwise_engine_run(mesh1):
    cfg = SimConfig(n_servers=8, n_cores=2, max_jobs=128, max_events=20_000,
                    trace=TraceConfig(enabled=True))
    arr, specs = _workload()
    state, tc = _built_state(cfg, arr, specs)
    ring = state.trace.buf.clone()
    ref = tengine.run(state, cfg, tc)
    out = shard_sim.run_sharded(state, cfg, tc, mesh1)
    assert_bitwise(out, ref, "mesh of 1")
    assert int(out.trace.ptr) > 0
    # the ring was copied, not written in the caller's state
    assert torch.equal(state.trace.buf, ring)


def test_sim_state_specs_mark_only_rack_major_axes(mesh1):
    """The port marks exactly the leaves the reference marks."""
    kw = dict(n_servers=8, n_cores=2, max_jobs=32, max_events=1000)
    cfg = SimConfig(**kw, thermal=ThermalConfig(enabled=True, rack_size=2))
    arr, specs = _workload(n_jobs=5)
    state, _ = _built_state(cfg, arr, specs)
    ps = partition.sim_state_specs(state, cfg, mesh1)
    sharded = {p for (p, _), sp in zip(tree_leaves(state), ps) if sp}
    assert "farm.srv_state" in sharded and "thermal.t_srv" in sharded
    assert "thermal.t_set" in sharded
    assert not any(p.split(".")[0] in ("jobs", "trace", "sched", "telem")
                   for p in sharded)
    assert all(sp in ((), (AXIS,)) for sp in ps)
    assert shard_sim.n_sharded_leaves(state, cfg, mesh1) == len(sharded) \
        == 19

    jcfg = jtypes.SimConfig(**kw, thermal=jtypes.ThermalConfig(
        enabled=True, rack_size=2))
    jt = jjobs.build_jobs(jcfg, np.asarray(arr),
                          [jjobs.dag_single(float(s.service[0]))
                           for s in specs])
    jstate, _ = jengine.init_state(jcfg, jt)
    jps = jpart.sim_state_specs(jstate, jcfg, jshard.make_mesh(1))
    lp, _ = jax.tree_util.tree_flatten_with_path(jstate)
    assert sharded == {jax.tree_util.keystr(p).lstrip(".")
                       for (p, _), sp in zip(lp, jps) if len(sp)}


@pytest.mark.parametrize("logical,shape", [
    (("server", None), (8, 4)), (("server",), (6,)), (("rack",), (3,)),
    (("server", "rack"), (8, 8)), (("heads", None), (8, 2)),
    ((None, "server"), (3, 8)), ((), ())])
def test_resolve_spec_matches_the_reference(logical, shape):
    """The divisibility fallback and the single-use rail, on a 4 x 2
    mesh, against the reference's resolve_spec."""
    names, sizes = ("racks", "model"), (4, 2)
    mesh = pytypes.SimpleNamespace(mesh_dim_names=names, shape=sizes)
    jmesh = pytypes.SimpleNamespace(axis_names=names,
                                    shape=dict(zip(names, sizes)))
    rules = dict(partition.sim_rules(), heads=("model",))
    got = partition.resolve_spec(logical, shape, mesh, rules)
    assert got == tuple(jpart.resolve_spec(logical, shape, jmesh, rules))


def test_validate_sharding_rejects_bad_layouts(mesh1):
    with pytest.raises(ValueError, match="divisible"):
        shard_sim.validate_sharding(SimConfig(n_servers=6, n_cores=2), 4)
    # uneven racks would need the general grouping, which the block
    # partition cannot cut: init_state refuses them, as the reference does
    cfg2 = SimConfig(n_servers=8, n_cores=2,
                     partition=PartitionConfig(n_shards=2),
                     thermal=ThermalConfig(enabled=True, rack_size=3))
    jt = tjobs.build_jobs(cfg2, np.zeros(1), [tjobs.dag_single(0.01)],
                          device="cpu")
    with pytest.raises(ValueError, match="pad_to_racks"):
        tengine.init_state(cfg2, jt)
    # an explicit grouping that is not contiguous, and racks that do not
    # split over the shards
    cfg3 = SimConfig(n_servers=8, n_cores=2,
                     thermal=ThermalConfig(enabled=True, rack_size=2))
    state, tc = _built_state(cfg3, np.zeros(1), [tjobs.dag_single(0.01)],
                             racks=np.arange(8) % 4)
    with pytest.raises(ValueError, match="contiguous"):
        shard_sim.validate_sharding(cfg3, 2, state)
    state, tc = _built_state(cfg3, np.zeros(1), [tjobs.dag_single(0.01)])
    with pytest.raises(ValueError, match="racks do not split"):
        shard_sim.validate_sharding(cfg3, 8, state)
    # a replica batch is montecarlo's, not run_sharded's
    sb, tc = tmc.batched_state(cfg3, np.zeros((2, 1)),
                               [tjobs.dag_single(0.01)], device="cpu")
    with pytest.raises(ValueError, match="replica batch"):
        shard_sim.run_sharded(sb, cfg3, tc, mesh1)
    # the recorded sharded macro-step keeps the reference's collective
    # contract: one all_gather per sharded leaf, no other collective and
    # no host sync inside the step
    inv = shard_sim.sharded_step_graph(state, cfg3, tc, mesh1)
    n = shard_sim.n_sharded_leaves(state, cfg3, mesh1)
    assert n == 19 and inv.count(ALL_GATHER_OPS) == n
    assert inv.count(COLLECTIVE_OPS) == n
    assert inv.count(HOST_SYNC_OPS) == 0


def test_n_present_validation():
    cfg = SimConfig(n_servers=4, n_cores=2, n_present=9)
    jt = tjobs.build_jobs(cfg, np.zeros(1), [tjobs.dag_single(0.01)],
                          device="cpu")
    with pytest.raises(ValueError, match="n_present"):
        tengine.init_state(cfg, jt)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        shard_sim.make_mesh(2, device="cpu")
    cfg = SimConfig(n_servers=4, n_cores=2, max_jobs=8,
                    partition=PartitionConfig(n_shards=2))
    with pytest.raises(ValueError, match="init_process_group"):
        tfarm.simulate(cfg, [0.1], [tjobs.dag_single(0.01)], device="cpu")


# ==========================================================================
# the four pinned configs on 1, 2, 4 and 8 ranks
# ==========================================================================

# one spawn per K, every step of it at once: each rank imports torch once
_R4 = dict(cfg=SimConfig(n_servers=8, n_cores=2, max_jobs=64,
                         max_events=20_000),
           arrs=np.stack([workload.poisson_arrivals(40.0, 30, seed=s)
                          for s in range(4)]),
           specs=[tjobs.dag_single(0.02) for _ in range(30)])
_SIM_CASE = (SimConfig(n_servers=8, n_cores=2, max_jobs=128,
                       max_events=20_000, trace=TraceConfig(enabled=True),
                       thermal=ThermalConfig(enabled=True, rack_size=2)),
             *_workload(), {"tau": 0.05})
_PLANS = {
    2: [("sharded_runs", (SHARD_SCENARIOS,)),
        ("simulate_runs", ([_SIM_CASE],))],
    4: [("sharded_runs", (SHARD_SCENARIOS,)),
        ("simulate_runs", ([_SIM_CASE],)),
        ("replica_runs", (_R4["cfg"], _R4["arrs"], _R4["specs"], (2, 2),
                          ("replicas", AXIS)))],
    8: [("sharded_runs", (("lb_sleep",),))],
}
CASES = [(n, k) for k in (1, 2, 4) for n in SHARD_SCENARIOS] + \
    [("lb_sleep", 8)]


@pytest.fixture(scope="module")
def spmd():
    """K -> every rank's (results of _PLANS[K], JAX modules imported)."""
    cache = {}

    def get(k):
        if k not in cache:
            cache[k] = shard_sim.spawn(torch_spmd.plan, k, (_PLANS[k],))
        return cache[k]
    return get


@pytest.fixture(scope="module")
def references():
    """name -> (the port's unsharded final state, JAX's final tree)."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, state, tc = torch_spmd.shard_initial(name)
            jcfg, arr, specs, topo, tau = shard_scenario(name, jjobs, jtopo,
                                                         jtypes)
            jt = jjobs.build_jobs(jcfg, np.asarray(arr), specs)
            jstate, _ = jengine.init_state(jcfg, jt, topo)
            if tau is not None:
                jstate = dataclasses.replace(jstate, farm=dataclasses.replace(
                    jstate.farm, srv_tau=jnp.full((jcfg.n_servers,), tau,
                                                  jcfg.time_dtype)))
            tc_j = jnet.topo_consts(topo) if topo is not None else None
            cache[name] = (tengine.run(state, cfg, tc),
                           jax_tree(jengine.run(jstate, jcfg, tc_j)))
        return cache[name]
    return get


@pytest.mark.parametrize("name,k", CASES)
def test_sharded_equals_unsharded_and_jax(name, k, spmd, references,
                                          tmp_path):
    """run_sharded on k ranks: every rank returns the port's unsharded
    final state bit for bit (the rings decode to the same records), the
    reference's within the port's tolerances, and each rank issued one
    gather per sharded leaf a macro-step (and one set for the final
    state), nothing else."""
    ref, jtree = references(name)
    cfg = torch_spmd.shard_initial(name)[0]
    if k == 1:
        dist.init_process_group("gloo",
                                init_method=f"file://{tmp_path}/store",
                                rank=0, world_size=1)
        try:
            ranks = [torch_spmd.sharded_runs(0, 1, (name,))]
        finally:
            dist.destroy_process_group()
    else:
        results = spmd(k)
        assert all(not mods for _, mods in results), results[0][1]
        ranks = [res[0] for res, _ in results]
    ev_ref, _ = traceio.decode(ref.trace, cfg)
    for r, by_name in enumerate(ranks):
        final, calls, n = by_name[name]
        ctx = f"{name} K={k} rank {r}"
        assert_bitwise(final, ref, ctx)
        ev, _ = traceio.decode(final.trace, cfg)
        assert traceio.diff_traces(ev_ref, ev) is None, ctx
        assert n == (19 if cfg.thermal.enabled else 12), ctx
        gathers = sum(calls.get(g, 0) for g in torch_spmd.GATHERS)
        assert gathers == n * (int(final.steps) + 1), (ctx, calls)
        assert sum(calls.values()) == gathers, (ctx, calls)
    assert int(ref.events) > 0 and bool(ref.done)
    tol = CLOCK_LEAVES if cfg.thermal.throttling else ()
    assert_state_matches(ranks[0][name][0], jtree, f"{name} K={k} vs JAX",
                         tol=tol)


@pytest.mark.parametrize("k", [2, 4])
def test_simulate_with_shards_equals_unsharded(k, spmd):
    """farm.simulate with partition.n_shards=k and with mesh=: the
    unsharded call's SimResult, run_info naming the k-rank mesh."""
    cfg, arr, specs, kw = _SIM_CASE
    exp = tfarm.simulate(cfg, arr, specs, device="cpu", **kw)
    assert exp.n_finished == len(specs)
    for r, (results, _) in enumerate(spmd(k)):
        (by_cfg, by_mesh), = results[1]
        for how, got in (("n_shards", by_cfg), ("mesh", by_mesh)):
            ri = got.run_info
            assert (ri.devices, ri.mesh_shape, ri.mesh_axes, ri.sharding) \
                == (k, (k,), (AXIS,), "P('racks',)"), (how, r)
            assert_results_equal(got, exp, f"simulate by {how}, K={k} "
                                           f"rank {r}")


def test_replicas_on_a_2d_mesh_equal_the_unmeshed_batch(spmd):
    """The reference's R = 4 batch on a (2, 2) ("replicas", "racks")
    mesh: two replicas a rank, each farm whole along "racks"; every rank
    returns run_replicas' batch without a mesh, leaf for leaf."""
    sb, tc = tmc.batched_state(_R4["cfg"], _R4["arrs"], _R4["specs"],
                               device="cpu")
    exp = tmc.run_replicas(_R4["cfg"], sb, tc)
    assert tmc.replica_stats(exp, _R4["cfg"])["finished"].tolist() == \
        [30] * 4
    for r, (results, _) in enumerate(spmd(4)):
        assert_bitwise(results[2], exp, f"(2, 2) mesh rank {r}")
