"""The port's network modules against their JAX twins: the copied topology
functions, each function of ``network.py``, the switch power and its
accrual, the NETWORK_AWARE placement score, the engine's edge resolution
in the reference's order, and the initial network state.

Inputs are random flow tables and switch states made with numpy from a
seed and handed to both packages: ports in LPI, ACTIVE and OFF, sleeping
switches, flows in flight with latency budgets left, batches whose edges
repeat the same route, a nearly full flow table (slot exhaustion) and the
packet model (``comm_model=1``).  The reference's functions run jitted, as
its engine runs them (XLA contracts a multiply-add into an FMA there; the
port computes those fused).

Tolerances: discrete outputs exact; elementwise floats within one ulp;
the switch power and what accrues from it within rtol 1e-6 (a sum over a
switch's ports, taken in another order)."""
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import jobs as jjobs
from repro.core import network as jnet
from repro.core import power as jpower
from repro.core import scheduler as jsched
from repro.core import topology as jtopo
from repro.core import types as jtypes
from repro_torch.core import engine as tengine
from repro_torch.core import jobs as tjobs
from repro_torch.core import network as tnet
from repro_torch.core import power as tpower
from repro_torch.core import scheduler as tsched
from repro_torch.core import topology as ttopo
from repro_torch.core import types as ttypes
from repro_torch.core.types import SchedPolicy, SleepPolicy

from torch_kernel_inputs import edge_inputs, net_inputs
from torch_port_util import (check_leaf, check_obj, port_cfg,
                             random_twin_states, to_np)

F32, I32 = np.float32, np.int32

# --------------------------------------------------------------------------
# topology
# --------------------------------------------------------------------------

TOPOLOGY_CASES = [("star", (6,)), ("fat_tree", (4,)), ("fat_tree", (6,)),
                  ("flattened_butterfly", (4,)), ("bcube", (3,)),
                  ("camcube", (2, 3, 2))]


@pytest.mark.parametrize("name,args", TOPOLOGY_CASES)
def test_topology_copy_equals_original(name, args):
    a = getattr(jtopo, name)(*args)
    b = getattr(ttopo, name)(*args)
    for f in ("name", "n_servers", "n_switches", "n_ports",
              "ports_per_linecard", "n_links", "max_hops", "n_linecards"):
        assert getattr(b, f) == getattr(a, f), f
    for f in ("links", "link_cap", "link_port", "routes", "route_len",
              "route_sw"):
        x, y = getattr(b, f), getattr(a, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for rack in (2, 8):
        np.testing.assert_array_equal(ttopo.rack_of_servers(b, rack),
                                      jtopo.rack_of_servers(a, rack))


# --------------------------------------------------------------------------
# random flow tables and switch states, twinned
# --------------------------------------------------------------------------

TOPOS = {"star6": ("star", (6,)), "fat_tree4": ("fat_tree", (4,)),
         "bcube3": ("bcube", (3,)), "camcube": ("camcube", (2, 3, 2))}


def _topos(key):
    name, args = TOPOS[key]
    return getattr(jtopo, name)(*args), getattr(ttopo, name)(*args)


def _cfg(n_servers, **kw):
    base = dict(n_servers=n_servers, n_cores=2, max_jobs=16,
                tasks_per_job=2, max_children=2, max_flows=24,
                has_network=True)
    base.update(kw)
    return jtypes.SimConfig(**base)


def _twins(cls_j, cls_t, arrays):
    """A reference and a port dataclass from the same numpy leaves."""
    j = cls_j(**{k: jnp.asarray(v) for k, v in arrays.items()})
    t = cls_t(**{k: torch.from_numpy(np.array(v)) for k, v in
                 arrays.items()})
    return j, t


def random_net(topo, cfg, seed, t=1.0, n_active=None):
    """(jax flows, jax net, port flows, port net) at time t from
    ``torch_kernel_inputs.net_inputs``."""
    flows, net = net_inputs(topo, cfg.max_flows, cfg.n_tasks, seed, t,
                            n_active)
    jf, tf = _twins(jtypes.FlowTable, ttypes.FlowTable, flows)
    jn, tn = _twins(jtypes.NetState, ttypes.NetState, net)
    return jf, jn, tf, tn


_j_spawn = jax.jit(jnet.spawn_flows_many, static_argnames=("cfg",))
_j_rates = jax.jit(jnet.recompute_rates)
_j_advance = jax.jit(jnet.advance_flows)
_j_complete = jax.jit(jnet.complete_flows)
_j_switch = jax.jit(jnet.update_switch_states, static_argnames=("cfg",))
_j_power = jax.jit(jpower.switch_power, static_argnames=("cfg",))
_j_accrue = jax.jit(jpower.accrue_switch_energy, static_argnames=("cfg",))


@pytest.mark.parametrize("comm_model", [0, 1])
@pytest.mark.parametrize("n_active", [6, 20])
@pytest.mark.parametrize("key", list(TOPOS))
def test_spawn_flows_many_matches(key, n_active, comm_model):
    """n_active 20 of 24 slots leaves 4 free for about 17 needed edges:
    slot exhaustion."""
    ja, pa = _topos(key)
    cfg = _cfg(ja.n_servers, comm_model=comm_model)
    jf, jn, tf, tn = random_net(ja, cfg, 3, n_active=n_active)
    e = edge_inputs(ja.n_servers, cfg.n_tasks, 5)
    now = 1.0
    jout = _j_spawn(jf, jn, jnet.topo_consts(ja), cfg,
                    *[jnp.asarray(e[k]) for k in e], jnp.float32(now))
    tout = tnet.spawn_flows_many(
        tf, tn, tnet.topo_consts(pa, "cpu"), port_cfg(cfg),
        *[torch.from_numpy(e[k]) for k in e],
        torch.tensor(now, dtype=torch.float32))
    check_obj(tout[0], jout[0], "flows")
    check_obj(tout[1], jout[1], "net")
    check_leaf(tout[2], jout[2], "ok")
    ok = to_np(tout[2])
    if n_active == 20:
        assert e["need"].sum() > 4 and ok.sum() == 4
    else:
        assert (ok == e["need"]).all()
    # the batch paid a wake charge somewhere (LPI ports or sleeping
    # switches), except on the switchless torus
    assert (to_np(tout[0].extra) > 0).any() or key == "camcube" \
        or comm_model == 1


@pytest.mark.parametrize("key", list(TOPOS))
@pytest.mark.parametrize("seed", [0, 1])
def test_flow_dynamics_match(key, seed):
    """recompute_rates, advance_flows (a step inside and past the latency
    budgets) and complete_flows on the same random table."""
    ja, pa = _topos(key)
    cfg = _cfg(ja.n_servers)
    jf, _, tf, _ = random_net(ja, cfg, seed)
    jtc, ptc = jnet.topo_consts(ja), tnet.topo_consts(pa, "cpu")
    now = np.float32(1.0)
    jr, jl = _j_rates(jf, jtc, jnp.float32(now))
    tr, tl = tnet.recompute_rates(tf, ptc, torch.tensor(now))
    check_obj(tr, jr, "rates")
    check_leaf(tl, jl, "link_flows")
    for dt in (np.float32(3e-3), np.float32(0.05)):
        ja_ = _j_advance(jr, jnp.float32(dt))
        ta_ = tnet.advance_flows(tr, torch.tensor(dt))
        check_obj(ta_, ja_, f"advance {dt}")
        for t in (now + dt, now + np.float32(0.3)):
            jc, jfin = _j_complete(ja_, jnp.float32(t))
            tc, tfin = tnet.complete_flows(ta_, torch.tensor(np.float32(t)))
            check_obj(tc, jc, f"complete {t}")
            check_leaf(tfin, jfin, "fin")


@pytest.mark.parametrize("key", list(TOPOS))
@pytest.mark.parametrize("seed", [0, 1])
def test_switch_states_and_power_match(key, seed):
    ja, pa = _topos(key)
    cfg = _cfg(ja.n_servers)
    pcfg = port_cfg(cfg)
    _, jn, _, tn = random_net(ja, cfg, seed)
    lf = np.random.default_rng(seed + 9).integers(0, 3, ja.n_links) \
        .astype(I32)
    for t in (np.float32(1.0), np.float32(1.002)):
        jo = _j_switch(jn, jnp.asarray(lf), jnet.topo_consts(ja), cfg,
                       jnp.float32(t))
        to = tnet.update_switch_states(tn, torch.from_numpy(lf),
                                       tnet.topo_consts(pa, "cpu"), pcfg,
                                       torch.tensor(t))
        check_obj(to, jo, f"switch states at {t}")
    jp = _j_power(jn, cfg)
    tp = tpower.switch_power(tn, pcfg)
    assert tp.dtype == torch.float32
    np.testing.assert_allclose(to_np(tp), np.asarray(jp), rtol=1e-6)
    dt = np.float32(0.0137)
    ja_ = _j_accrue(jn, cfg, jnp.float32(dt))
    ta_ = tpower.accrue_switch_energy(tn, torch.tensor(dt), tp)
    np.testing.assert_allclose(to_np(ta_.sw_energy), np.asarray(ja_.sw_energy),
                               rtol=1e-6)
    check_leaf(ta_.port_residency, ja_.port_residency, "port_residency")
    farm = random_twin_states(_cfg(ja.n_servers, has_network=False), seed)
    for has_net in (True, False):
        c = dataclasses.replace(cfg, has_network=has_net)
        jt = jpower.total_power(farm[0].farm, jn, c)
        tt = tpower.total_power(farm[1].farm, tn, port_cfg(c))
        for a, b in zip(tt, jt):
            assert a.dtype == torch.float32 and a.shape == ()
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


# --------------------------------------------------------------------------
# NETWORK_AWARE placement
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["fat_tree4", "bcube3"])
@pytest.mark.parametrize("sleep", [SleepPolicy.SINGLE_TIMER,
                                   SleepPolicy.DUAL_TIMER])
def test_network_aware_cost_and_pick_match(key, sleep):
    ja, pa = _topos(key)
    cfg = _cfg(ja.n_servers, n_cores=2, local_q=6, max_jobs=24,
               tasks_per_job=1, sched_policy=SchedPolicy.NETWORK_AWARE,
               sleep_policy=sleep)
    pcfg = port_cfg(cfg)
    _, jn, _, tn = random_net(ja, cfg, 4)
    jtc, ptc = jnet.topo_consts(ja), tnet.topo_consts(pa, "cpu")
    jcost = jax.vmap(lambda d: jnet.route_wake_cost(jtc, jn, jnp.int32(0), d)
                     )(jnp.arange(cfg.n_servers))
    tcost = tnet.route_wake_cost(ptc, tn, 0, torch.arange(cfg.n_servers))
    check_leaf(tcost, jcost, "net_cost")
    assert to_np(tcost).max() > 0          # some route crosses a sleeper
    for seed in range(3):
        js, ps, _ = random_twin_states(
            dataclasses.replace(cfg, has_network=False), seed, n_jobs=20)
        extra = np.random.default_rng(seed).integers(0, 3, cfg.n_servers
                                                     ).astype(F32)
        for cost in ((jcost, tcost), (None, None)):
            jsrv, _ = jsched.pick_server(js.farm, cfg, js.sched, cost[0],
                                         None, jnp.asarray(extra))
            tsrv, _ = tsched.pick_server(ps.farm, pcfg, ps.sched,
                                         torch.from_numpy(extra),
                                         net_cost=cost[1])
            check_leaf(tsrv, jsrv, f"pick seed {seed}")


# --------------------------------------------------------------------------
# the engine's edge resolution and initial state
# --------------------------------------------------------------------------

def test_spawn_order_matches_reference_compaction():
    """32 task rows against 16 x 1 cores: the reference compacts the
    finishing tasks to 16 rows before it spawns; the port walks all 32.
    With 3 free flow slots for 7 needed edges and sleeping switches, the
    slot each edge takes, the edges refused and which edge pays each
    switch's wake charge all follow the order of the needed edges."""
    ja, pa = _topos("fat_tree4")
    cfg = _cfg(16, n_cores=1, max_jobs=8, tasks_per_job=4, max_flows=5)
    JT = cfg.n_tasks
    assert cfg.n_servers * cfg.n_cores < JT
    specs = [jjobs.dag_fanout(0.01, [0.02, 0.03], 0.01, edge_bytes=1e6)
             for _ in range(8)]
    jt = jjobs.build_jobs(cfg, np.linspace(0.1, 0.8, 8), specs)
    leaves = {f.name: np.asarray(getattr(jt, f.name))
              for f in dataclasses.fields(jt)}
    done = np.zeros(JT, bool)
    done[[4, 9, 10, 24, 28]] = True      # roots and leaves finishing
    server = (np.arange(JT) * 5 % 16).astype(I32)
    server[5] = server[4]                # one edge stays on its server
    leaves.update(server=server, arr_ptr=np.asarray(8, I32),
                  status=np.where(done, jtypes.TaskStatus.DONE,
                                  jtypes.TaskStatus.BLOCKED).astype(I32))
    jobs_j, jobs_t = _twins(jtypes.JobTable, ttypes.JobTable, leaves)
    _, jn, _, tn = random_net(ja, cfg, 6)
    jf, _, tf, _ = random_net(ja, cfg, 7, n_active=2)
    assert not bool(np.asarray(jn.sw_awake).all())
    resolve = jax.jit(jengine._resolve_done_edges, static_argnames=("cfg",))
    jj, jfl, jne = resolve(jobs_j, jf, jn, cfg, jnet.topo_consts(ja),
                           jnp.asarray(done), jnp.float32(1.0))
    tj, tfl, tne = tengine._resolve_edges(
        jobs_t, tf, tn, port_cfg(cfg),
        tengine.consts(port_cfg(cfg), "cpu", pa), torch.from_numpy(done),
        torch.tensor(1.0))
    check_obj(tj, jj, "jobs")
    check_obj(tfl, jfl, "flows")
    check_obj(tne, jne, "net")
    assert int(tfl.flows_dropped) - int(tf.flows_dropped) == 4
    assert bool(tfl.active.all())


def test_network_enums_match():
    for name in ("PortState", "LinecardState"):
        jc, tc = getattr(jtypes, name), getattr(ttypes, name)
        members = {k: v for k, v in vars(jc).items()
                   if k.isupper() and isinstance(v, int)}
        assert members == {k: v for k, v in vars(tc).items()
                           if k.isupper() and isinstance(v, int)}, name


@pytest.mark.parametrize("key", list(TOPOS))
def test_init_state_with_topology_matches(key):
    ja, pa = _topos(key)
    cfg = _cfg(ja.n_servers)
    arr = np.linspace(0.1, 1.0, 5)
    specs_j = [jjobs.dag_chain([0.01, 0.02], edge_bytes=1e6)] * 5
    specs_t = [tjobs.dag_chain([0.01, 0.02], edge_bytes=1e6)] * 5
    js, _ = jengine.init_state(cfg, jjobs.build_jobs(cfg, arr, specs_j), ja)
    ts, _ = tengine.init_state(port_cfg(cfg), tjobs.build_jobs(
        port_cfg(cfg), arr, specs_t, device="cpu"), pa)
    check_obj(ts.flows, js.flows, "flows", max_ulp=0)
    check_obj(ts.net, js.net, "net", max_ulp=0)
    with pytest.raises(ValueError, match="topo="):
        tengine.init_state(port_cfg(cfg), tjobs.build_jobs(
            port_cfg(cfg), arr, specs_t, device="cpu"))


def _f32_nearest(x: Fraction) -> np.float32:
    """The float32 nearest the exact rational ``x``, ties to even."""
    c = np.float32(float(x))
    cands = [np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.uint32)) & 1))


_U = 2.0 ** -23
# a - b*c lands 2^-70 below the float32 midpoint 1 + 2^-23 + 2^-24: the
# float64 difference rounds onto the midpoint and ties to the even 1 + 2^-22
_MID = (1 + _U, 1 + _U, -(1 - _U) * 2.0 ** -24)


@pytest.mark.parametrize("case", ["midpoint", "midpoint_negated", "random"])
def test_fused_updates_round_once(case):
    """_fms and _fma equal one rounding of the exact result, also where
    the float64 result sits on a float32 midpoint (double rounding would
    be one ulp off there)."""
    if case == "random":
        rng = np.random.default_rng(5)
        a, b, c = (rng.standard_normal(4096).astype(np.float32)
                   * np.float32(2.0) ** rng.integers(-30, 30, 4096)
                   for _ in range(3))
    else:
        sign = -1.0 if case == "midpoint_negated" else 1.0
        a, b, c = (np.array([sign * v], np.float32) for v in _MID)
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    fms = tnet._fms(ta, tb, tc, torch.float32).numpy()
    fma = tnet._fma(tb, tc, ta, torch.float32).numpy()
    exp_fms = np.array([_f32_nearest(Fraction(float(x)) - Fraction(float(y))
                                     * Fraction(float(z)))
                        for x, y, z in zip(a, b, c)], np.float32)
    exp_fma = np.array([_f32_nearest(Fraction(float(y)) * Fraction(float(z))
                                     + Fraction(float(x)))
                        for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(fms, exp_fms)
    np.testing.assert_array_equal(fma, exp_fma)
    if case != "random":
        # the operands do reach the double-rounding case
        twice = (a.astype(np.float64) - b.astype(np.float64)
                 * c.astype(np.float64)).astype(np.float32)
        assert twice[0] != exp_fms[0]
