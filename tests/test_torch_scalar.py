"""The seed scalar hot loops (``SimConfig(use_vectorized_hot_loop=False)``)
in the port: each scalar primitive against its JAX twin on random states
(masked, at the full-queue and full-table edges, at the int32 stamp
wrap), the batched primitives against sequential calls of the port's own
scalar ones, the scalar spawn's order against the reference's, and the
whole-simulation scenarios without a network in scalar mode against the
reference's scalar mode and the port's vectorized mode.  The FIFO stamps'
int32 wrap through both push paths (tests/test_seq_wrap.py).

Inputs are made with numpy from seeds and handed to both packages; the
reference's primitives run jitted, as its engine runs them.  Tolerances:
a primitive's discrete outputs exact, its floats within one ulp; whole
runs against JAX as the guardrails hold them (``TOL_LEAVES`` at rtol 1e-5,
everything else exact); scalar against vectorized within the reference's
``_final_states_equal`` (rtol/atol 1e-6, every leaf)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import jobs as jjobs
from repro.core import network as jnet
from repro.core import server as jserver
from repro.core import topology as jtopo
from repro.core import types as jtypes
from repro.core.types import SchedPolicy, SimConfig, SleepPolicy, SrvState
from repro_torch.core import engine as tengine
from repro_torch.core import jobs as tjobs
from repro_torch.core import network as tnet
from repro_torch.core import scheduler as tsched
from repro_torch.core import server as tserver
from repro_torch.core import topology as ttopo
from repro_torch.core import types as ttypes
from repro_torch.core.types import TaskStatus

from torch_kernel_inputs import edge_inputs, net_inputs
from torch_port_util import (SCALAR, SCALAR_FARM_SCENARIOS, assert_bitwise,
                             check_leaf, check_obj, port_cfg,
                             random_twin_states, scalar_three, to_np)

IMAX = np.iinfo(np.int32).max

# --------------------------------------------------------------------------
# the scalar primitives against their JAX twins
# --------------------------------------------------------------------------

_j_push = jax.jit(jserver.queue_push, static_argnames=("cfg",))
_j_wake = jax.jit(jserver.begin_wake, static_argnames=("cfg",))
_j_compact = jax.jit(jserver.compact_mask, static_argnames=("K",))
_j_spawn = jax.jit(jnet.spawn_flow, static_argnames=("cfg",))


def _farm_cases(seed):
    """(reference config, [(reference farm, port farm)] of three random
    mid-run states), servers in every power state."""
    jcfg = SimConfig(n_servers=6, n_cores=2, local_q=3, max_jobs=16,
                     tasks_per_job=1)
    farms = []
    for k in range(3):
        js, ps, _ = random_twin_states(jcfg, 10 * seed + k, n_jobs=12)
        farms.append((js.farm, ps.farm))
    return jcfg, farms


def _stack(objs):
    """A replica batch of port dataclasses (leaf by leaf)."""
    return type(objs[0])(**{f.name: torch.stack([getattr(o, f.name)
                                                 for o in objs])
                            for f in dataclasses.fields(objs[0])})


def _replica(obj, r):
    return type(obj)(**{f.name: getattr(obj, f.name)[r]
                        for f in dataclasses.fields(obj)})


@pytest.mark.parametrize("case", ["room", "full", "masked", "wrap"])
@pytest.mark.parametrize("seed", [0, 1])
def test_queue_push_matches_jax(seed, case):
    """One push a replica of a batch of three states: into a queue with
    room, into a full one (q_len and q_seq unchanged, dropped + 1), under
    a false mask (every leaf as it came in) and with q_seq at the int32
    maximum (the stamp wraps)."""
    jcfg, farms = _farm_cases(seed)
    rng = np.random.default_rng(seed)
    srv = rng.integers(0, jcfg.n_servers, 3).astype(np.int32)
    tid = rng.integers(0, 16, 3).astype(np.int32)
    mask = np.array([case != "masked", True, case != "masked"])
    exp, pfarms = [], []
    for r, (jf, pf) in enumerate(farms):
        q = np.asarray(jf.q_len).copy()
        q[srv[r]] = jcfg.local_q if case == "full" else min(
            q[srv[r]], jcfg.local_q - 1)
        seq = IMAX if case == "wrap" else int(jf.q_seq)
        jf = dataclasses.replace(jf, q_len=jnp.asarray(q),
                                 q_seq=jnp.asarray(seq, jnp.int32))
        pf = dataclasses.replace(pf, q_len=torch.from_numpy(q),
                                 q_seq=torch.tensor(seq, dtype=torch.int32))
        out = _j_push(jf, jcfg, jnp.int32(srv[r]), jnp.int32(tid[r]))
        exp.append(out if mask[r] else (jf,) + out[1:])
        pfarms.append(pf)
    pcfg = port_cfg(jcfg)
    got_f, got_ok, got_seq = tserver.queue_push(
        _stack(pfarms), pcfg, torch.from_numpy(srv), torch.from_numpy(tid),
        torch.from_numpy(mask))
    for r, (jf, jok, jseq) in enumerate(exp):
        check_obj(_replica(got_f, r), jf, f"{case} replica {r}")
        check_leaf(got_ok[r], jok, f"{case} ok {r}")
        check_leaf(got_seq[r], jseq, f"{case} seq {r}")
    if case == "full":
        assert not bool(got_ok.any())
    if case == "wrap":
        assert (to_np(got_f.q_seq)[mask] == np.iinfo(np.int32).min).all()
    if case == "masked":
        assert_bitwise(_replica(got_f, 0), pfarms[0], "masked push")


@pytest.mark.parametrize("mask_on", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_begin_wake_matches_jax(seed, mask_on):
    """Every server of three random farms in turn (sleeping, awake,
    waking, off): the wake starts only in a sleep state and only under
    the mask; f32 and f64 clocks."""
    jcfg, farms = _farm_cases(seed)
    pcfg = port_cfg(jcfg)
    pb = _stack([pf for _, pf in farms])
    now = np.float32(1.25)
    for s in range(jcfg.n_servers):
        srv = torch.full((3,), s, dtype=torch.int32)
        got = tserver.begin_wake(pb, pcfg, srv,
                                 torch.full((3,), float(now)),
                                 torch.full((3,), mask_on))
        for r, (jf, _) in enumerate(farms):
            exp = _j_wake(jf, jcfg, jnp.int32(s), jnp.float32(now)) \
                if mask_on else jf
            check_obj(_replica(got, r), exp, f"server {s} replica {r}")
    # the float64 clock: the wake time is now + latency in float64
    f64 = dataclasses.replace(pcfg, time_dtype=torch.float64)
    pf = _replica(pb, 0)
    state = pf.srv_state.clone()
    state[0] = SrvState.S3
    pf = dataclasses.replace(pf, srv_state=state,
                             srv_wake_at=pf.srv_wake_at.double())
    got = tserver.begin_wake(pf, f64, torch.tensor(0, dtype=torch.int32),
                             torch.tensor(0.1, dtype=torch.float64),
                             torch.tensor(mask_on))
    assert got.srv_wake_at.dtype == torch.float64
    exp = 0.1 + f64.server_power.t_wake_s3 if mask_on \
        else float(pf.srv_wake_at[0])
    assert float(got.srv_wake_at[0]) == exp
    assert int(got.srv_state[0]) == (SrvState.WAKING if mask_on
                                     else SrvState.S3)


@pytest.mark.parametrize("K", [1, 5, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_mask_matches_jax(seed, K):
    """Fewer set tasks than K, more, and none, on a batch of three."""
    rng = np.random.default_rng(seed)
    masks = rng.random((3, 32)) < np.array([[0.1], [0.5], [0.0]])
    tids, valid, covered = tserver.compact_mask(torch.from_numpy(masks), K)
    for r in range(3):
        jt, jv, jc = _j_compact(jnp.asarray(masks[r]), K)
        check_leaf(tids[r], jt, f"tids {r}")
        check_leaf(valid[r], jv, f"valid {r}")
        check_leaf(covered[r], jc, f"covered {r}")


TOPOS = {"star6": ("star", (6,)), "fat_tree4": ("fat_tree", (4,)),
         "bcube3": ("bcube", (3,))}


def _net_twins(key, seed, n_active, comm_model):
    name, args = TOPOS[key]
    ja, pa = getattr(jtopo, name)(*args), getattr(ttopo, name)(*args)
    jcfg = SimConfig(n_servers=ja.n_servers, n_cores=2, max_jobs=16,
                     tasks_per_job=2, max_children=2, max_flows=12,
                     has_network=True, comm_model=comm_model)
    flows, net = net_inputs(ja, jcfg.max_flows, jcfg.n_tasks, seed,
                            n_active=n_active)
    jf = jtypes.FlowTable(**{k: jnp.asarray(v) for k, v in flows.items()})
    jn = jtypes.NetState(**{k: jnp.asarray(v) for k, v in net.items()})
    tf = ttypes.FlowTable(**{k: torch.from_numpy(np.array(v))
                             for k, v in flows.items()})
    tn = ttypes.NetState(**{k: torch.from_numpy(np.array(v))
                            for k, v in net.items()})
    return (ja, jcfg, jf, jn), (pa, port_cfg(jcfg), tf, tn)


@pytest.mark.parametrize("comm_model", [0, 1])
@pytest.mark.parametrize("n_active", [5, 12])
@pytest.mark.parametrize("key", list(TOPOS))
def test_spawn_flow_matches_jax(key, n_active, comm_model):
    """Each edge of a batch, spawned alone against the same random table
    and switch state: the first free slot, the wake charges of LPI ports
    and a sleeping switch, the route's switches woken, the packet model's
    serialization; a full table (12 of 12 active) refuses every spawn,
    counts it, wakes the route all the same and leaves every slot as it
    was; a false mask leaves every leaf as it came in."""
    (ja, jcfg, jf, jn), (pa, pcfg, tf, tn) = _net_twins(key, 4, n_active,
                                                        comm_model)
    e = edge_inputs(ja.n_servers, jcfg.n_tasks, 6, E=8)
    jtc, ptc = jnet.topo_consts(ja), tnet.topo_consts(pa, "cpu")
    for i in range(8):
        args = [e[k][i] for k in ("src", "dst", "nbytes", "child")]
        if args[0] < 0 or args[1] < 0:
            continue
        targs = [torch.tensor(a) for a in args]
        for mask in (True, False):
            got = tnet.spawn_flow(tf, tn, ptc, pcfg, *targs,
                                  torch.tensor(1.0), torch.tensor(mask))
            if not mask:
                assert_bitwise(got[0], tf, f"edge {i} masked flows")
                assert_bitwise(got[1], tn, f"edge {i} masked net")
                continue
            exp = _j_spawn(jf, jn, jtc, jcfg, *[jnp.asarray(a)
                                                for a in args],
                           jnp.float32(1.0))
            check_obj(got[0], exp[0], f"edge {i} flows")
            check_obj(got[1], exp[1], f"edge {i} net")
            check_leaf(got[2], exp[2], f"edge {i} ok")
            assert bool(got[2]) == (n_active < jcfg.max_flows)


def test_resolve_edges_scalar_order_matches_jax():
    """tests/test_torch_network.py's compaction case in scalar mode: 32
    task rows against 16 x 1 cores, so the spawn loop walks the 16
    compacted rows' edges; with 3 free slots for 7 needed edges, which
    edge takes which slot, which are refused and which pays each switch's
    wake charge follow the reference's loop."""
    ja, pa = jtopo.fat_tree(4), ttopo.fat_tree(4)
    cfg = SimConfig(n_servers=16, n_cores=1, max_jobs=8, tasks_per_job=4,
                    max_children=2, max_flows=5, has_network=True, **SCALAR)
    JT = cfg.n_tasks
    specs = [jjobs.dag_fanout(0.01, [0.02, 0.03], 0.01, edge_bytes=1e6)
             for _ in range(8)]
    jt = jjobs.build_jobs(cfg, np.linspace(0.1, 0.8, 8), specs)
    leaves = {f.name: np.asarray(getattr(jt, f.name))
              for f in dataclasses.fields(jt)}
    done = np.zeros(JT, bool)
    done[[4, 9, 10, 24, 28]] = True
    server = (np.arange(JT) * 5 % 16).astype(np.int32)
    server[5] = server[4]
    leaves.update(server=server, arr_ptr=np.asarray(8, np.int32),
                  status=np.where(done, TaskStatus.DONE,
                                  TaskStatus.BLOCKED).astype(np.int32))
    jobs_j = jtypes.JobTable(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jobs_t = ttypes.JobTable(**{k: torch.from_numpy(np.array(v))
                                for k, v in leaves.items()})
    (_, _, _, jn), (_, _, _, tn) = _net_twins("fat_tree4", 6, None, 0)
    fl, _ = net_inputs(ja, cfg.max_flows, JT, 7, n_active=2)
    jf = jtypes.FlowTable(**{k: jnp.asarray(v) for k, v in fl.items()})
    tf = ttypes.FlowTable(**{k: torch.from_numpy(np.array(v))
                             for k, v in fl.items()})
    resolve = jax.jit(jengine._resolve_done_edges, static_argnames=("cfg",))
    jj, jfl, jne = resolve(jobs_j, jf, jn, cfg, jnet.topo_consts(ja),
                           jnp.asarray(done), jnp.float32(1.0))
    pcfg = port_cfg(cfg)
    tj, tfl, tne = tengine._resolve_edges(
        jobs_t, tf, tn, pcfg, tengine.consts(pcfg, "cpu", pa),
        torch.from_numpy(done), torch.tensor(1.0))
    check_obj(tj, jj, "jobs")
    check_obj(tfl, jfl, "flows")
    check_obj(tne, jne, "net")
    assert int(tfl.flows_dropped) - int(tf.flows_dropped) == 4


# --------------------------------------------------------------------------
# the batched primitives against sequential scalar calls (the port's own),
# mirroring tests/test_engine_vectorized.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_push_many_matches_sequential(seed):
    cfg = ttypes.SimConfig(n_servers=4, n_cores=2, local_q=3, max_jobs=16)
    rng = np.random.default_rng(seed)
    farm = ttypes.init_farm(cfg, "cpu")
    farm = dataclasses.replace(farm, q_len=torch.from_numpy(
        rng.integers(0, cfg.local_q + 1, cfg.n_servers).astype(np.int32)))
    K = 8
    tids = torch.from_numpy(rng.integers(0, 64, K).astype(np.int32))
    srvs = torch.from_numpy(rng.integers(0, cfg.n_servers, K)
                            .astype(np.int32))
    valid = torch.from_numpy(rng.random(K) < 0.8)
    f_seq, oks, seqs = farm, [], []
    for i in range(K):
        f_seq, ok, sq = tserver.queue_push(f_seq, cfg, srvs[i], tids[i],
                                           valid[i])
        oks.append(ok & valid[i])
        seqs.append(sq)
    f_bat, ok_bat, seq_bat = tserver.queue_push_many(farm, cfg, srvs, tids,
                                                     valid)
    assert_bitwise(f_bat, f_seq, "farm")
    assert torch.equal(ok_bat, torch.stack(oks))
    assert torch.equal(seq_bat[ok_bat], torch.stack(seqs)[ok_bat])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pick_servers_for_job_matches_sequential_rr(seed):
    cfg = ttypes.SimConfig(n_servers=5, n_cores=1, local_q=2, max_jobs=8,
                           tasks_per_job=6,
                           sched_policy=SchedPolicy.ROUND_ROBIN)
    rng = np.random.default_rng(seed)
    farm = dataclasses.replace(
        ttypes.init_farm(cfg, "cpu"),
        q_len=torch.from_numpy(rng.integers(0, cfg.local_q + 1, 5)
                               .astype(np.int32)),
        srv_enabled=torch.from_numpy(rng.random(5) < 0.7))
    sched = dataclasses.replace(
        ttypes.init_sched(cfg, "cpu"),
        rr_ptr=torch.tensor(int(rng.integers(0, 5)), dtype=torch.int32))
    valid = torch.from_numpy(rng.random(cfg.tasks_per_job) < 0.8)
    srvs, rr_new = tsched.pick_servers_for_job(farm, cfg, sched, valid)
    got, rr = [], sched
    for i in range(cfg.tasks_per_job):
        srv, nxt = tsched.pick_server(farm, cfg, rr)
        if bool(valid[i]):
            got.append(int(srv))
            rr = dataclasses.replace(rr, rr_ptr=nxt)
    assert srvs[valid].tolist() == got
    assert int(rr_new) == int(rr.rr_ptr)
    # the engine's scalar assignment loop gives the same picks
    s2, sched2 = tengine._assign_scalar(farm, cfg, sched, valid)
    assert torch.equal(s2[valid], srvs[valid])
    assert int(sched2.rr_ptr) == int(rr_new)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spawn_flows_many_matches_sequential(seed):
    """Ten edges for six slots (slot exhaustion) with sleeping switches:
    the batched spawn equals ten masked spawn_flow calls bit for bit."""
    topo = ttopo.fat_tree(4, link_cap=1.0e9)
    cfg = ttypes.SimConfig(n_servers=16, n_cores=2, max_flows=6,
                           has_network=True, max_jobs=8)
    tc = tnet.topo_consts(topo, "cpu")
    rng = np.random.default_rng(seed)
    E = 10
    need = torch.from_numpy(rng.random(E) < 0.7)
    src = torch.from_numpy(rng.integers(0, 16, E).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 16, E).astype(np.int32))
    nbytes = torch.from_numpy(rng.uniform(1e6, 1e8, E).astype(np.float32))
    child = torch.from_numpy(rng.integers(0, 16, E).astype(np.int32))
    now = torch.tensor(1.0)
    flows0 = ttypes.init_flows(cfg, "cpu")
    net0 = ttypes.init_net(topo.n_switches, topo.n_ports, topo.n_links,
                           topo.n_linecards, cfg, "cpu")
    net0 = dataclasses.replace(net0, sw_awake=torch.from_numpy(
        rng.random(topo.n_switches) < 0.5))
    f_seq, n_seq, oks = flows0, net0, []
    for i in range(E):
        f_seq, n_seq, ok = tnet.spawn_flow(f_seq, n_seq, tc, cfg, src[i],
                                           dst[i], nbytes[i], child[i], now,
                                           need[i])
        oks.append(ok)
    f_bat, n_bat, ok = tnet.spawn_flows_many(flows0, net0, tc, cfg, need,
                                             src, dst, nbytes, child, now)
    assert_bitwise(f_bat, f_seq, "flows")
    assert_bitwise(n_bat, n_seq, "net")
    assert torch.equal(ok, torch.stack(oks))
    assert int(ok.sum()) == min(int(need.sum()), cfg.max_flows)


# --------------------------------------------------------------------------
# whole simulations without a network: port scalar against JAX scalar and
# port vectorized (network, thermal, traced, replica and sharded runs:
# tests/test_torch_scalar_slice.py, tests/test_torch_scalar_modes.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SCALAR_FARM_SCENARIOS))
def test_scalar_runs_match_jax_and_vectorized(name):
    kw, arr, jspecs, tau = SCALAR_FARM_SCENARIOS[name](jjobs)
    tspecs = SCALAR_FARM_SCENARIOS[name](tjobs)[2]
    kw.setdefault("max_events", 50_000)
    fin = scalar_three(SimConfig(**kw), arr, jspecs, tspecs, tau, ctx=name)
    if "overflow" in name:
        assert int(fin.farm.dropped) > 0


# --------------------------------------------------------------------------
# FIFO stamps across the int32 wrap, through both push paths
# (tests/test_seq_wrap.py)
# --------------------------------------------------------------------------

def _wrapped_queue(cfg, n_tasks, scalar):
    """A farm whose q_seq sits 2 pushes before the wrap, with ``n_tasks``
    tasks pushed onto server 0 in id order, by one multi-push or by
    ``n_tasks`` scalar pushes."""
    farm = dataclasses.replace(ttypes.init_farm(cfg, "cpu"),
                               q_seq=torch.tensor(IMAX - 1,
                                                  dtype=torch.int32))
    jt = tjobs.build_jobs(cfg, np.zeros(n_tasks),
                          [tjobs.dag_single(1.0) for _ in range(n_tasks)],
                          device="cpu")
    zero = torch.zeros(n_tasks, dtype=torch.int32)
    tids = torch.arange(n_tasks, dtype=torch.int32)
    if scalar:
        oks, seqs = [], []
        for i in range(n_tasks):
            farm, ok, sq = tserver.queue_push(farm, cfg, zero[i], tids[i])
            oks.append(ok)
            seqs.append(sq)
        ok, seq = torch.stack(oks), torch.stack(seqs)
    else:
        farm, ok, seq = tserver.queue_push_many(
            farm, cfg, zero, tids, torch.ones(n_tasks, dtype=torch.bool))
    assert bool(ok.all())
    assert int(seq[0]) == IMAX - 1 and int(seq[-1]) < 0
    status = jt.status.clone()
    status[:n_tasks] = TaskStatus.QUEUED
    enq = jt.enqueue_seq.clone()
    enq[:n_tasks] = seq
    server = jt.server.clone()
    server[:n_tasks] = 0
    return farm, dataclasses.replace(jt, status=status, enqueue_seq=enq,
                                     server=server)


@pytest.mark.parametrize("scalar", [True, False])
@pytest.mark.parametrize("max_jobs", [16, 256])
def test_fifo_order_survives_seq_wrap(max_jobs, scalar):
    """One single-core server, four queued tasks whose stamps straddle
    the wrap: the first pushed task starts."""
    cfg = ttypes.SimConfig(n_servers=1, n_cores=1, local_q=8,
                           max_jobs=max_jobs, tasks_per_job=1,
                           sleep_policy=SleepPolicy.ALWAYS_ON)
    farm, jt = _wrapped_queue(cfg, 4, scalar)
    farm2, jt2 = tserver.try_start(farm, cfg, jt,
                                   torch.zeros((), dtype=cfg.time_dtype))
    status = jt2.status[:4].tolist()
    assert status[0] == TaskStatus.RUNNING
    assert all(s == TaskStatus.QUEUED for s in status[1:])
    assert int(farm2.q_len[0]) == 3


@pytest.mark.parametrize("scalar", [True, False])
def test_queued_rank_wrap_safe_direct(scalar):
    cfg = ttypes.SimConfig(n_servers=1, n_cores=4, local_q=8, max_jobs=16,
                           tasks_per_job=1,
                           sleep_policy=SleepPolicy.ALWAYS_ON)
    farm, jt = _wrapped_queue(cfg, 4, scalar)
    queued = jt.status == TaskStatus.QUEUED
    rank = tserver.queued_rank(jt, cfg, queued, farm.q_seq)
    assert rank[:4].tolist() == [0, 1, 2, 3]


def test_build_jobs_guards_int32_task_table():
    cfg = ttypes.SimConfig(max_jobs=2 ** 27, tasks_per_job=16)
    with pytest.raises(ValueError, match="overflows int32"):
        tjobs.build_jobs(cfg, np.empty(0), [], device="cpu")
