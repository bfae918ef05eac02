"""The port's engine modules on a replica batch: the random mid-run twin
states of ``torch_port_util.random_twin_states`` (and the random flow
tables and switch states of ``torch_kernel_inputs.net_inputs``), three
seeds stacked to R = 3, through ``jax.vmap`` of each reference function
(jitted, as its engine runs it) and through the port's function on the
batch, one function of each of ``power``, ``server``, ``scheduler``,
``telemetry``, ``network``, ``thermal`` and ``trace``.  The batch must
also equal the port's unbatched call replica by replica, so the two
paths are one.

Tolerances are the unbatched module tests': discrete outputs exact,
floats within one ulp (XLA may contract a multiply-add into an FMA), the
telemetry window vector rtol 1e-5 (a farm-wide power sum in another
order), the switch power rtol 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro.core import power as jpower
from repro.core import scheduler as jsched
from repro.core import server as jserver
from repro.core import telemetry as jtelem
from repro.core import thermal as jth
from repro.core import topology as jtopo
from repro.core import trace as jtrace
from repro.core import types as jtypes
from repro_torch.convert import state_from_numpy
from repro_torch.core import network as tnet
from repro_torch.core import power as tpower
from repro_torch.core import scheduler as tsched
from repro_torch.core import server as tserver
from repro_torch.core import telemetry as ttelem
from repro_torch.core import thermal as tth
from repro_torch.core import topology as ttopo
from repro_torch.core import trace as ttrace
from repro_torch.core import types as ttypes
from repro_torch.core.types import INF, SchedPolicy, SleepPolicy

from torch_kernel_inputs import net_inputs
from torch_port_util import (HOT, check_leaf, check_obj, port_cfg,
                             random_twin_states)

R = 3
SEEDS = (0, 1, 2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _stacked(jcfg, seeds=SEEDS, edit=None):
    """(reference batch, port batch, stacked numpy tree) of R twin states;
    ``edit(tree, seed)`` changes a replica's numpy leaves first."""
    trees = []
    for s in seeds:
        tree = random_twin_states(jcfg, s)[2]
        if edit is not None:
            edit(tree, s)
        trees.append(tree)
    tree = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    js0 = random_twin_states(jcfg, seeds[0])[0]
    jst = jax.tree_util.tree_map_with_path(
        lambda kp, v: jnp.asarray(
            tree[jax.tree_util.keystr(kp).lstrip(".")], v.dtype), js0)
    return jst, state_from_numpy(tree, port_cfg(jcfg), device="cpu"), tree


def _replica(obj, r):
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _replica(getattr(obj, f.name), r)
                            for f in dataclasses.fields(obj)})
    return obj[r] if isinstance(obj, torch.Tensor) else obj


def _same_as_unbatched(batched, one_of, ctx):
    """Replica r of a batched output == the unbatched call on replica r."""
    for r in range(R):
        got, exp = _replica(batched, r), one_of(r)
        if dataclasses.is_dataclass(exp):
            for f in dataclasses.fields(exp):
                assert torch.equal(getattr(got, f.name),
                                   getattr(exp, f.name)), f"{ctx}.{f.name}"
        else:
            assert torch.equal(got, exp), ctx


def _cfg(**kw):
    base = dict(n_servers=8, n_cores=2, local_q=6, max_jobs=40)
    base.update(kw)
    return jtypes.SimConfig(**base)


def test_power_on_a_batch():
    jcfg = _cfg(thermal=jtypes.ThermalConfig(throttle_power_scale=0.7))
    pcfg = port_cfg(jcfg)
    jst, pst, _ = _stacked(jcfg)
    thr = np.random.default_rng(5).random((R, jcfg.n_servers)) < 0.4
    jp = jax.jit(jax.vmap(lambda f, t: jpower.server_power(f, jcfg, t)))(
        jst.farm, jnp.asarray(thr))
    tp = tpower.server_power(pst.farm, pcfg, _t(thr))
    check_leaf(tp[0], jp[0], "power")
    check_leaf(tp[1], jp[1], "busy")
    dt = np.float32([0.0137, 0.2, 0.0])
    jf = jax.jit(jax.vmap(lambda f, d: jpower.accrue_server_energy(
        f, jcfg, d)))(jst.farm, jnp.asarray(dt))
    tf = tpower.accrue_server_energy(pst.farm, pcfg, _t(dt))
    check_obj(tf, jf, "accrue")
    _same_as_unbatched(tf, lambda r: tpower.accrue_server_energy(
        _replica(pst.farm, r), pcfg, _t(dt[r])), "accrue")


def test_server_on_a_batch():
    jcfg = _cfg()
    pcfg = port_cfg(jcfg)
    jst, pst, _ = _stacked(jcfg)
    rng = np.random.default_rng(7)
    now = np.float32([1.0, 1.25, 1.5])
    jfarm, jjobs = jax.jit(jax.vmap(lambda s, t: jserver.try_start(
        s.farm, jcfg, s.jobs, t)))(jst, jnp.asarray(now))
    tfarm, tjobs = tserver.try_start(pst.farm, pcfg, pst.jobs, _t(now))
    check_obj(tfarm, jfarm, "try_start.farm")
    check_obj(tjobs, jjobs, "try_start.jobs")
    _same_as_unbatched(tjobs, lambda r: tserver.try_start(
        _replica(pst.farm, r), pcfg, _replica(pst.jobs, r), _t(now[r]))[1],
        "try_start.jobs")
    K = 12
    srv = rng.integers(0, jcfg.n_servers, (R, K)).astype(np.int32)
    tids = np.stack([rng.permutation(jcfg.n_tasks)[:K]
                     for _ in range(R)]).astype(np.int32)
    valid = rng.random((R, K)) < 0.8
    jout = jax.jit(jax.vmap(lambda f, s, t, v: jserver.queue_push_many(
        f, jcfg, s, t, v)))(jst.farm, jnp.asarray(srv), jnp.asarray(tids),
                            jnp.asarray(valid))
    tout = tserver.queue_push_many(pst.farm, pcfg, _t(srv), _t(tids),
                                   _t(valid))
    check_obj(tout[0], jout[0], "push.farm")
    check_leaf(tout[1], jout[1], "push.ok")
    check_leaf(tout[2], jout[2], "push.seq")


@pytest.mark.parametrize("policy", [SchedPolicy.ROUND_ROBIN,
                                    SchedPolicy.LOAD_BALANCE,
                                    SchedPolicy.WASP_POOLS])
def test_scheduler_on_a_batch(policy):
    jcfg = _cfg(sched_policy=policy, sleep_policy=SleepPolicy.SINGLE_TIMER,
                local_q=3)
    pcfg = port_cfg(jcfg)
    jst, pst, _ = _stacked(jcfg)
    rng = np.random.default_rng(policy)
    extra = rng.integers(0, 3, (R, jcfg.n_servers)).astype(np.float32)
    jp = jax.jit(jax.vmap(lambda f, s, e: jsched.pick_server(
        f, jcfg, s, extra_load=e)))(jst.farm, jst.sched, jnp.asarray(extra))
    tp = tsched.pick_server(pst.farm, pcfg, pst.sched, _t(extra))
    check_leaf(tp[0], jp[0], "pick_server")
    check_leaf(tp[1], jp[1], "pick_server.rr")
    valid = rng.random((R, 11)) < 0.7
    jp = jax.jit(jax.vmap(lambda f, s, v: jsched.pick_servers_for_job(
        f, jcfg, s, v)))(jst.farm, jst.sched, jnp.asarray(valid))
    tp = tsched.pick_servers_for_job(pst.farm, pcfg, pst.sched, _t(valid))
    check_leaf(tp[0], jp[0], "pick_servers_for_job")
    check_leaf(tp[1], jp[1], "pick_servers_for_job.rr")
    check_leaf(tsched.next_timer_event(pst.farm, pcfg),
               jax.vmap(lambda f: jsched.next_timer_event(f, jcfg))(
                   jst.farm), "next_timer_event")


def test_telemetry_on_a_batch():
    jcfg = _cfg(tasks_per_job=2, telemetry=jtypes.TelemetryConfig(
        n_windows=16, window_dt=0.125))
    pcfg = port_cfg(jcfg)
    jst, pst, tree = _stacked(jcfg)
    dt = np.float32([0.0371, 0.5, 0.0])
    jw = jax.jit(jax.vmap(lambda s, d: jtelem.window_values(s, jcfg, d)))(
        jst, jnp.asarray(dt))
    tw = ttelem.window_values(pst, pcfg, _t(dt))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=0, err_msg="window_values")
    rng = np.random.default_rng(3)
    jf, tf = tree["jobs.job_finish"], tree["jobs.finish"]
    old_jf = np.where((jf < INF / 2) & (rng.random(jf.shape) < 0.6), INF,
                      jf).astype(np.float32)
    old_tf = np.where((tf < INF / 2) & (rng.random(tf.shape) < 0.6), INF,
                      tf).astype(np.float32)
    je = jax.jit(jax.vmap(lambda tl, jb, a, b: jtelem.accumulate_finishes(
        tl, jcfg, jb, a, b)))(jst.telem, jst.jobs, jnp.asarray(old_jf),
                              jnp.asarray(old_tf))
    te = ttelem.accumulate_finishes(pst.telem, pcfg, pst.jobs, _t(old_jf),
                                    _t(old_tf))
    check_obj(te, je, "accumulate_finishes")


def test_network_on_a_batch():
    ja, pa = jtopo.fat_tree(4), ttopo.fat_tree(4)
    jcfg = _cfg(n_servers=ja.n_servers, tasks_per_job=2, max_children=2,
                max_flows=24, has_network=True, max_jobs=16)
    pairs = [net_inputs(ja, jcfg.max_flows, jcfg.n_tasks, s) for s in SEEDS]
    flows = {k: np.stack([p[0][k] for p in pairs]) for k in pairs[0][0]}
    net = {k: np.stack([p[1][k] for p in pairs]) for k in pairs[0][1]}
    jf = jtypes.FlowTable(**{k: jnp.asarray(v) for k, v in flows.items()})
    tf = ttypes.FlowTable(**{k: _t(v) for k, v in flows.items()})
    jn = jtypes.NetState(**{k: jnp.asarray(v) for k, v in net.items()})
    tn = ttypes.NetState(**{k: _t(v) for k, v in net.items()})
    jtc, ptc = jnet.topo_consts(ja), tnet.topo_consts(pa, "cpu")
    now = np.float32([1.0, 1.1, 1.2])
    jr, jl = jax.jit(jax.vmap(lambda f, t: jnet.recompute_rates(
        f, jtc, t)))(jf, jnp.asarray(now))
    tr, tl = tnet.recompute_rates(tf, ptc, _t(now))
    check_obj(tr, jr, "rates")
    check_leaf(tl, jl, "link_flows")
    later = now + np.float32(0.05)
    jc, jfin = jax.jit(jax.vmap(jnet.complete_flows))(jr, jnp.asarray(later))
    tc, tfin = tnet.complete_flows(tr, _t(later))
    check_obj(tc, jc, "complete")
    check_leaf(tfin, jfin, "fin")
    js = jax.jit(jax.vmap(lambda n, lf, t: jnet.update_switch_states(
        n, lf, jtc, jcfg, t)))(jn, jl, jnp.asarray(now))
    ts = tnet.update_switch_states(tn, tl, ptc, port_cfg(jcfg), _t(now))
    check_obj(ts, js, "update_switch_states")
    _same_as_unbatched(ts, lambda r: tnet.update_switch_states(
        _replica(tn, r), tl[r], ptc, port_cfg(jcfg), _t(now[r])),
        "update_switch_states")


def test_thermal_on_a_batch():
    tkw = dict(HOT, t_throttle=50.0, t_release=45.0, throttle_freq=0.5,
               throttle_power_scale=0.6)
    jcfg = _cfg(thermal=jtypes.ThermalConfig(**tkw))
    pcfg = port_cfg(jcfg)

    def hot(tree, seed):
        rng = np.random.default_rng(seed + 100)
        tree["thermal.t_srv"] = rng.uniform(41.5, 53.5, 8).astype(np.float32)
        tree["thermal.throttled"] = rng.random(8) < 0.5
    jst, pst, _ = _stacked(jcfg, edit=hot)
    ef, ej, et = jax.jit(jax.vmap(lambda s: jth.apply_throttle(
        s.farm, s.jobs, s.thermal, jcfg, s.t)))(jst)
    farm, jobs, therm = tth.apply_throttle(pst.farm, pst.jobs, pst.thermal,
                                           pcfg, pst.t)
    assert bool((therm.throttled != pst.thermal.throttled).any())
    check_leaf(therm.throttled, et.throttled, "throttled")
    check_leaf(farm.core_busy_until, ef.core_busy_until, "core_busy_until",
               0.0)
    check_leaf(jobs.task_end, ej.task_end, "task_end", 0.0)
    check_leaf(tth.next_crossing(pst, pcfg),
               jax.jit(jax.vmap(lambda s: jth.next_crossing(s, jcfg)))(jst),
               "next_crossing")
    _same_as_unbatched(tth.next_crossing(pst, pcfg),
                       lambda r: tth.next_crossing(_replica(pst, r), pcfg),
                       "next_crossing")


def test_trace_flush_on_a_batch():
    """Three passes of staged records into three 16-slot rings, each
    replica with its own masks, payloads, clock and starting pointer (the
    rings wrap): the port's one batched flush a pass against jax.vmap of
    the reference's."""
    cap, sizes = 16, (5, 7, 1)
    rng = np.random.default_rng(11)
    jcfg = jtypes.SimConfig(trace=jtypes.TraceConfig(enabled=True,
                                                     capacity=cap))
    pcfg = port_cfg(jcfg)
    buf = rng.uniform(0, 9, (R, cap, 5)).astype(np.float32)
    ptr = np.int32([3, 14, 40])
    dropped = np.int32([0, 0, 24])
    jtr = jtypes.TraceState(buf=jnp.asarray(buf), ptr=jnp.asarray(ptr),
                            dropped=jnp.asarray(dropped))
    ttr = ttrace.own(ttypes.TraceState(buf=_t(buf), ptr=_t(ptr),
                                       dropped=_t(dropped)), pcfg)
    for _ in range(3):
        masks = [rng.random((R, m)) < 0.6 for m in sizes]
        srv = rng.integers(-1, 8, (R, sizes[0])).astype(np.int32)
        aux = rng.uniform(0, 2, (R, sizes[1])).astype(np.float32)
        t = rng.uniform(0, 10, R).astype(np.float32)

        def jflush(tr, m0, m1, m2, s, a, tt):
            recs = []
            jtrace.stage(recs, m0, 3, s, jnp.arange(sizes[0],
                                                    dtype=jnp.int32))
            jtrace.stage(recs, m1, 4, -1, None, a)
            jtrace.stage1(recs, m2[0], 12)
            return jtrace.flush(tr, jcfg, tt, recs)
        jtr = jax.jit(jax.vmap(jflush))(jtr, *map(jnp.asarray, masks),
                                        jnp.asarray(srv), jnp.asarray(aux),
                                        jnp.asarray(t))
        recs = []
        ttrace.stage(recs, _t(masks[0]), 3, _t(srv),
                     torch.arange(sizes[0], dtype=torch.int32))
        ttrace.stage(recs, _t(masks[1]), 4, -1, None, _t(aux))
        ttrace.stage1(recs, _t(masks[2][:, 0]), 12)
        ttr = ttrace.flush(ttr, pcfg, _t(t), recs)
    np.testing.assert_array_equal(ttr.buf.numpy(), np.asarray(jtr.buf))
    np.testing.assert_array_equal(ttr.ptr.numpy(), np.asarray(jtr.ptr))
    np.testing.assert_array_equal(ttr.dropped.numpy(),
                                  np.asarray(jtr.dropped))
