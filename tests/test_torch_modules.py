"""The port's modules against their JAX twins: configuration mirrors and
digests, the copied workload generators, job tables, initial state, and
each function of ``power``, ``server``, ``scheduler`` and ``telemetry`` on
random mid-run states built once with numpy and handed to both packages
(``torch_port_util.random_twin_states``).

Tolerances: discrete outputs exact; floats within one ulp (XLA may
contract a multiply-add into an FMA), except the telemetry window vector,
whose farm-wide power sum is a float reduction taken in another order:
rtol 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import farm as jfarm
from repro.core import jobs as jjobs
from repro.core import power as jpower
from repro.core import scheduler as jsched
from repro.core import server as jserver
from repro.core import telemetry as jtelem
from repro.core import types as jtypes
from repro.core import workload as jworkload
from repro_torch.core import engine as tengine
from repro_torch.core import farm as tfarm
from repro_torch.core import jobs as tjobs
from repro_torch.core import power as tpower
from repro_torch.core import scheduler as tsched
from repro_torch.core import server as tserver
from repro_torch.core import telemetry as ttelem
from repro_torch.core import types as ttypes
from repro_torch.core import workload as tworkload
from repro_torch.core.types import INF, SchedPolicy, SleepPolicy, SrvState

from torch_port_util import (check_leaf, check_obj, port_cfg,
                             random_twin_states, to_np)

# --------------------------------------------------------------------------
# configuration, workload, job tables
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "ServerPowerProfile", "SwitchPowerProfile", "ThermalConfig",
    "TelemetryConfig", "TraceConfig", "PartitionConfig", "SimConfig"])
def test_config_mirrors_reference_field_for_field(name):
    """Names, order and defaults; time_dtype maps jnp -> torch."""
    jf = dataclasses.fields(getattr(jtypes, name))
    tf = dataclasses.fields(getattr(ttypes, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    jd, td = getattr(jtypes, name)(), getattr(ttypes, name)()
    for f in jf:
        jv, tv = getattr(jd, f.name), getattr(td, f.name)
        if f.name == "time_dtype":
            assert jv == jnp.float32 and tv == torch.float32
        elif dataclasses.is_dataclass(jv):
            assert jfarm._config_dict(jv) == tfarm._config_dict(tv)
        else:
            assert tv == jv, f"{name}.{f.name}"


@pytest.mark.parametrize("kw", [
    {},
    dict(n_servers=6, n_cores=2, sched_policy=SchedPolicy.ROUND_ROBIN,
         sleep_policy=SleepPolicy.DUAL_TIMER, events_per_step=4),
    dict(tasks_per_job=3, telemetry=jtypes.TelemetryConfig(
        enabled=False, n_bins=32), use_kernel=True),
    dict(time_dtype=jnp.float64, thermal=jtypes.ThermalConfig(
        t_setpoint=(20.0, 22.0))),
])
def test_config_roundtrip_and_digest(kw):
    """config_from_dict rebuilds the port config from the reference's dump,
    which dumps back identically, so the scenario digests agree."""
    jcfg = jtypes.SimConfig(**kw)
    pcfg = port_cfg(jcfg)
    assert tfarm._config_dict(pcfg) == jfarm._config_dict(jcfg)
    assert tfarm.config_digest(pcfg) == jfarm.config_digest(jcfg)
    padded = jfarm.pad_to_racks(jcfg, n_shards=4)
    assert tfarm._config_dict(tfarm.pad_to_racks(pcfg, n_shards=4)) == \
        jfarm._config_dict(padded)


def test_workload_copy_is_bit_identical():
    cases = [
        ("poisson_arrivals", (120.0, 500), dict(seed=3, t0=0.5)),
        ("mmpp2_arrivals", (200.0, 20.0, 2.0, 1.0, 700), dict(seed=4)),
        ("wiki_like_trace", (600, 50.0), dict(period=30.0, seed=5)),
        ("trace_arrivals", ([3.0, 1.0, 2.0, 5.0], 3), dict(rate_scale=2.0)),
    ]
    for fn, args, kw in cases:
        np.testing.assert_array_equal(getattr(tworkload, fn)(*args, **kw),
                                      getattr(jworkload, fn)(*args, **kw),
                                      err_msg=fn)
    assert tworkload.utilization_to_rate(0.5, 0.01, 64, 4) == \
        jworkload.utilization_to_rate(0.5, 0.01, 64, 4)


def _specs(mod, T, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        kind = j % 4 if T >= 4 else j % 2
        if kind == 0:
            out.append(mod.dag_single(rng.exponential(0.02),
                                      sla=float(rng.uniform(0.01, 0.1))))
        elif kind == 1:
            out.append(mod.dag_chain(rng.exponential(0.01, size=T),
                                     edge_bytes=100.0))
        elif kind == 2:
            out.append(mod.dag_fanout(0.01, rng.exponential(0.01, size=T - 2),
                                      0.02))
        else:
            out.append(mod.dag_random(T, 0.01, 0.5, 10.0,
                                      np.random.default_rng(seed + j)))
    return out


@pytest.mark.parametrize("T", [1, 2, 4])
def test_build_jobs_and_init_state_match(T):
    jcfg = jtypes.SimConfig(n_servers=8, n_cores=2, max_jobs=40,
                            tasks_per_job=T, n_present=6)
    arr = jworkload.poisson_arrivals(30.0, 33, seed=T)
    jt = jjobs.build_jobs(jcfg, arr, _specs(jjobs, T, 33, 5))
    tt = tjobs.build_jobs(port_cfg(jcfg), arr, _specs(tjobs, T, 33, 5),
                          device="cpu")
    check_obj(tt, jt, "jobs", max_ulp=0)
    jst, _ = jengine.init_state(jcfg, jt)
    tst, _ = tengine.init_state(port_cfg(jcfg), tt)
    for name in ("farm", "jobs", "sched", "telem"):
        check_obj(getattr(tst, name), getattr(jst, name), name, max_ulp=0)
    for name in ("t", "events", "steps", "done"):
        check_leaf(getattr(tst, name), getattr(jst, name), name, max_ulp=0)


# --------------------------------------------------------------------------
# power and server
# --------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(n_servers=8, n_cores=4, local_q=6, max_jobs=48,
                tasks_per_job=1, sleep_policy=SleepPolicy.SINGLE_TIMER)
    base.update(kw)
    return jtypes.SimConfig(**base)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_power_matches(seed):
    jcfg = _cfg(thermal=jtypes.ThermalConfig(throttle_power_scale=0.7))
    js, ps, _ = random_twin_states(jcfg, seed)
    pcfg = port_cfg(jcfg)
    thr = np.random.default_rng(seed).random(jcfg.n_servers) < 0.4
    for t in (None, thr):
        jp = jpower.server_power(js.farm, jcfg,
                                 None if t is None else jnp.asarray(t))
        tp = tpower.server_power(ps.farm, pcfg, None if t is None else _t(t))
        check_leaf(tp[0], jp[0], "power")
        check_leaf(tp[1], jp[1], "busy")
    dt = jnp.float32(0.0137)
    jf = jpower.accrue_server_energy(js.farm, jcfg, dt)
    tf = tpower.accrue_server_energy(ps.farm, pcfg, _t(np.float32(0.0137)))
    check_obj(tf, jf, "accrue")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_server_functions_match(seed):
    jcfg = _cfg()
    pcfg = port_cfg(jcfg)
    js, ps, _ = random_twin_states(jcfg, seed)
    rng = np.random.default_rng(100 + seed)
    N = jcfg.n_servers
    now = np.float32(1.0)

    # multi-push: repeated destinations, invalid slots, queues filling up
    K = 12
    srv = rng.integers(0, N, K).astype(np.int32)
    tids = rng.permutation(jcfg.n_tasks)[:K].astype(np.int32)
    valid = rng.random(K) < 0.8
    jout = jserver.queue_push_many(js.farm, jcfg, jnp.asarray(srv),
                                   jnp.asarray(tids), jnp.asarray(valid))
    tout = tserver.queue_push_many(ps.farm, pcfg, _t(srv), _t(tids),
                                   _t(valid))
    check_obj(tout[0], jout[0], "push.farm")
    check_leaf(tout[1], jout[1], "push.ok")
    check_leaf(tout[2], jout[2], "push.seq")

    st = ps.farm.srv_state
    check_leaf(tserver.wake_latency(pcfg, st),
               jserver.wake_latency(jcfg, js.farm.srv_state), "wake_latency")
    mask = rng.random(N) < 0.6
    check_obj(tserver.begin_wake_mask(ps.farm, pcfg, _t(mask), _t(now)),
              jserver.begin_wake_mask(js.farm, jcfg, jnp.asarray(mask),
                                      jnp.float32(now)), "begin_wake")

    queued = js.jobs.status == jtypes.TaskStatus.QUEUED
    jr = np.asarray(jserver.queued_rank(js.jobs, jcfg, queued,
                                        js.farm.q_seq))
    tr = tserver.queued_rank(ps.jobs, pcfg, _t(np.asarray(queued)),
                             ps.farm.q_seq).numpy()
    q = np.asarray(queued)
    np.testing.assert_array_equal(tr[q], jr[q])       # garbage elsewhere

    jfarm_, jjobs_ = jserver.try_start(js.farm, jcfg, js.jobs,
                                       jnp.float32(now))
    tfarm_, tjobs_ = tserver.try_start(ps.farm, pcfg, ps.jobs, _t(now))
    check_obj(tfarm_, jfarm_, "try_start.farm")
    check_obj(tjobs_, jjobs_, "try_start.jobs")
    freq = rng.uniform(0.5, 1.0, N).astype(np.float32)
    jfarm_, jjobs_ = jserver.try_start(js.farm, jcfg, js.jobs,
                                       jnp.float32(now), jnp.asarray(freq))
    tfarm_, tjobs_ = tserver.try_start(ps.farm, pcfg, ps.jobs, _t(now),
                                       _t(freq))
    check_obj(tfarm_, jfarm_, "try_start(freq).farm")
    check_obj(tjobs_, jjobs_, "try_start(freq).jobs")

    check_obj(tserver.refresh_idle_state(ps.farm, pcfg, _t(now)),
              jserver.refresh_idle_state(js.farm, jcfg, jnp.float32(now)),
              "refresh_idle_state")


# --------------------------------------------------------------------------
# scheduler
# --------------------------------------------------------------------------

SCHED_CASES = [(p, s) for p in (SchedPolicy.ROUND_ROBIN,
                                SchedPolicy.LOAD_BALANCE,
                                SchedPolicy.PROVISIONED,
                                SchedPolicy.WASP_POOLS)
               for s in (SleepPolicy.ALWAYS_ON, SleepPolicy.SINGLE_TIMER,
                         SleepPolicy.DUAL_TIMER, SleepPolicy.WASP)]


@pytest.mark.parametrize("policy,sleep", SCHED_CASES)
def test_scheduler_functions_match(policy, sleep):
    jcfg = _cfg(sched_policy=policy, sleep_policy=sleep, local_q=3,
                prov_lo=0.4, prov_hi=0.6, wasp_t_wakeup=0.5,
                wasp_t_sleep=2.0)
    pcfg = port_cfg(jcfg)
    seed = 10 * policy + sleep
    js, ps, _ = random_twin_states(jcfg, seed)
    rng = np.random.default_rng(seed)
    N = jcfg.n_servers
    check_leaf(tsched.server_load(ps.farm, pcfg),
               jsched.server_load(js.farm, jcfg), "server_load")

    extra = rng.integers(0, 3, N).astype(np.float32)
    jp = jsched.pick_server(js.farm, jcfg, js.sched,
                            extra_load=jnp.asarray(extra))
    tp = tsched.pick_server(ps.farm, pcfg, ps.sched, _t(extra))
    check_leaf(tp[0], jp[0], "pick_server")
    check_leaf(tp[1], jp[1], "pick_server.rr")
    valid = rng.random(11) < 0.7
    jp = jsched.pick_servers_for_job(js.farm, jcfg, js.sched,
                                     jnp.asarray(valid))
    tp = tsched.pick_servers_for_job(ps.farm, pcfg, ps.sched, _t(valid))
    check_leaf(tp[0], jp[0], "pick_servers_for_job")
    check_leaf(tp[1], jp[1], "pick_servers_for_job.rr")

    for active in (0, 5, 40):
        jf, jsc = jsched.provisioning_adjust(js.farm, jcfg, js.sched,
                                             jnp.int32(active))
        tf, tsc = tsched.provisioning_adjust(ps.farm, pcfg, ps.sched,
                                             _t(np.int32(active)))
        check_obj(tf, jf, f"provisioning_adjust({active}).farm")
        check_obj(tsc, jsc, f"provisioning_adjust({active}).sched")
        check_obj(tsched.wasp_adjust(ps.farm, pcfg, _t(np.int32(active)),
                                     _t(np.float32(1.0))),
                  jsched.wasp_adjust(js.farm, jcfg, jnp.int32(active),
                                     jnp.float32(1.0)),
                  f"wasp_adjust({active})")
    for now in (1.0, 1.5, 3.0):
        check_obj(tsched.timer_transitions(ps.farm, pcfg,
                                           _t(np.float32(now))),
                  jsched.timer_transitions(js.farm, jcfg, jnp.float32(now)),
                  f"timer_transitions({now})")
    check_leaf(tsched.next_timer_event(ps.farm, pcfg),
               jsched.next_timer_event(js.farm, jcfg), "next_timer_event")


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,T,n_present", [(0, 1, 0), (1, 3, 0),
                                              (2, 1, 6)])
def test_telemetry_functions_match(seed, T, n_present):
    jcfg = _cfg(tasks_per_job=T, max_jobs=40, n_present=n_present,
                telemetry=jtypes.TelemetryConfig(n_windows=16,
                                                 window_dt=0.125))
    pcfg = port_cfg(jcfg)
    js, ps, tree = random_twin_states(jcfg, seed)
    rng = np.random.default_rng(seed)

    dt = np.float32(0.0371)
    jw = jtelem.window_values(js, jcfg, jnp.float32(dt))
    tw = ttelem.window_values(ps, pcfg, _t(dt))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=0, err_msg="window_values")
    for t, d in ((0.0, 0.01), (1.03, 0.2), (1.9, 0.3), (5.0, 1.0)):
        t32, d32 = np.float32(t), np.float32(d)
        check_leaf(ttelem.window_index(_t(t32), _t(d32), pcfg.telemetry),
                   jtelem.window_index(jnp.float32(t32), jnp.float32(d32),
                                       jcfg.telemetry), f"window_index {t}")
        check_leaf(ttelem.window_spill(_t(t32), _t(d32), pcfg.telemetry),
                   jtelem.window_spill(jnp.float32(t32), jnp.float32(d32),
                                       jcfg.telemetry), f"window_spill {t}")

    # finishes since a snapshot: un-finish a random subset of the finished
    # jobs and tasks in the "old" arrays
    jf, tf = tree["jobs.job_finish"], tree["jobs.finish"]
    old_jf = np.where((jf < INF / 2) & (rng.random(jf.shape) < 0.6), INF,
                      jf).astype(np.float32)
    old_tf = np.where((tf < INF / 2) & (rng.random(tf.shape) < 0.6), INF,
                      tf).astype(np.float32)
    sla = rng.uniform(0.01, 1.0, jf.shape).astype(np.float32)
    sla[rng.random(jf.shape) < 0.3] = INF
    js = dataclasses.replace(js, jobs=dataclasses.replace(
        js.jobs, sla=jnp.asarray(sla)))
    ps = dataclasses.replace(ps, jobs=dataclasses.replace(ps.jobs,
                                                          sla=_t(sla)))
    hist0 = rng.integers(0, 5, jcfg.telemetry.n_bins).astype(np.float32)
    js = dataclasses.replace(js, telem=dataclasses.replace(
        js.telem, job_hist=jnp.asarray(hist0)))
    ps = dataclasses.replace(ps, telem=dataclasses.replace(
        ps.telem, job_hist=_t(hist0)))
    for c in (jcfg, dataclasses.replace(
            jcfg, telemetry=dataclasses.replace(jcfg.telemetry,
                                                use_kernel=True))):
        jt = jtelem.accumulate_finishes(js.telem, c, js.jobs,
                                        jnp.asarray(old_jf),
                                        jnp.asarray(old_tf))
        tt = ttelem.accumulate_finishes(ps.telem, pcfg, ps.jobs, _t(old_jf),
                                        _t(old_tf))
        check_obj(tt, jt, f"accumulate_finishes(use_kernel="
                  f"{c.telemetry.use_kernel})", max_ulp=0)
    # a quiet step is the identity
    tt = ttelem.accumulate_finishes(ps.telem, pcfg, ps.jobs, _t(jf), _t(tf))
    check_obj(tt, ps.telem, "quiet accumulate", max_ulp=0)

    lo, hi = pcfg.telemetry.lat_lo, pcfg.telemetry.lat_hi
    h = rng.integers(0, 7, (3, 64)).astype(np.float32)
    h[1] = 0.0
    for q in (50, 95, 99):
        np.testing.assert_array_equal(
            ttelem.hist_percentile(h, lo, hi, q),
            jtelem.hist_percentile(h, lo, hi, q))
    np.testing.assert_array_equal(ttelem.hist_mean(h, lo, hi),
                                  jtelem.hist_mean(h, lo, hi))
    np.testing.assert_array_equal(ttelem.bin_edges(pcfg.telemetry),
                                  jtelem.bin_edges(jcfg.telemetry))
    ts, jsum = ttelem.summarize(ps, pcfg), jtelem.summarize(js, jcfg)
    for f in dataclasses.fields(jsum):
        a, b = getattr(ts, f.name), getattr(jsum, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif isinstance(b, float) and np.isnan(b):
            assert np.isnan(a), f.name
        else:
            assert a == b, f.name


def test_state_from_numpy_roundtrip_and_checks():
    jcfg = _cfg(tasks_per_job=2)
    _, ps, tree = random_twin_states(jcfg, 5)
    for path, v in ttypes.tree_leaves(ps):
        np.testing.assert_array_equal(to_np(v), tree[path], err_msg=path)
    from repro_torch.convert import state_from_numpy
    bad = dict(tree)
    del bad["farm.q_len"]
    with pytest.raises(KeyError, match="farm.q_len"):
        state_from_numpy(bad, port_cfg(jcfg), device="cpu")
    with pytest.raises(ValueError, match="clock"):
        state_from_numpy(tree, port_cfg(jcfg, time_dtype=torch.float64),
                         device="cpu")
    for name in ("SrvState", "TaskStatus", "SchedPolicy", "SleepPolicy"):
        jc, tc = getattr(jtypes, name), getattr(ttypes, name)
        members = {k: v for k, v in vars(jc).items()
                   if k.isupper() and isinstance(v, int)}
        assert members and all(int(getattr(tc, k)) == int(v)
                               for k, v in members.items()), name
    assert ttypes.INF == jtypes.INF and SrvState.NUM == 6
