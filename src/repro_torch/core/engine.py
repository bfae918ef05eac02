"""The event-driven simulation engine in PyTorch, port of
``repro.core.engine``: the main path, network mode (flows over a
topology, switch states) and the thermal subsystem with its control plane
(throttling, the setpoint controller, THERMAL_AWARE placement and
CARBON_AWARE deferral) and the flight recorder (``core/trace.py``); the
scalar paths are refused by ``check_scope``.  Rack-sharded runs
(``core/shard_sim.py``) call ``_step`` on gathered full states.

The paper's sequential priority-queue loop becomes dense tensor work:

    while not done:
        t_next = min over all dense candidate-event arrays
        advance the farm to t_next      (one fused kernel: energy accrual,
                                         completions freed, next candidate)
        apply ALL events with time <= t_next as masked updates

Every ``lax.cond`` of the reference becomes masked work, so a macro-step
runs without waiting for the device; ``run``'s Python loop reads the
``done`` flag and the event count once per macro-step, in place of the
reference's ``lax.while_loop``.

Macro-stepping (``cfg.events_per_step`` = K): a step runs K-1 cheap passes,
each gated by ``_cheap_gate``; a pass whose gate (or an earlier one) is
false is computed and discarded leaf by leaf with ``torch.where`` -- the
reference's early loop exit, without a host check -- and then one full
step.  So the advance kernel launches exactly K times per step.

Flight recorder: each pass collects its records in a list (``recs``) as
it applies events, in the reference's order, and flushes them once at its
end; a cheap pass flushes under its ``alive`` flag, so a discarded pass
records nothing.

The replica axis (``core/montecarlo.py``): every function here takes a
state whose leaves share a leading batch shape, ``()`` for one run and
``(R,)`` for R independent farms, as ``jax.vmap`` gives the reference.
Reductions, ranks and gathers run along the trailing axes, scatters take
a sentinel column a replica (``types.set_drop``), and the two kernels
launch once a call for the whole batch.  ``run`` stops each replica on
its own ``~done & (events < max_events)``: a replica that stopped keeps
its state leaf by leaf, its ring included, while the others step.

Regions (``core/regions.py``), the reference's named scopes: a cheap
pass runs in ``cheap_core``, the full step in ``full_step``, the
interval's ``dt`` downcast in ``f32_domain``, the thermal subsystem's
calls in ``thermal`` and the flight recorder's work in ``trace``.  The
graph audit (``python -m repro_torch.analysis.simlint``) records the
ops of ``_step`` under them and holds the step to its contracts: no
host sync, a pinned cheap-core scatter budget, no op of a disabled
subsystem, no clock rebuilt from a downcast.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from . import network, power, scheduler, server, telemetry
from . import thermal as thermal_mod
from . import trace as trace_mod
from .regions import (CHEAP_CORE, F32_DOMAIN, FULL_STEP, THERMAL, TRACE,
                      region)
from .trace import stage, stage1
from .types import (INF, JobTable, SchedPolicy, ServerFarm, SimConfig,
                    SimState, SleepPolicy, SrvState, TaskStatus, TraceKind,
                    init_farm, init_flows, init_net, init_sched, lift,
                    replace, set_drop, take, tree_where)

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32


# ==========================================================================
# scope and constants
# ==========================================================================

def check_scope(cfg: SimConfig) -> None:
    """Refuse configurations this slice of the port does not run yet,
    naming the ROADMAP item (Queue 1) that will bring them."""
    if not cfg.use_vectorized_hot_loop:
        raise NotImplementedError(
            "repro_torch does not run use_vectorized_hot_loop=False yet: it "
            "comes with ROADMAP.md Queue 1 item 12 (seed scalar paths)")
    if cfg.n_present > cfg.n_servers:
        raise ValueError(
            f"n_present={cfg.n_present} exceeds n_servers={cfg.n_servers}")
    for policy, name, why in (
            (SchedPolicy.THERMAL_AWARE, "THERMAL_AWARE",
             "placement would silently ignore temperatures"),
            (SchedPolicy.CARBON_AWARE, "CARBON_AWARE",
             "the deferral signal and its telemetry live in the thermal "
             "subsystem")):
        if cfg.sched_policy == policy and not cfg.thermal.enabled:
            raise ValueError(f"SchedPolicy.{name} requires "
                             f"cfg.thermal.enabled=True ({why})")


@dataclasses.dataclass
class EngineConsts:
    """Per-run device constants: the advance kernel's (6,) f32 state-power
    table and, in network mode, the topology's arrays.  Built once
    (``consts``), so the loop copies nothing from the host."""

    state_power: torch.Tensor
    net: network.TopoConsts | None = None


def consts(cfg: SimConfig, device, topo=None) -> EngineConsts:
    """The run's constants; network mode takes ``topo`` (a
    ``core.topology.Topology``) and raises without it."""
    sp = cfg.server_power
    table = torch.tensor([sp.p_base, sp.p_base, sp.p_pkg_c6, sp.p_s3,
                          sp.p_off, sp.p_wake], dtype=F32)
    tc_net = network.topo_consts(topo, device) \
        if cfg.has_network and topo is not None else None
    tc = EngineConsts(state_power=table.to(device), net=tc_net)
    _check_consts(cfg, tc)
    return tc


def _check_consts(cfg: SimConfig, tc: EngineConsts) -> None:
    if cfg.has_network and tc.net is None:
        raise ValueError(
            "cfg.has_network=True requires a topology: pass topo= to "
            "init_state or farm.simulate (flows never route without one)")


# ==========================================================================
# helpers
# ==========================================================================

def _active_jobs(jobs: JobTable) -> torch.Tensor:
    """Tasks in flight (READY/QUEUED/RUNNING) -- the provisioning load."""
    s = jobs.status
    return ((s == TaskStatus.READY) | (s == TaskStatus.QUEUED)
            | (s == TaskStatus.RUNNING)).sum(dim=-1, dtype=I32)


def _pending_jobs(jobs: JobTable) -> torch.Tensor:
    """Tasks waiting for a core (READY/QUEUED) -- the WASP pool metric."""
    s = jobs.status
    return ((s == TaskStatus.READY) | (s == TaskStatus.QUEUED)).sum(
        dim=-1, dtype=I32)


def _deferral_on(cfg: SimConfig) -> bool:
    """CARBON_AWARE with a finite signal threshold: only then does the
    deferral machinery run (with the default INF threshold CARBON_AWARE is
    LOAD_BALANCE placement)."""
    return cfg.sched_policy == SchedPolicy.CARBON_AWARE \
        and cfg.thermal.deferral


def _next_arrival(jobs: JobTable) -> torch.Tensor:
    """The next arrival's time (INF past the table), a gather along the
    job axis: no host read."""
    J = jobs.arrival.shape[-1]
    nxt = take(jobs.arrival, jobs.arr_ptr.clamp(0, J - 1))
    return torch.where(jobs.arr_ptr < J, nxt, INF)


def _farm_candidates(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """Candidate next-event time from arrivals + farm sources, with the
    READY/startable pin to ``now`` -- everything the cheap core handles."""
    farm = state.farm
    t_next = torch.minimum(
        torch.minimum(_next_arrival(state.jobs),
                      farm.core_busy_until.amin(dim=(-2, -1))),
        torch.minimum(farm.srv_wake_at.amin(dim=-1),
                      scheduler.next_timer_event(farm, cfg)))
    with region(THERMAL):
        if _deferral_on(cfg):
            # deferred-job releases are ordinary events of the cheap core
            # too
            t_next = torch.minimum(t_next, state.jobs.admit_at.amin(dim=-1))
        if cfg.thermal.has_ctrl:
            # setpoint-controller ticks, applied right after the advance
            t_next = torch.minimum(t_next, state.thermal.ctrl_next)
    # pending READY tasks (or queued work on awake free cores) run "now"
    ready = (state.jobs.status == TaskStatus.READY).any(dim=-1)
    awake = (farm.srv_state == SrvState.ACTIVE) \
        | (farm.srv_state == SrvState.IDLE)
    startable = (awake & (farm.q_len > 0)
                 & (farm.core_busy_until >= INF).any(dim=-1)).any(dim=-1)
    t_next = torch.where(ready | startable, state.t, t_next)
    return torch.maximum(t_next, state.t).to(cfg.time_dtype)


def next_event_time(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """Every event source: the farm's, flow completions in network mode
    and throttle-threshold crossings when throttling is armed."""
    t_next = _farm_candidates(state, cfg)
    if cfg.has_network:
        t_next = torch.minimum(t_next, state.flows.done_at.amin(dim=-1))
    if cfg.thermal.throttling:
        with region(THERMAL):
            t_next = torch.minimum(t_next,
                                   thermal_mod.next_crossing(state, cfg))
    return torch.maximum(t_next, state.t).to(cfg.time_dtype)


# ==========================================================================
# interval advance
# ==========================================================================

def _advance_interval(state: SimState, cfg: SimConfig, tc: EngineConsts,
                      t_next) -> SimState:
    """Integrate over the piecewise-constant interval [t, t_next), then set
    t := t_next.  The fused advance kernel accrues energy and busy
    core-seconds (active-core power scaled on throttled servers) and frees
    completed cores (its done mask and candidate are not needed here);
    residency accrues beside it.  The per-server power, one RC evaluation
    and one CRAC evaluation are shared by the telemetry windows and the
    thermal integrator.  In network mode the switches accrue energy and
    the flows drain at their current rates."""
    farm = state.farm
    dt = t_next - state.t
    with region(F32_DOMAIN):
        dtf = dt.to(F32)                # physics runs in f32 on any clock
    onehot = power.state_onehot(farm)
    p_sw = power.switch_power(state.net, cfg) if cfg.has_network else None
    thermal_on = cfg.thermal.enabled
    throttled = state.thermal.throttled if thermal_on else None
    p_busy = power.server_power(farm, cfg, throttled) \
        if cfg.telemetry.enabled or thermal_on else None
    thermal_ctx = None
    if thermal_on:
        tcfg = cfg.thermal
        with region(THERMAL):
            target, alpha, t_end = thermal_mod.rc_step(
                state.thermal, tcfg, p_busy[0], state.t, dtf)
            p_sw_t = p_sw.sum(dim=-1) if cfg.has_network \
                else torch.zeros_like(dtf)
            p_cool = thermal_mod.cooling_power(p_busy[0], p_sw_t,
                                               state.thermal, tcfg)
        thermal_ctx = (target, alpha, t_end, p_cool)

    telem = state.telem
    if cfg.telemetry.enabled:
        wvals = telemetry.window_values(state, cfg, dt, p_busy, onehot,
                                        p_sw, thermal_ctx)
        widx = telemetry.window_index(state.t, dt, cfg.telemetry)
        spill = telemetry.window_spill(state.t, dt, cfg.telemetry)
        # one row a replica: row widx gets wvals
        K = wvals.shape[-1]
        telem = replace(telem,
                        win=telem.win.scatter_add(
                            -2, widx.to(I64)[..., None, None].expand(
                                widx.shape + (1, K)), wvals[..., None, :]),
                        win_overflow=telem.win_overflow + spill)

    sp = cfg.server_power
    nb, _done, en, bs, _cand = ops.dcsim_advance(
        farm.core_busy_until, farm.srv_state, farm.energy,
        farm.busy_core_seconds, state.t, t_next, tc.state_power,
        sp.p_core_active, sp.p_core_idle, farm.srv_wake_at,
        farm.srv_idle_since, farm.srv_tau,
        throttled if cfg.thermal.throttling else None,
        throttle_power_scale=cfg.thermal.throttle_power_scale)
    farm = replace(farm, core_busy_until=nb, energy=en,
                   busy_core_seconds=bs,
                   residency=farm.residency + onehot * lift(dtf, 2))
    net, flows = state.net, state.flows
    if cfg.has_network:
        net = power.accrue_switch_energy(net, dt, p_sw)
        # drain the fluid model over the interval (rates are piecewise
        # constant, fixed at the last recompute)
        flows = network.advance_flows(flows, dt)
    therm = state.thermal
    if thermal_on:
        with region(THERMAL):
            therm = thermal_mod.advance(therm, cfg, p_busy[0], p_sw_t,
                                        state.t, dt, t_new=t_end,
                                        p_cool=p_cool)
    return replace(state, farm=farm, net=net, flows=flows, thermal=therm,
                   telem=telem, t=t_next)


# ==========================================================================
# event appliers
# ==========================================================================

def _rebuild_job_completion(jobs: JobTable, cfg: SimConfig, now):
    """(tasks_done, job_finish) rebuilt from task statuses; newly complete
    jobs get job_finish stamped at ``now``."""
    T = cfg.tasks_per_job
    tasks_done = ((jobs.status == TaskStatus.DONE)
                  & jobs.valid).unflatten(-1, (-1, T)).sum(dim=-1, dtype=I32)
    n_valid_tasks = jobs.valid.unflatten(-1, (-1, T)).sum(dim=-1, dtype=I32)
    job_complete = (tasks_done >= n_valid_tasks) & (tasks_done > 0)
    job_finish = torch.where(job_complete & (jobs.job_finish >= INF),
                             lift(now), jobs.job_finish)
    return tasks_done, job_finish


def _promote_ready(jobs: JobTable, dep_count, cfg: SimConfig):
    """BLOCKED -> READY where deps are now satisfied (arrived jobs only).
    A carbon-deferred job has consumed its arrival slot but is not
    admitted: its roots stay BLOCKED until ``_apply_releases`` places
    it."""
    T = cfg.tasks_per_job
    tid = torch.arange(jobs.status.shape[-1], device=dep_count.device)
    arrived = tid // T < lift(jobs.arr_ptr)
    if _deferral_on(cfg):
        arrived = arrived & ~torch.repeat_interleave(
            jobs.admit_at < INF / 2, T, dim=-1)
    ready = (jobs.status == TaskStatus.BLOCKED) & (dep_count <= 0) & arrived
    return torch.where(ready, TaskStatus.READY, jobs.status).to(I32)


def _apply_wakeups(farm: ServerFarm, cfg, now):
    now = lift(now)
    done = (farm.srv_state == SrvState.WAKING) & (farm.srv_wake_at <= now)
    return replace(
        farm,
        srv_state=torch.where(done, SrvState.IDLE, farm.srv_state).to(I32),
        srv_wake_at=torch.where(done, INF, farm.srv_wake_at),
        srv_idle_since=torch.where(done, now, farm.srv_idle_since))


def _resolve_edges(jobs: JobTable, flows, net, cfg: SimConfig, tc,
                   done_task, now, recs=None):
    """DAG edges of the tasks in ``done_task``, then BLOCKED -> READY.
    Without a network every edge resolves immediately, decrementing the
    child's dep_count.  In network mode same-server and zero-byte edges
    resolve immediately and the others spawn flows parent server -> child
    server, in ascending task id and then column order; a spawn refused by
    a full flow table drop-resolves its edge.  The reference gates this on
    ``done_task.any()`` (and the spawn on any edge needing a flow); here
    the promotion is masked by the same predicate, and the rest is the
    identity when nothing finished.  It walks every task row: the
    reference compacts the finishing tasks to N*C rows in ascending task
    id, so both take the needed edges in the same order (and stage their
    FLOW_SPAWN records in it).  Returns (jobs, flows, net)."""
    ch = jobs.children                                     # (*B, JT, D)
    flat = ch.shape[:-2] + (-1,)                           # (*B, JT*D)
    chc = ch.clamp(min=0).reshape(flat).to(I64)
    ch_valid = (ch >= 0) & done_task[..., None] & ~jobs.edge_sent
    edge_sent = jobs.edge_sent | ch_valid
    if cfg.has_network:
        dst_srv = take(jobs.server, chc).view(ch.shape)
        needs_flow = ch_valid & (jobs.edge_bytes > 0) \
            & (dst_srv != jobs.server[..., None])
        dep_count = jobs.dep_count.scatter_add(
            -1, chc, -(ch_valid & ~needs_flow).reshape(flat).to(I32))
        need = needs_flow.reshape(flat)
        src = jobs.server[..., None].expand(ch.shape).reshape(flat)
        flows, net, ok = network.spawn_flows_many(
            flows, net, tc.net, cfg, need, src, dst_srv.reshape(flat),
            jobs.edge_bytes.reshape(flat), ch.reshape(flat), now)
        # a full flow table drop-resolves the edge, as a queue drop does
        dep_count = dep_count.scatter_add(-1, chc, -(need & ~ok).to(I32))
        if cfg.trace.enabled:
            with region(TRACE):
                stage(recs, need & ok, TraceKind.FLOW_SPAWN, src,
                      ch.reshape(flat), jobs.edge_bytes.reshape(flat))
    else:
        dep_count = jobs.dep_count.scatter_add(
            -1, chc, -ch_valid.reshape(flat).to(I32))
    status = torch.where(lift(done_task.any(dim=-1)),
                         _promote_ready(jobs, dep_count, cfg), jobs.status)
    return replace(jobs, status=status, dep_count=dep_count,
                   edge_sent=edge_sent), flows, net


def _apply_completions(state: SimState, cfg: SimConfig, tc,
                       recs=None) -> SimState:
    """Handle all tasks whose task_end <= now: mark them DONE, update job
    bookkeeping, resolve DAG edges (immediately, or by spawning flows).
    Elementwise in task space."""
    farm, jobs = state.farm, state.jobs
    now = state.t
    # free the cores (a no-op for slots the advance kernel already freed)
    done_core = farm.core_busy_until <= lift(now, 2)
    farm = replace(farm, core_busy_until=torch.where(
        done_core, INF, farm.core_busy_until))
    done_task = (jobs.status == TaskStatus.RUNNING) \
        & (jobs.task_end <= lift(now))
    status = torch.where(done_task, TaskStatus.DONE, jobs.status).to(I32)
    finish = torch.where(done_task, lift(now), jobs.finish)
    jobs = replace(jobs, status=status, finish=finish)
    tasks_done, job_finish = _rebuild_job_completion(jobs, cfg, now)
    if cfg.trace.enabled:
        with region(TRACE):
            JT, J = done_task.shape[-1], job_finish.shape[-1]
            dev = done_task.device
            stage(recs, done_task, TraceKind.FINISH, jobs.server,
                  torch.arange(JT, dtype=I32, device=dev),
                  lift(now) - jobs.start_at)
            new_jf = (jobs.job_finish >= INF / 2) & (job_finish < INF / 2)
            stage(recs, new_jf, TraceKind.JOB_FINISH, -1,
                  torch.arange(J, dtype=I32, device=dev),
                  job_finish - jobs.arrival)
    jobs = replace(jobs, tasks_done=tasks_done, job_finish=job_finish)
    flows, net = state.flows, state.net
    if cfg.tasks_per_job > 1:
        jobs, flows, net = _resolve_edges(jobs, flows, net, cfg, tc,
                                          done_task, now, recs)
    return replace(state, farm=farm, jobs=jobs, flows=flows, net=net)


def _apply_flow_completions(state: SimState, cfg: SimConfig,
                            recs=None) -> SimState:
    """Flows done by now decrement their child's dep_count; BLOCKED ->
    READY masked by "any flow finished", as the reference gates it."""
    flows, fin = network.complete_flows(state.flows, state.t)
    jobs = state.jobs
    dep_count = jobs.dep_count.scatter_add(
        -1, torch.where(fin, flows.child, 0).to(I64), -fin.to(I32))
    status = torch.where(lift(fin.any(dim=-1)),
                         _promote_ready(jobs, dep_count, cfg), jobs.status)
    if cfg.trace.enabled:
        with region(TRACE):
            # complete_flows keeps dst/child on the deactivated rows
            stage(recs, fin, TraceKind.FLOW_FINISH, flows.dst, flows.child)
    return replace(state, flows=flows,
                   jobs=replace(jobs, dep_count=dep_count, status=status))


def _apply_arrival(state: SimState, cfg: SimConfig, tc,
                   hold=None, recs=None) -> SimState:
    """Admit up to cfg.arrivals_per_step jobs whose arrival <= t in one
    pass against one scheduler snapshot: assign servers to all their tasks
    and mark roots READY.  With nothing to admit the pass is the identity
    (no task is eligible), so the reference's gate needs no mask.
    NETWORK_AWARE with a network adds each server's wake cost from the
    front end (server 0), one evaluation for the whole batch (the net
    state does not change during admission); THERMAL_AWARE scores by the
    servers' temperatures.

    CARBON_AWARE deferral: a deferrable job arriving while the signal is
    above the threshold parks instead, with a release time (the signal's
    solved down-crossing or its deadline, whichever comes first) that is
    an event candidate; it consumes its arrival slot.  ``hold``
    (batch-shaped bool) holds every arrival while due releases are
    pending, so the release train admits first, as the oracle orders
    it."""
    jobs, farm, sched = state.jobs, state.farm, state.sched
    J = jobs.arrival.shape[-1]
    T = cfg.tasks_per_job
    K = cfg.arrivals_per_step
    dev = jobs.status.device
    JT = jobs.status.shape[-1]
    B = jobs.status.shape[:-1]
    j0 = lift(jobs.arr_ptr)
    now = lift(state.t)
    jid = j0 + torch.arange(K, dtype=I32, device=dev)          # (*B, K)
    nxt = take(jobs.arrival, jid.clamp(0, J - 1))
    elig = (jid < J) & (nxt <= now) & (nxt < INF / 2)
    # arrivals are sorted, so eligibility is a prefix; enforce it anyway
    elig = torch.cumprod(elig.to(I32), -1).to(torch.bool)
    if hold is not None:
        elig = elig & ~lift(hold)
    n_adm = elig.sum(dim=-1, dtype=I32)
    adm = elig
    if _deferral_on(cfg):
        tcfg = cfg.thermal
        with region(THERMAL):
            jc = jid.clamp(0, J - 1).to(I64)
            sig = thermal_mod.defer_signal_now(tcfg, state.t)
            rel = thermal_mod.next_release_time(tcfg, state.t)
            cand = torch.minimum(lift(rel.to(cfg.time_dtype)),
                                 take(jobs.deadline, jc))
            dfr = elig & take(jobs.deferrable, jc) \
                & lift(sig > tcfg.defer_threshold) & (cand > now) \
                & (cand < INF / 2)
            jobs = replace(jobs, admit_at=set_drop(
                jobs.admit_at, torch.where(dfr, jid, J),
                torch.where(dfr, cand, INF)))
            adm = elig & ~dfr

    tids = j0 * T + torch.arange(K * T, dtype=I32, device=dev)
    in_range = tids < JT
    sc = torch.where(in_range, tids, JT)                  # scatter sentinel
    gather = tids.clamp(0, JT - 1).to(I64)
    elig_t = torch.repeat_interleave(adm, T, dim=-1)
    is_valid = take(jobs.valid, gather) & elig_t & in_range
    root = is_valid & (take(jobs.dep_count, gather) <= 0)

    if cfg.sched_policy == SchedPolicy.ROUND_ROBIN:
        # all K*T assignments in one shot (round-robin rank matching)
        srvs, rr_new = scheduler.pick_servers_for_job(farm, cfg, sched,
                                                      is_valid)
        sched = replace(sched, rr_ptr=rr_new)
    else:
        # one pick per job against the shared snapshot; job k sees the
        # roots committed by jobs 0..k-1 of the batch as extra load
        load = scheduler.server_load(farm, cfg).to(F32)
        net_cost = None
        if cfg.has_network and cfg.sched_policy == SchedPolicy.NETWORK_AWARE:
            net_cost = network.route_wake_cost(
                tc.net, state.net, 0, torch.arange(cfg.n_servers, device=dev))
        temp = state.thermal.t_srv if cfg.thermal.enabled and \
            cfg.sched_policy == SchedPolicy.THERMAL_AWARE else None
        srvs = _batch_picks(farm, cfg, sched, load, root.view(B + (K, T)),
                            net_cost, temp)
    server_arr = set_drop(jobs.server, sc,
                          torch.where(is_valid, srvs,
                                      take(jobs.server, gather)))
    status = set_drop(jobs.status, sc,
                      torch.where(root, TaskStatus.READY,
                                  take(jobs.status, gather)).to(I32))
    jobs = replace(jobs, server=server_arr, status=status,
                   arr_ptr=(jobs.arr_ptr + n_adm).to(I32))
    if cfg.trace.enabled:
        with region(TRACE):
            # ARRIVAL for every consumed arrival slot (deferred jobs too),
            # ADMIT for the placed ones: the server of the job's first task and
            # its queue depth, which changes only at the READY drain
            stage(recs, elig, TraceKind.ARRIVAL, -1, jid)
            first = (j0 * T + torch.arange(K, dtype=I32, device=dev) * T
                     ).clamp(0, JT - 1)
            job_srv = take(jobs.server, first)
            stage(recs, adm, TraceKind.ADMIT, job_srv, jid,
                  take(farm.q_len, job_srv.clamp(min=0)))
    return replace(state, jobs=jobs, sched=sched)


def _batch_picks(farm, cfg: SimConfig, sched, load, root_kt, net_cost=None,
                 temp=None):
    """One score-policy pick per job of a (K, T) admission batch against
    one farm snapshot; job k sees the roots committed by jobs 0..k-1 of
    the batch as extra load.  ``root_kt`` (*B, K, T).  Returns the (*B,
    K*T) servers, job-major."""
    K, T = root_kt.shape[-2:]
    root_k = root_kt.sum(dim=-1, dtype=I32).to(F32)
    ar = torch.arange(cfg.n_servers, device=load.device)
    extra = torch.zeros(load.shape, dtype=F32, device=load.device)
    picks = []
    for k in range(K):                     # static unroll, K small
        srv_k, _ = scheduler.pick_server(farm, cfg, sched, extra, load,
                                         net_cost, temp)
        extra = torch.where(ar == lift(srv_k), extra + root_k[..., k, None],
                            extra)
        picks.append(srv_k)
    return torch.repeat_interleave(torch.stack(picks, dim=-1), T, dim=-1)


def _apply_releases(state: SimState, cfg: SimConfig,
                    recs=None) -> SimState:
    """Admit deferred jobs whose release time has come (CARBON_AWARE):
    up to cfg.arrivals_per_step a step in ascending job id, against one
    scheduler snapshot, as a same-timestamp arrival batch admits.
    Leftover due jobs keep the next event at ``now`` and release on the
    next step.  Runs before fresh arrivals: released jobs carry lower ids,
    so the READY drain serves them first, the oracle's release-then-
    arrive order.  Accrues the deferral telemetry: deferred seconds, the
    release count and a first-order grams-avoided estimate (marginal job
    energy times the carbon-intensity drop between arrival and release).

    The reference gates this on any job being due; here it always runs.
    With nothing due no job is selected: every write lands on a drop
    sentinel and the counters add zeros, so the state is unchanged bit for
    bit."""
    jobs = state.jobs
    now = state.t
    J = jobs.arrival.shape[-1]
    T = cfg.tasks_per_job
    JT = jobs.status.shape[-1]
    B = jobs.status.shape[:-1]
    K = cfg.arrivals_per_step
    dev = now.device
    due = (jobs.admit_at < INF / 2) & (jobs.admit_at <= lift(now))
    # the first K due job ids into (*B, K) slots, ascending (-1: empty)
    r = torch.cumsum(due, -1, dtype=I32) - 1
    jid_b = set_drop(torch.full(B + (K,), -1, dtype=I32, device=dev),
                     torch.where(due & (r < K), r, K),
                     torch.arange(J, dtype=I32, device=dev))
    jvalid = jid_b >= 0
    jq = jid_b.clamp(0, J - 1).to(I64)

    tids = (jq[..., None] * T + torch.arange(T, device=dev)).flatten(-2)
    gather = tids.clamp(0, JT - 1)
    valid_t = torch.repeat_interleave(jvalid, T, dim=-1)
    sc = torch.where(valid_t, tids, JT)
    is_valid = take(jobs.valid, gather) & valid_t
    # only still-parked roots flip READY: a repeated release of a row that
    # was already processed must never re-run a task
    root = is_valid & (take(jobs.dep_count, gather) <= 0) \
        & (take(jobs.status, gather) == TaskStatus.BLOCKED)
    load = scheduler.server_load(state.farm, cfg).to(F32)
    srvs = _batch_picks(state.farm, cfg, state.sched, load,
                        root.view(B + (K, T)))
    jobs = replace(
        jobs,
        server=set_drop(jobs.server, sc,
                        torch.where(is_valid, srvs,
                                    take(jobs.server, gather))),
        status=set_drop(jobs.status, sc,
                        torch.where(root, TaskStatus.READY,
                                    take(jobs.status, gather)).to(I32)),
        admit_at=set_drop(jobs.admit_at, torch.where(jvalid, jid_b, J),
                          INF))

    tcfg = cfg.thermal
    therm = state.thermal
    arr_j = take(jobs.arrival, jq)
    zero = torch.zeros((), dtype=F32, device=dev)
    waited = torch.where(jvalid, (lift(now) - arr_j).to(F32), zero)
    ci_drop = thermal_mod.carbon_intensity_now(tcfg, arr_j) \
        - lift(thermal_mod.carbon_intensity_now(tcfg, now))
    sp = cfg.server_power
    svc = jobs.service.unflatten(-1, (J, T))                   # (*B, J, T)
    e_kwh = torch.gather(svc, -2, jq[..., None].expand(B + (K, T))
                         ).sum(dim=-1) \
        * float(np.float32((sp.p_core_active - sp.p_core_idle) / 3.6e6))
    avoided = torch.where(jvalid, ci_drop * e_kwh, zero)
    therm = replace(
        therm, defer_seconds=therm.defer_seconds + waited.sum(dim=-1),
        defer_count=therm.defer_count + jvalid.sum(dim=-1, dtype=I32),
        grams_avoided=therm.grams_avoided + avoided.sum(dim=-1))
    if cfg.trace.enabled:
        with region(TRACE):
            picks = srvs.view(B + (K, T))[..., 0]
            stage(recs, jvalid, TraceKind.RELEASE, -1, jid_b, waited)
            stage(recs, jvalid, TraceKind.ADMIT, picks, jid_b,
                  take(state.farm.q_len, picks.clamp(min=0)))
    return replace(state, jobs=jobs, thermal=therm)


def _resolve_drops(state: SimState, cfg: SimConfig, dropped,
                   recs=None) -> SimState:
    """Bookkeeping for tasks dropped by a full queue (already marked DONE
    by the drain): finish stamps, job completion and immediate DAG-edge
    resolution, masked by ``dropped.any()`` as the reference gates it."""
    now = state.t
    jobs = state.jobs
    any_drop = dropped.any(dim=-1)
    finish = torch.where(dropped, lift(now), jobs.finish)
    tasks_done, job_finish = _rebuild_job_completion(jobs, cfg, now)
    ch = jobs.children
    flat = ch.shape[:-2] + (-1,)
    ch_valid = (ch >= 0) & dropped[..., None] & ~jobs.edge_sent
    edge_sent = jobs.edge_sent | ch_valid
    dep_count = jobs.dep_count.scatter_add(
        -1, ch.clamp(min=0).reshape(flat).to(I64),
        -ch_valid.reshape(flat).to(I32))
    status = _promote_ready(jobs, dep_count, cfg)
    new = replace(jobs, status=status, finish=finish, tasks_done=tasks_done,
                  job_finish=job_finish, dep_count=dep_count,
                  edge_sent=edge_sent)
    new = tree_where(any_drop, new, jobs)
    if cfg.trace.enabled:
        with region(TRACE):
            JT, J = dropped.shape[-1], new.job_finish.shape[-1]
            dev = dropped.device
            stage(recs, dropped, TraceKind.DROP, new.server,
                  torch.arange(JT, dtype=I32, device=dev))
            new_jf = (jobs.job_finish >= INF / 2) & (new.job_finish < INF / 2)
            stage(recs, new_jf, TraceKind.JOB_FINISH, -1,
                  torch.arange(J, dtype=I32, device=dev),
                  new.job_finish - new.arrival)
    return replace(state, jobs=new)


def _drain_ready(state: SimState, cfg: SimConfig, recs=None) -> SimState:
    """Enqueue up to cfg.ready_per_step READY tasks (first K in task-id
    order) at their servers: FIFO stamps written into their own task rows,
    sleeping destinations woken.  With no READY task every update below is
    the identity, so the reference's gate needs no mask."""
    jobs, farm = state.jobs, state.farm
    K = cfg.ready_per_step
    JT = jobs.status.shape[-1]
    B = jobs.status.shape[:-1]
    N = cfg.n_servers
    dev = jobs.status.device
    is_ready = jobs.status == TaskStatus.READY
    r = torch.cumsum(is_ready, -1, dtype=I32) - 1       # rank among READY
    sel = is_ready & (r < K)
    # gather the selected tids into (*B, K) slots, ascending tid order
    tids = set_drop(torch.full(B + (K,), -1, dtype=I32, device=dev),
                    torch.where(sel, r, K),
                    torch.arange(JT, dtype=I32, device=dev))
    valid = tids >= 0
    srv = torch.where(valid, take(jobs.server, tids.clamp(min=0)), -1)

    farm, ok, seq = server.queue_push_many(farm, cfg, srv, tids, valid)
    dest = set_drop(torch.zeros(B + (N,), dtype=torch.bool, device=dev),
                    torch.where(valid, srv, N), True)
    farm = server.begin_wake_mask(farm, cfg, dest, state.t)

    sc = torch.where(valid, tids, JT)
    status = set_drop(jobs.status, sc,
                      torch.where(ok, TaskStatus.QUEUED,
                                  TaskStatus.DONE).to(I32))
    enq = set_drop(jobs.enqueue_seq, torch.where(valid & ok, tids, JT), seq)
    state = replace(state, farm=farm,
                    jobs=replace(jobs, status=status, enqueue_seq=enq))
    dropped = set_drop(torch.zeros(B + (JT,), dtype=torch.bool, device=dev),
                       torch.where(valid & ~ok, tids, JT), True)
    return _resolve_drops(state, cfg, dropped, recs)


def _start_tasks(state: SimState, cfg: SimConfig, recs=None) -> SimState:
    # throttled servers start work at their reduced effective frequency
    freq = None
    if cfg.thermal.throttling:
        with region(THERMAL):
            freq = thermal_mod.effective_freq(state.thermal, cfg)
    farm, jobs = server.try_start(state.farm, cfg, state.jobs, state.t,
                                  freq)
    if cfg.trace.enabled:
        with region(TRACE):
            started = (jobs.status == TaskStatus.RUNNING) \
                & (state.jobs.status == TaskStatus.QUEUED)
            JT = started.shape[-1]
            stage(recs, started, TraceKind.START, jobs.server,
                  torch.arange(JT, dtype=I32, device=started.device),
                  jobs.task_end - lift(state.t))
    return replace(state, farm=farm, jobs=jobs)


def _apply_events(state: SimState, cfg: SimConfig, tc, cheap: bool,
                  recs=None) -> SimState:
    """The event-application pipeline at the (already advanced) time.
    ``cheap`` leaves out what the cheap pass's gate guarantees is not
    needed: flow completions and the rate recompute (the active flow set
    cannot change in a cheap pass).  ``recs`` collects the pass's
    flight-recorder records.  Under ALWAYS_ON no server changes power
    state, so the WAKEUP and SLEEP sites are left out, as in the
    reference."""
    trace_sleep = cfg.trace.enabled \
        and cfg.sleep_policy != SleepPolicy.ALWAYS_ON
    dev = state.t.device
    if trace_sleep:
        with region(TRACE):
            farm = state.farm
            woke = (farm.srv_state == SrvState.WAKING) \
                & (farm.srv_wake_at <= lift(state.t))
            stage(recs, woke, TraceKind.WAKEUP,
                  torch.arange(cfg.n_servers, dtype=I32, device=dev))
    state = replace(state, farm=_apply_wakeups(state.farm, cfg, state.t))
    state = _apply_completions(state, cfg, tc, recs)
    if cfg.has_network and not cheap:
        state = _apply_flow_completions(state, cfg, recs)
    hold = None
    if _deferral_on(cfg):
        with region(THERMAL):
            # due releases admit before fresh arrivals, and a step that
            # entered with due releases holds the arrivals until the next
            # same-time step
            admit_at = state.jobs.admit_at
            hold = ((admit_at < INF / 2)
                    & (admit_at <= lift(state.t))).any(dim=-1)
            state = _apply_releases(state, cfg, recs)
    state = _apply_arrival(state, cfg, tc, hold, recs)
    state = _drain_ready(state, cfg, recs)
    state = _start_tasks(state, cfg, recs)
    # refresh ACTIVE/IDLE, run local power controllers + pool managers
    st_before = state.farm.srv_state
    farm = server.refresh_idle_state(state.farm, cfg, state.t)
    farm, sched = scheduler.provisioning_adjust(farm, cfg, state.sched,
                                                _active_jobs(state.jobs))
    farm = scheduler.wasp_adjust(farm, cfg, _pending_jobs(state.jobs),
                                 state.t)
    farm = scheduler.timer_transitions(farm, cfg, state.t)
    state = replace(state, farm=farm, sched=sched)
    if trace_sleep:
        with region(TRACE):
            # awake -> asleep edges of the local power controllers
            was_awake = (st_before == SrvState.ACTIVE) \
                | (st_before == SrvState.IDLE)
            asleep = (farm.srv_state == SrvState.PKG_C6) \
                | (farm.srv_state == SrvState.S3) \
                | (farm.srv_state == SrvState.OFF)
            stage(recs, was_awake & asleep, TraceKind.SLEEP,
                  torch.arange(cfg.n_servers, dtype=I32, device=dev), -1,
                  farm.srv_state)
    if cfg.has_network:
        flows, link_flows = state.flows, state.net.link_flows
        if not cheap:
            # rates only change in the full step; with no flow in flight
            # the reference skips the recompute and zeroes link_flows
            # (stale counts would pin ports ACTIVE after the last flow)
            any_active = flows.active.any(dim=-1)
            new, lf = network.recompute_rates(flows, tc.net, state.t)
            flows = tree_where(any_active, new, flows)
            link_flows = torch.where(lift(any_active), lf, 0)
        # ports and line cards still enter LPI on idle timeouts in a
        # cheap pass: a function of time, not of flow events
        net = network.update_switch_states(state.net, link_flows, tc.net,
                                           cfg, state.t)
        state = replace(state, flows=flows, net=net)
    return state


# ==========================================================================
# the step
# ==========================================================================

def _all_done(state: SimState, cfg: SimConfig) -> torch.Tensor:
    jobs = state.jobs
    done = (~jobs.valid | (jobs.status == TaskStatus.DONE)).all(dim=-1) \
        & (_next_arrival(jobs) >= INF)
    if cfg.has_network:
        done = done & ~state.flows.active.any(dim=-1)
    return done


def _cheap_gate(state: SimState, cfg: SimConfig):
    """(consume?, t_next) for one cheap event: False when nothing is
    pending, consuming the event would finish the simulation (the full
    step owns the done check), or -- in network mode -- a flow completes
    by t_next or a completing task would spawn a flow (the full step
    owns flow completions and the rate recompute)."""
    t_next = _farm_candidates(state, cfg)
    jobs = state.jobs
    will_be_done = (~jobs.valid | (jobs.status == TaskStatus.DONE)
                    | ((jobs.status == TaskStatus.RUNNING)
                       & (jobs.task_end <= lift(t_next)))).all(dim=-1) \
        & (_next_arrival(jobs) >= INF)
    if cfg.has_network:
        will_be_done = will_be_done & ~state.flows.active.any(dim=-1)
    ok = (t_next < INF / 2) & ~will_be_done
    if cfg.thermal.throttling:
        # a throttle crossing needs the full step
        with region(THERMAL):
            ok = ok & (t_next < thermal_mod.next_crossing(state, cfg))
    if cfg.has_network:
        ok = ok & (t_next < state.flows.done_at.amin(dim=-1))
        if cfg.tasks_per_job > 1:
            # a completing task whose unsent edges all resolve locally is
            # still cheap; only an edge that would spawn a flow stops it
            will_done = (jobs.status == TaskStatus.RUNNING) \
                & (jobs.task_end <= lift(t_next))
            ch = jobs.children
            unsent = (ch >= 0) & ~jobs.edge_sent
            dst = take(jobs.server, ch.clamp(min=0))
            spawns = unsent & (jobs.edge_bytes > 0) \
                & (dst != jobs.server[..., None])
            ok = ok & ~(will_done[..., None] & spawns).flatten(-2).any(dim=-1)
    return ok, t_next


def _apply_thermal_events(state: SimState, cfg: SimConfig,
                          recs=None) -> SimState:
    """The throttle latch (and the stretch of in-flight work) and the
    setpoint-controller tick, right after the interval advance in both
    the cheap and the full pass, with their flight-recorder records."""
    if cfg.thermal.throttling:
        old_thr = state.thermal.throttled
        with region(THERMAL):
            farm, jobs, therm = thermal_mod.apply_throttle(
                state.farm, state.jobs, state.thermal, cfg, state.t)
        state = replace(state, farm=farm, jobs=jobs, thermal=therm)
        if cfg.trace.enabled:
            with region(TRACE):
                stage(recs, therm.throttled != old_thr,
                      TraceKind.THROTTLE_CROSSING,
                      torch.arange(cfg.n_servers, dtype=I32,
                                   device=state.t.device), -1, therm.t_srv)
    if cfg.thermal.has_ctrl:
        if cfg.trace.enabled:
            with region(TRACE):
                # the tick fires when time reaches ctrl_next (an event
                # candidate); staged before the controller advances it
                stage1(recs, state.t >= state.thermal.ctrl_next,
                       TraceKind.CTRL_TICK)
        with region(THERMAL):
            state = replace(state, thermal=thermal_mod.apply_setpoint_ctrl(
                state.thermal, cfg, state.t))
    return state


def _consume_cheap(state: SimState, cfg: SimConfig, tc, t_next,
                   alive) -> SimState:
    with region(CHEAP_CORE):
        state = _advance_interval(state, cfg, tc, t_next)
        recs = [] if cfg.trace.enabled else None
        state = _apply_thermal_events(state, cfg, recs)
        state = _apply_events(state, cfg, tc, cheap=True, recs=recs)
        if cfg.trace.enabled:
            with region(TRACE):
                state = replace(state, trace=trace_mod.flush(
                    state.trace, cfg, state.t, recs, alive))
        return replace(state, events=state.events + 1)


def _macro_chew(state: SimState, cfg: SimConfig, tc,
                active=None) -> SimState:
    """K-1 cheap passes.  ``alive`` carries the conjunction of the gates
    (from ``active``, the replicas still running, when given), and each
    pass's state is kept only while it holds -- the reference's early exit
    from its inner while_loop, per replica and leaf by leaf.  A discarded
    pass still runs (and still launches the advance kernel)."""
    alive = torch.ones(state.t.shape, dtype=torch.bool,
                       device=state.t.device) if active is None else active
    for _ in range(cfg.events_per_step - 1):
        ok, t_next = _cheap_gate(state, cfg)
        alive = alive & ok
        new = _consume_cheap(state, cfg, tc, t_next, alive)
        state = tree_where(alive, new, state)
    return state


def _full_step(state: SimState, cfg: SimConfig, tc,
               active=None) -> SimState:
    with region(FULL_STEP):
        # every event source: the farm's, arrivals, flow completions and
        # throttle crossings
        t_next = next_event_time(state, cfg)
        # INF means no pending events: freeze time instead of integrating
        # energy over an unbounded interval
        t_next = torch.where(t_next >= INF / 2, state.t, t_next)
        state = _advance_interval(state, cfg, tc, t_next)
        recs = [] if cfg.trace.enabled else None
        state = _apply_thermal_events(state, cfg, recs)
        state = _apply_events(state, cfg, tc, cheap=False, recs=recs)
        if cfg.trace.enabled:
            with region(TRACE):
                # a replica that stopped records nothing
                state = replace(state, trace=trace_mod.flush(
                    state.trace, cfg, state.t, recs, active))
        return replace(state, events=state.events + 1,
                       done=_all_done(state, cfg))


def sim_step(state: SimState, cfg: SimConfig,
             tc: EngineConsts | None = None) -> SimState:
    """One macro-step: K-1 masked cheap passes, then one full step; latency
    and QoS binning once over everything that finished since the step
    began.  A replica batch steps every replica (as ``jax.vmap`` of the
    reference's step does).  The flight recorder's ring is copied first
    (the step writes it in place), so ``state`` is left as it was."""
    if tc is None:
        tc = consts(cfg, state.t.device)
    _check_consts(cfg, tc)
    if cfg.trace.enabled:
        state = replace(state, trace=trace_mod.own(state.trace, cfg))
    return _step(state, cfg, tc)


def _step(state: SimState, cfg: SimConfig, tc: EngineConsts,
          active=None) -> SimState:
    """``sim_step`` on a state whose ring the step may write in place.
    ``active`` (a replica batch's (R,) bool) keeps the step's result only
    for the replicas still running: the others keep every leaf, their
    ``steps``, ``events`` and ring included."""
    old = state
    if cfg.telemetry.enabled:
        old_job_finish = state.jobs.job_finish
        old_task_finish = state.jobs.finish
    if cfg.events_per_step > 1:
        state = _macro_chew(state, cfg, tc, active)
    state = _full_step(state, cfg, tc, active)
    state = replace(state, steps=state.steps + 1)
    if cfg.telemetry.enabled:
        state = replace(state, telem=telemetry.accumulate_finishes(
            state.telem, cfg, state.jobs, old_job_finish, old_task_finish))
    if active is not None:
        state = tree_where(active, state, old)
    return state


def init_state(cfg: SimConfig, jobs: JobTable, topo=None, racks=None):
    """Initial state on the job table's device, and the run's device
    constants.  ``topo`` (a ``core.topology.Topology``) is required in
    network mode; its sizes shape the net state.  ``racks`` is an optional
    (N,) host array of rack ids for the thermal recirculation grouping;
    with a topology it defaults to the servers' first-hop switches
    (``topology.rack_of_servers``), else to ``i // thermal.rack_size``.
    Returns (state, tc)."""
    check_scope(cfg)
    if cfg.partition.sharded and cfg.thermal.enabled and racks is None \
            and topo is None \
            and cfg.n_servers % max(cfg.thermal.rack_size, 1):
        # unsharded runs handle an uneven last rack through the general
        # grouping; the rack-major block partition cannot, so the sharded
        # path refuses it up front instead of falling back
        raise ValueError(
            f"n_servers={cfg.n_servers} does not fill whole racks of "
            f"rack_size={cfg.thermal.rack_size}, so the rack-major "
            f"partition cannot cut on rack boundaries; pad the farm with "
            f"farm.pad_to_racks(cfg) (inert filler rows)")
    dev = jobs.status.device
    tc = consts(cfg, dev, topo)
    if racks is None and topo is not None and cfg.thermal.enabled:
        from . import topology
        racks = topology.rack_of_servers(topo, cfg.thermal.rack_size)
    n_sw = topo.n_switches if topo is not None else 0
    n_ports = topo.n_ports if topo is not None else 1
    n_links = topo.n_links if topo is not None else 1
    n_lc = topo.n_linecards if topo is not None else 1
    state = SimState(
        t=torch.zeros((), dtype=cfg.time_dtype, device=dev),
        farm=init_farm(cfg, dev),
        jobs=jobs,
        flows=init_flows(cfg, dev),
        net=init_net(n_sw, n_ports, n_links, n_lc, cfg, dev),
        sched=init_sched(cfg, dev),
        telem=telemetry.init_telemetry(cfg, dev),
        thermal=thermal_mod.init_thermal(cfg, dev, racks),
        trace=trace_mod.init_trace(cfg, dev),
        events=torch.zeros((), dtype=I32, device=dev),
        steps=torch.zeros((), dtype=I32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
    )
    return state, tc


def run(state: SimState, cfg: SimConfig,
        tc: EngineConsts | None = None) -> SimState:
    """Run to completion (or cfg.max_events).  Each replica of a batch
    runs while ``~done & (events < max_events)`` holds for it, and keeps
    its state once it stops; the loop reads one flag a macro-step, whether
    any replica still runs.  With macro-stepping a run may retire up to
    events_per_step - 1 events past max_events.  The flight recorder's
    ring is copied once, then written in place, so ``state`` is left as
    it was."""
    check_scope(cfg)
    if tc is None:
        tc = consts(cfg, state.t.device)
    _check_consts(cfg, tc)
    if cfg.trace.enabled:
        state = replace(state, trace=trace_mod.own(state.trace, cfg))
    while True:
        active = ~state.done & (state.events < cfg.max_events)
        if not bool(active.any()):
            return state
        # one run steps only while it is active: no mask to apply
        state = _step(state, cfg, tc, active if active.dim() else None)


__all__ = ["check_scope", "consts", "EngineConsts", "next_event_time",
           "sim_step", "init_state", "run"]
