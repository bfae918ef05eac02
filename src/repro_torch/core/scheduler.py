"""Global scheduling policies and power-policy controllers (paper §III-E),
port of ``repro.core.scheduler``:

  * round-robin / load-balance task->server assignment
  * network-aware assignment (case D): load plus the network wake cost
  * thermal-aware assignment: load plus the server's temperature excess
  * threshold provisioning (case A): grow/shrink the enabled set
  * delay timers, single & dual (case B)
  * WASP two-pool management (case C)

CARBON_AWARE places by load: what it changes is when deferrable jobs
admit (``engine._apply_releases``), not where they land.

States carry a leading batch shape (``()`` or ``(R,)`` replicas); picks,
ranks and counts run along the trailing server axis, ties to the lowest
index.
"""
from __future__ import annotations

import torch

from .types import (INF, SchedPolicy, ServerFarm, SimConfig, SleepPolicy,
                    SrvState, lift, replace, take)

BIG = 1.0e9
I32 = torch.int32
I64 = torch.int64
F32 = torch.float32


def server_load(farm: ServerFarm, cfg: SimConfig):
    """Per-server occupancy = running + queued (*B, N) int32."""
    busy = (farm.core_busy_until < INF).sum(dim=-1, dtype=I32)
    return busy + farm.q_len


def pick_server(farm: ServerFarm, cfg: SimConfig, sched, extra_load=None,
                load=None, net_cost=None, temp=None):
    """Choose a server for one task.  Returns (server (*B,) int32,
    new_rr_ptr).  ``extra_load`` (*B, N) f32 is load already committed by
    earlier jobs of the same admission batch; ``load`` optionally supplies
    ``server_load(farm, cfg)`` as f32, which the batch computes once.
    ``net_cost`` (N,) int32 is case D's count of sleeping switches on the
    route to each server; NETWORK_AWARE without it (no network) scores
    load alone, as the other score policies do.  ``temp`` (N,) f32 is the
    server temperatures THERMAL_AWARE scores by."""
    N = cfg.n_servers
    dev = farm.q_len.device
    if load is None:
        load = server_load(farm, cfg).to(F32)
    if extra_load is not None:
        load = load + extra_load
    enabled = farm.srv_enabled
    full = farm.q_len >= cfg.local_q

    if cfg.sched_policy == SchedPolicy.ROUND_ROBIN:
        # first enabled, non-full server at/after rr_ptr; when every
        # enabled server is full, the least-loaded enabled one
        idx = (lift(sched.rr_ptr) + torch.arange(N, device=dev)) % N
        ok = take(enabled, idx) & ~take(full, idx)
        off = torch.argmax(ok.to(I32), dim=-1)           # first True
        fb = torch.argmin(torch.where(enabled, load, 2 * BIG), dim=-1)
        srv = torch.where(ok.any(dim=-1), take(idx, off), fb).to(I32)
        return srv, (srv + 1) % N

    score = load
    if cfg.sched_policy == SchedPolicy.NETWORK_AWARE and net_cost is not None:
        sleeping = (farm.srv_state == SrvState.PKG_C6) \
            | (farm.srv_state == SrvState.S3) \
            | (farm.srv_state == SrvState.OFF)
        score = load + net_cost.to(F32) * 100.0 + sleeping.to(F32) * 10.0
    elif cfg.sched_policy == SchedPolicy.THERMAL_AWARE and temp is not None:
        score = load + (temp - cfg.thermal.t_inlet) \
            * cfg.thermal.sched_temp_weight
    elif cfg.sched_policy == SchedPolicy.WASP_POOLS:
        score = load + farm.srv_pool.to(F32) * BIG
    elif cfg.sleep_policy == SleepPolicy.DUAL_TIMER:
        # prioritize the high-tau pool (pool 0) so low-tau servers sleep
        score = load + farm.srv_pool.to(F32) * 1000.0
    score = torch.where(enabled & ~full, score, 2 * BIG)
    return torch.argmin(score, dim=-1).to(I32), sched.rr_ptr


def pick_servers_for_job(farm: ServerFarm, cfg: SimConfig, sched, valid):
    """Assign servers to all tasks of one admission batch in one shot.
    Equivalent to sequential ``pick_server`` calls against the same farm
    snapshot; ROUND_ROBIN walks the cyclically ordered enabled, non-full
    servers by rank matching.  ``valid`` (*B, T).  Returns (servers (*B, T)
    int32, new_rr_ptr)."""
    N, T = cfg.n_servers, valid.shape[-1]
    dev = valid.device

    if cfg.sched_policy != SchedPolicy.ROUND_ROBIN:
        srv, _ = pick_server(farm, cfg, sched)
        return srv[..., None].expand(valid.shape), sched.rr_ptr

    load = server_load(farm, cfg).to(F32)
    enabled = farm.srv_enabled
    full = farm.q_len >= cfg.local_q
    idx = (lift(sched.rr_ptr) + torch.arange(N, device=dev)) % N
    ok = take(enabled, idx) & ~take(full, idx)
    n_ok = ok.sum(dim=-1, dtype=I32)
    rank = torch.cumsum(ok, -1, dtype=I32) - 1         # rank of each ok
    vi = torch.cumsum(valid, -1, dtype=I32) - 1        # pick index per task
    want = torch.remainder(vi, lift(n_ok.clamp(min=1)))
    match = ok[..., None, :] & (rank[..., None, :] == want[..., :, None])
    srv = take(idx, torch.argmax(match.to(I32), dim=-1))       # (*B, T)
    fb = torch.argmin(torch.where(enabled, load, 2 * BIG), dim=-1)
    srv = torch.where(lift(n_ok > 0), srv, lift(fb)).to(I32)
    last = take(srv, torch.argmax(torch.where(valid, vi, -1), dim=-1))
    rr_new = torch.where(valid.any(dim=-1), (last + 1) % N,
                         sched.rr_ptr).to(I32)
    return srv, rr_new


def provisioning_adjust(farm: ServerFarm, cfg: SimConfig, sched,
                        active_jobs):
    """Case A: keep load per enabled server between (prov_lo, prov_hi) by
    enabling / disabling one server at a time."""
    if cfg.sched_policy != SchedPolicy.PROVISIONED:
        return farm, sched
    n = sched.n_enabled.to(F32)
    per = active_jobs.to(F32) / torch.clamp(n * cfg.n_cores, min=1.0)
    grow = per > cfg.prov_hi
    shrink = (per < cfg.prov_lo) & (sched.n_enabled > 1)
    # the enabled set only grows into real servers (index < cfg.present)
    n_new = torch.clamp(sched.n_enabled + grow.to(I32) - shrink.to(I32),
                        1, cfg.present).to(I32)
    enabled = torch.arange(cfg.n_servers, device=n_new.device) < lift(n_new)
    return replace(farm, srv_enabled=enabled), replace(sched, n_enabled=n_new)


def wasp_adjust(farm: ServerFarm, cfg: SimConfig, active_jobs, now):
    """Case C: migrate one server between active(0)/sleep(1) pools based on
    pending jobs per active server."""
    if cfg.sleep_policy != SleepPolicy.WASP:
        return farm
    ar = torch.arange(cfg.n_servers, device=farm.srv_pool.device)
    n_active = torch.clamp((farm.srv_pool == 0).sum(dim=-1, dtype=I32),
                           min=1)
    per = active_jobs.to(F32) / n_active.to(F32)

    # wake: pick one sleep-pool server (prefer the shallowest sleep state)
    want_wake = per > cfg.wasp_t_wakeup
    in_sleep_pool = farm.srv_pool == 1
    wake_score = torch.where(in_sleep_pool, farm.srv_state.to(F32), BIG)
    cand_w = torch.argmin(wake_score, dim=-1)
    do_wake = want_wake & in_sleep_pool.any(dim=-1)
    pool = torch.where((ar == lift(cand_w)) & lift(do_wake), 0,
                       farm.srv_pool).to(I32)

    # sleep: demote one idle active-pool server
    want_sleep = per < cfg.wasp_t_sleep
    idle_active = (pool == 0) & (farm.srv_state == SrvState.IDLE)
    n_act = (pool == 0).sum(dim=-1, dtype=I32)
    sleep_score = torch.where(idle_active, server_load(farm, cfg).to(F32),
                              BIG)
    cand_s = torch.argmin(sleep_score, dim=-1)
    do_sleep = want_sleep & idle_active.any(dim=-1) & (n_act > 1) & ~do_wake
    pool = torch.where((ar == lift(cand_s)) & lift(do_sleep), 1,
                       pool).to(I32)
    return replace(farm, srv_pool=pool)


def timer_transitions(farm: ServerFarm, cfg: SimConfig, now):
    """Local power controllers: move IDLE servers whose delay timer expired
    into their sleep state (paper §IV-B/C)."""
    if cfg.sleep_policy == SleepPolicy.ALWAYS_ON:
        return farm
    idle = farm.srv_state == SrvState.IDLE
    # the same expression next_timer_event emits (a rewrite as
    # now - idle_since >= tau loses an ulp and livelocks)
    now = lift(now)
    expired = idle & (now >= farm.srv_idle_since + farm.srv_tau)
    if cfg.sleep_policy == SleepPolicy.WASP:
        # active pool: shallow PkgC6 on idle; sleep pool: PkgC6, then S3
        # after tau in PkgC6
        new_state = torch.where(idle, SrvState.PKG_C6, farm.srv_state)
        in_c6 = farm.srv_state == SrvState.PKG_C6
        to_s3 = in_c6 & (farm.srv_pool == 1) \
            & (now >= farm.srv_idle_since + farm.srv_tau)
        new_state = torch.where(to_s3, SrvState.S3, new_state)
        return replace(farm, srv_state=new_state.to(I32))

    # SINGLE_TIMER / DUAL_TIMER: idle --tau--> cfg.sleep_state; disabled
    # (provisioned-away) servers sleep immediately
    expired = expired | (idle & ~farm.srv_enabled)
    new_state = torch.where(expired, cfg.sleep_state, farm.srv_state)
    return replace(farm, srv_state=new_state.to(I32))


def next_timer_event(farm: ServerFarm, cfg: SimConfig):
    """Earliest pending delay-timer expiry (batch-shaped; INF if none)."""
    tdt = cfg.time_dtype
    dev = farm.srv_state.device
    if cfg.sleep_policy == SleepPolicy.ALWAYS_ON:
        return torch.full((), INF, dtype=tdt, device=dev)
    idle = farm.srv_state == SrvState.IDLE
    due = farm.srv_idle_since + farm.srv_tau
    t = torch.where(idle, due, INF)
    if cfg.sleep_policy == SleepPolicy.WASP:
        in_c6 = (farm.srv_state == SrvState.PKG_C6) & (farm.srv_pool == 1)
        t = torch.minimum(t, torch.where(in_c6, due, INF))
    return t.amin(dim=-1).to(tdt)
