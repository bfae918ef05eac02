"""Server model primitives (paper §III-A), port of ``repro.core.server``.

Each server has C cores (one task per core), a local FIFO queue and an ACPI
power state.  Queues are task-major: a queued task has ``status ==
QUEUED`` and its FIFO position is the global ``enqueue_seq`` stamp it got
on push; the farm keeps a per-server occupancy counter (``q_len``) and the
global stamp counter (``q_seq``).  Every operation is dense and masked over
the whole farm, with no data-dependent shapes, so nothing here waits for
the device.

Scatters with a drop sentinel (``.at[i].set(..., mode="drop")`` in the
reference) write into a buffer one column longer than the target and slice
the sentinel column off (``types.set_drop``).

Every function takes states with a leading batch shape (``()`` for one
run, ``(R,)`` for a replica batch): reductions, ranks and gathers run
along the trailing server, core and task axes.

The scalar primitives (``queue_push``, ``begin_wake``), which the seed
hot loops call (``SimConfig(use_vectorized_hot_loop=False)``), take one
server index and one task id a replica and a ``mask`` in place of the
reference's ``lax.cond``: where it is false every leaf is returned bit for
bit as it came in.
"""
from __future__ import annotations

import torch

from ..kernels.ref import _const, _fma, div_const, inv_f32
from .types import (INF, JobTable, ServerFarm, SimConfig, SrvState,
                    TaskStatus, lift, replace, set_drop, take)

__all__ = ["queue_push", "queue_push_many", "queued_rank", "compact_mask",
           "try_start", "wake_latency", "begin_wake", "begin_wake_mask",
           "refresh_idle_state"]

I32 = torch.int32
I64 = torch.int64


def queue_push(farm: ServerFarm, cfg: SimConfig, server, tid, mask=None):
    """Push one task onto ``server``'s queue: ``server``/``tid`` (*B,)
    int32, ``mask`` (*B,) bool or None (all true).  A full queue adds 0 to
    ``q_len`` and ``q_seq`` and 1 to ``dropped``.  Returns (farm, ok,
    seq): ``ok`` is "the queue had room" (read only where ``mask``), and
    ``seq`` the counter before the push, the FIFO stamp the caller writes
    into ``jobs.enqueue_seq[tid]`` when ok (int32, wrapping as XLA's
    does)."""
    s = server.clamp(min=0).to(I64)[..., None]
    full = take(farm.q_len, s)[..., 0] >= cfg.local_q
    push, drop = ~full, full
    if mask is not None:
        push, drop = push & mask, drop & mask
    return (replace(farm,
                    q_len=farm.q_len.scatter_add(-1, s,
                                                 push.to(I32)[..., None]),
                    q_seq=farm.q_seq + push.to(I32),
                    dropped=farm.dropped + drop.to(I32)),
            ~full, farm.q_seq)


def queue_push_many(farm: ServerFarm, cfg: SimConfig, servers, tids, valid):
    """Push up to K tasks onto their servers' queues in one pass.

    servers/tids (*B, K) int32, valid (*B, K) bool.  Tasks bound for the
    same server take FIFO stamps in position order; once a queue fills,
    later same-server tasks drop.  Returns (farm, ok (*B, K) bool, seq
    (*B, K) int32)."""
    K = tids.shape[-1]
    Q = cfg.local_q
    s = servers.clamp(min=0).to(I64)
    pos = torch.arange(K, device=tids.device)
    same = valid[..., None, :] & valid[..., :, None] \
        & (s[..., None, :] == s[..., :, None])
    rank = (same & (pos[None, :] < pos[:, None])).sum(dim=-1, dtype=I32)
    ok = valid & (take(farm.q_len, s) + rank < Q)
    seq = lift(farm.q_seq) + torch.cumsum(ok.to(I32), -1, dtype=I32) - 1
    # a refused push adds 0; duplicate servers accumulate
    q_len = farm.q_len.scatter_add(-1, s, ok.to(I32))
    q_seq = farm.q_seq + ok.sum(dim=-1, dtype=I32)
    dropped = farm.dropped + (valid & ~ok).sum(dim=-1, dtype=I32)
    return (replace(farm, q_len=q_len, q_seq=q_seq, dropped=dropped),
            ok, seq.to(I32))


def wake_latency(cfg: SimConfig, state):
    """Wake latency of each server's state (time dtype)."""
    sp = cfg.server_power
    tdt = cfg.time_dtype
    lat = torch.zeros(state.shape, dtype=tdt, device=state.device)
    lat = torch.where(state == SrvState.OFF, sp.t_wake_off, lat)
    lat = torch.where(state == SrvState.S3, sp.t_wake_s3, lat)
    return torch.where(state == SrvState.PKG_C6, sp.t_wake_pkg_c6, lat)


def begin_wake(farm: ServerFarm, cfg: SimConfig, server, now, mask=None):
    """Start waking ``server`` ((*B,) int32) if it is in a sleep state:
    ``begin_wake_mask`` on that one server; idempotent.  ``mask`` (*B,)
    bool or None (all true)."""
    hit = torch.arange(cfg.n_servers, device=server.device) == lift(server)
    if mask is not None:
        hit = hit & lift(mask)
    return begin_wake_mask(farm, cfg, hit, now)


def begin_wake_mask(farm: ServerFarm, cfg: SimConfig, mask, now):
    """Start waking every sleeping server in ``mask`` (*B, N); idempotent."""
    st = farm.srv_state
    sleeping = mask & ((st == SrvState.PKG_C6) | (st == SrvState.S3)
                       | (st == SrvState.OFF))
    lat = wake_latency(cfg, st)
    return replace(
        farm,
        srv_state=torch.where(sleeping, SrvState.WAKING, st).to(I32),
        srv_wake_at=torch.where(sleeping, lift(now) + lat, farm.srv_wake_at),
        wake_count=farm.wake_count + sleeping.to(I32))


def queued_rank(jobs: JobTable, cfg: SimConfig, queued, q_seq):
    """(*B, JT) FIFO rank of each queued task among the queued tasks of
    its server (0 = head), by enqueue_seq; garbage where ~queued.

    Two stable argsorts give the lexicographic (server, seq) order; stamps
    sort by their wrap-safe int32 distance to the current counter
    ``q_seq`` (the reference's wrap-around argument)."""
    JT = queued.shape[-1]
    B = queued.shape[:-1]
    N = cfg.n_servers
    dev = queued.device
    srv = jobs.server.clamp(min=0)
    imax = torch.iinfo(I32).max
    rel_seq = jobs.enqueue_seq - lift(q_seq)     # wrap-safe, < 0 for live
    by_seq = torch.argsort(torch.where(queued, rel_seq, imax), dim=-1,
                           stable=True)
    q_s, srv_s = take(queued, by_seq), take(srv, by_seq)
    order = take(by_seq, torch.argsort(torch.where(q_s, srv_s, imax),
                                       dim=-1, stable=True))
    srv_o = torch.where(take(queued, order), take(srv, order), N)
    ar = torch.arange(JT, dtype=I32, device=dev).expand(B + (JT,))
    first = torch.full(B + (N + 1,), JT, dtype=I32, device=dev)\
        .scatter_reduce(-1, srv_o.to(I64), ar, reduce="amin")[..., :N]
    rank_o = ar - take(first, srv_o.clamp(0, N - 1))
    return torch.zeros(B + (JT,), dtype=I32, device=dev).scatter(
        -1, order, rank_o)


def compact_mask(mask, K: int):
    """The first K set task ids of ``mask`` (*B, JT) in a (*B, K) batch in
    ascending id order: one cumsum and one K-slot scatter.  Returns (tids
    (*B, K) int32, -1 in an empty slot; valid (*B, K); covered (*B,),
    true iff the batch holds every set task)."""
    JT = mask.shape[-1]
    r = torch.cumsum(mask, -1, dtype=I32) - 1
    tids = set_drop(torch.full(mask.shape[:-1] + (K,), -1, dtype=I32,
                               device=mask.device),
                    torch.where(mask & (r < K), r, K),
                    torch.arange(JT, dtype=I32, device=mask.device))
    return tids, tids >= 0, r[..., -1] < K


def _end_at(now, service, core_freq: float, dtype):
    """``now + service / core_freq`` as the reference's compiled step
    rounds it: XLA turns the division by the constant into a
    multiplication by its float32 reciprocal (``div_const``), and on a
    float32 clock contracts that product and the addition into one FMA.
    At ``core_freq`` 1 the product is exact, so the plain sum is the same
    value."""
    if core_freq == 1.0 or now.dtype == torch.float64:
        return (now + div_const(service, core_freq).to(now.dtype)).to(dtype)
    return _fma(service, _const(inv_f32(core_freq), service), now,
                torch.float32).to(dtype)


def try_start(farm: ServerFarm, cfg: SimConfig, jobs: JobTable, now,
              freq=None):
    """Start as many queued tasks as there are free cores, FIFO per server,
    in one task-space pass: a queued task starts iff its per-server FIFO
    rank is below its server's count of starts.  The reference switches
    between a compact pairwise rank and the full argsort rank at run time;
    both define the same rank, and the port always takes the argsort.
    Returns (farm, jobs)."""
    N, C = cfg.n_servers, cfg.n_cores
    JT = jobs.status.shape[-1]
    B = jobs.status.shape[:-1]
    dev = jobs.status.device
    tdt = jobs.task_end.dtype
    awake = (farm.srv_state == SrvState.ACTIVE) \
        | (farm.srv_state == SrvState.IDLE)
    free = farm.core_busy_until >= INF                       # (*B, N, C)
    n_free = free.sum(dim=-1, dtype=I32)
    n_start = torch.where(awake, torch.minimum(n_free, farm.q_len),
                          0).to(I32)

    queued = jobs.status == TaskStatus.QUEUED
    rank = queued_rank(jobs, cfg, queued, farm.q_seq)
    srv = jobs.server.clamp(min=0).to(I64)
    # task side: elementwise
    start_t = queued & (rank < take(n_start, srv))            # (*B, JT)
    now_t = lift(now)
    if freq is None:
        end_t = _end_at(now_t, jobs.service, cfg.core_freq, tdt)
    else:
        end_t = (now_t + (jobs.service / take(freq, srv)).to(now.dtype)
                 ).to(tdt)
    status = torch.where(start_t, TaskStatus.RUNNING, jobs.status).to(I32)
    task_end = torch.where(start_t, end_t, jobs.task_end)
    start_at = torch.where(start_t, now_t.to(jobs.start_at.dtype),
                           jobs.start_at)
    jobs = replace(jobs, status=status, task_end=task_end, start_at=start_at)

    # core side: the r-th starting task of server s takes the r-th free
    # core; a (server, rank) -> task table (sentinel row N) fills the cores
    row = torch.where(start_t, srv, N)
    col = torch.where(start_t, rank, 0).clamp(0, C - 1).to(I64)
    tid_at = torch.full(B + ((N + 1) * C,), JT, dtype=I32,
                        device=dev).scatter(
        -1, row * C + col,
        torch.arange(JT, dtype=I32, device=dev).expand(B + (JT,)))
    tid_at = tid_at[..., :N * C].unflatten(-1, (N, C))
    fr = torch.cumsum(free, dim=-1, dtype=I32) - 1              # free rank
    start_c = free & (fr < n_start[..., None])                  # (*B, N, C)
    tid_c = torch.gather(tid_at, -1, fr.clamp(0, C - 1).to(I64))
    svc_c = take(jobs.service, tid_c.clamp(0, JT - 1))
    cdt = farm.core_busy_until.dtype
    if freq is None:
        busy_until = _end_at(lift(now, 2), svc_c, cfg.core_freq, cdt)
    else:
        busy_until = (lift(now, 2) + (svc_c / freq[..., None]).to(now.dtype)
                      ).to(cdt)
    farm = replace(
        farm,
        core_busy_until=torch.where(start_c, busy_until,
                                    farm.core_busy_until),
        q_len=farm.q_len - n_start)
    return farm, jobs


def refresh_idle_state(farm: ServerFarm, cfg: SimConfig, now):
    """Recompute ACTIVE/IDLE for awake servers; stamp idle_since on the
    ACTIVE->IDLE edge (the delay-timer anchor)."""
    busy = (farm.core_busy_until < INF).any(dim=-1)
    awake = (farm.srv_state == SrvState.ACTIVE) \
        | (farm.srv_state == SrvState.IDLE)
    new_state = torch.where(
        awake, torch.where(busy, SrvState.ACTIVE, SrvState.IDLE),
        farm.srv_state).to(I32)
    went_idle = awake & (farm.srv_state == SrvState.ACTIVE) & ~busy
    idle_since = torch.where(went_idle, lift(now), farm.srv_idle_since)
    return replace(farm, srv_state=new_state, srv_idle_since=idle_since)
