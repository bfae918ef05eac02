"""Host-side decoding/export of the device trace ring (core/trace.py),
the port's copy of ``repro.core.traceio``.

Every state leaf it reads may be a tensor on the card: :func:`_np` copies
it to the host once (the whole ring in one copy, never slot by slot).  The
module itself imports numpy and the port's ``types`` only.

Four consumers of one record stream:

  * :func:`decode` — ring buffer -> chronological numpy event array.
  * :func:`lifecycle_spans` — per-task queued->running->finish spans on
    server tracks (using the ``JobTable.start_at`` stamp).
  * :func:`to_chrome_trace` — Chrome trace event format JSON, loadable in
    Perfetto / chrome://tracing: rows are servers grouped into rack
    processes, task executions are duration events, wakeups/crossings/
    ctrl ticks/deferral releases are instants, and queue depth / farm
    power counter tracks come from the telemetry windows.
  * :func:`critical_path` — which task chain bounded each job's latency,
    split into queueing vs service vs flow time.

Plus the debugging workhorse :func:`diff_traces`: the engine emits all
same-time events in one masked pass while the heapq oracle interleaves
them, and engine times are f32 against the oracle's f64 — so both streams
are put in a canonical order (time-clustered, then by kind/tid/server)
and compared with a time tolerance, reporting the FIRST diverging event
instead of a final-state pytree mismatch.
"""
from __future__ import annotations

import json

import numpy as np

from .types import INF, SimConfig, TraceKind

__all__ = ["EVENT_DTYPE", "decode", "as_events", "diff_traces",
           "lifecycle_spans", "critical_path", "to_chrome_trace",
           "save_chrome_trace"]

EVENT_DTYPE = np.dtype([("time", np.float64), ("kind", np.int32),
                        ("server", np.int32), ("tid", np.int32),
                        ("aux", np.float32)])


def _np(x, dtype=None) -> np.ndarray:
    """A state leaf as a numpy array; a tensor, on the card or the CPU, is
    copied to the host in one transfer."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def decode(trace, cfg: SimConfig):
    """TraceState -> (events (n,) EVENT_DTYPE chronological, n_dropped).

    The ring holds the most recent min(ptr, capacity) records; wrap-around
    discards the oldest (counted in ``dropped``)."""
    cap = cfg.trace.capacity
    ptr = int(trace.ptr)
    n = min(ptr, cap)
    idx = (ptr - n + np.arange(n)) % cap
    buf = _np(trace.buf, np.float64)[idx]          # rows [kind, time,
    ev = np.empty((n,), EVENT_DTYPE)               #  server, tid, aux]
    ev["kind"] = buf[:, 0].astype(np.int32)
    ev["time"] = buf[:, 1]
    ev["server"] = buf[:, 2].astype(np.int32)
    ev["tid"] = buf[:, 3].astype(np.int32)
    ev["aux"] = buf[:, 4].astype(np.float32)
    return ev, int(trace.dropped)


def as_events(records) -> np.ndarray:
    """List of (time, kind, server, tid, aux) tuples (the oracle's
    ``trace`` list) -> EVENT_DTYPE array."""
    ev = np.empty((len(records),), EVENT_DTYPE)
    for i, (t, k, s, tid, aux) in enumerate(records):
        ev[i] = (t, k, s, tid, aux)
    return ev


# ==========================================================================
# trace diffing
# ==========================================================================

def _canonical(ev: np.ndarray, tol: float) -> np.ndarray:
    """Stable canonical order: cluster events whose times are within
    ``tol`` of their neighbors, then sort each cluster by (kind, tid,
    server).  Within-instant emission order (one masked engine pass vs
    the oracle's event-by-event pops) stops mattering; genuinely distinct
    times keep their order."""
    if len(ev) == 0:
        return ev
    ev = ev[np.lexsort((ev["server"], ev["tid"], ev["kind"], ev["time"]))]
    new_cluster = np.empty(len(ev), bool)
    new_cluster[0] = True
    new_cluster[1:] = np.diff(ev["time"]) > tol
    cid = np.cumsum(new_cluster)
    return ev[np.lexsort((ev["server"], ev["tid"], ev["kind"], cid))]


def _fmt(e) -> str:
    k = int(e["kind"])
    name = TraceKind.NAMES[k] if 0 <= k < TraceKind.NUM else f"?{k}"
    return (f"kind={name} time={float(e['time']):.9g} "
            f"server={int(e['server'])} tid={int(e['tid'])} "
            f"aux={float(e['aux']):.6g}")


def diff_traces(a, b, time_tol: float = 1e-4, check_tid: bool = True,
                check_aux: bool = False, names=("engine", "oracle")):
    """Compare two event streams; return None when they match, else a
    human-readable message locating the FIRST divergence.

    ``a``/``b`` are EVENT_DTYPE arrays (from :func:`decode` /
    :func:`as_events`).  Events match when kind and server agree exactly,
    times agree within ``time_tol`` (engine f32 vs oracle f64), and —
    optionally — tid/aux agree.  Streams are canonicalized first (see
    :func:`_canonical`) so same-instant emission order is immaterial.
    """
    a = _canonical(np.asarray(a, EVENT_DTYPE), time_tol)
    b = _canonical(np.asarray(b, EVENT_DTYPE), time_tol)
    n = min(len(a), len(b))
    for i in range(n):
        ea, eb = a[i], b[i]
        bad = (int(ea["kind"]) != int(eb["kind"])
               or int(ea["server"]) != int(eb["server"])
               or abs(float(ea["time"]) - float(eb["time"])) > time_tol)
        if not bad and check_tid:
            bad = int(ea["tid"]) != int(eb["tid"])
        if not bad and check_aux:
            bad = not np.isclose(ea["aux"], eb["aux"], rtol=1e-3,
                                 atol=1e-5)
        if bad:
            return (f"first divergence: event #{i}: "
                    f"{names[0]} ({_fmt(ea)}) vs {names[1]} ({_fmt(eb)})")
    if len(a) != len(b):
        longer, which = (a, names[0]) if len(a) > len(b) else (b, names[1])
        return (f"first divergence: event #{n}: {which} has "
                f"{abs(len(a) - len(b))} extra event(s), starting with "
                f"({_fmt(longer[n])})")
    return None


# ==========================================================================
# lifecycle spans + critical path
# ==========================================================================

def _task_timing(events: np.ndarray, state, cfg: SimConfig):
    """Per-task (ready, start, finish, binding-pred, flow-wait) from the
    final JobTable plus the trace's ADMIT/FLOW_FINISH events.

    ``ready`` is when the task could first run: its job's admission for
    roots, the latest dependency resolution (parent finish, or flow
    delivery for network edges) otherwise.  ``pred``/``flow_wait`` record
    WHICH edge bound that maximum and how much of it was flow time — the
    critical-path links."""
    jobs = state.jobs
    T = cfg.tasks_per_job
    start = _np(jobs.start_at, np.float64)
    finish = _np(jobs.finish, np.float64)
    valid = _np(jobs.valid)
    server = _np(jobs.server)
    children = _np(jobs.children)
    eb = _np(jobs.edge_bytes)
    JT = start.shape[0]

    admit = {}
    for e in events[events["kind"] == TraceKind.ADMIT]:
        admit[int(e["tid"])] = float(e["time"])
    flow_at = {}                     # child tid -> latest flow delivery
    for e in events[events["kind"] == TraceKind.FLOW_FINISH]:
        c = int(e["tid"])
        flow_at[c] = max(flow_at.get(c, -np.inf), float(e["time"]))

    ready = np.full(JT, np.nan)
    pred = np.full(JT, -1, np.int64)
    flow_wait = np.zeros(JT)
    arrival = _np(jobs.arrival, np.float64)
    # roots = tasks no edge points at (final dep_count is 0 for every
    # resolved task, so it cannot distinguish roots)
    has_parent = np.zeros(JT, bool)
    for p in range(JT):
        if valid[p]:
            for c in children[p]:
                if c >= 0:
                    has_parent[c] = True
    is_root = ~has_parent
    # roots: admission time (fall back to arrival when the ADMIT event
    # was wrapped out of the ring)
    for t in range(JT):
        if valid[t]:
            j = t // T
            ready[t] = admit.get(j, arrival[j])
    for p in range(JT):
        if not valid[p] or finish[p] >= INF / 2:
            continue
        for k in range(children.shape[1]):
            c = int(children[p, k])
            if c < 0:
                continue
            is_flow = (cfg.has_network and eb[p, k] > 0
                       and server[p] != server[c])
            t_edge = flow_at.get(c, finish[p]) if is_flow else finish[p]
            if np.isnan(ready[c]) or t_edge > ready[c] \
                    or (pred[c] < 0 and not is_root[c]):
                ready[c] = t_edge
                pred[c] = p
                flow_wait[c] = max(t_edge - finish[p], 0.0) if is_flow \
                    else 0.0
    return ready, start, finish, pred, flow_wait


def lifecycle_spans(events: np.ndarray, state, cfg: SimConfig):
    """Per-task lifecycle spans: queued [ready, start) then running
    [start, finish) on the task's server track.  Tasks that never started
    (dropped / unfinished run) are skipped."""
    ready, start, finish, _, _ = _task_timing(events, state, cfg)
    valid = _np(state.jobs.valid)
    server = _np(state.jobs.server)
    T = cfg.tasks_per_job
    spans = []
    for t in range(len(start)):
        if not valid[t] or start[t] >= INF / 2:
            continue
        end = finish[t] if finish[t] < INF / 2 else start[t]
        spans.append({
            "tid": t, "job": t // T, "server": int(server[t]),
            "queued": (float(ready[t]), float(start[t])),
            "running": (float(start[t]), float(end)),
        })
    return spans


def critical_path(events: np.ndarray, state, cfg: SimConfig):
    """Walk each finished job's binding dependency chain backwards from
    its last-finishing task, splitting the job latency into queueing
    (ready -> start), service (start -> finish), and flow (network
    delivery) time along the path."""
    ready, start, finish, pred, flow_wait = _task_timing(events, state,
                                                         cfg)
    jobs = state.jobs
    T = cfg.tasks_per_job
    valid = _np(jobs.valid).reshape(-1, T)
    job_finish = _np(jobs.job_finish, np.float64)
    arrival = _np(jobs.arrival, np.float64)
    out = []
    for j in range(len(job_finish)):
        if job_finish[j] >= INF / 2:
            continue
        tids = [j * T + k for k in range(T) if valid[j, k]]
        t = max(tids, key=lambda i: (finish[i] if finish[i] < INF / 2
                                     else -np.inf))
        path, queueing, service, flow = [], 0.0, 0.0, 0.0
        while t >= 0:
            path.append(t)
            f = finish[t] if finish[t] < INF / 2 else start[t]
            if start[t] < INF / 2:
                service += f - start[t]
                queueing += max(start[t] - ready[t], 0.0)
            flow += flow_wait[t]
            t = int(pred[t])
        path.reverse()
        out.append({
            "job": j, "latency": float(job_finish[j] - arrival[j]),
            "path": path, "queueing": queueing, "service": service,
            "flow": flow,
        })
    return out


# ==========================================================================
# Chrome trace event format (Perfetto / chrome://tracing)
# ==========================================================================

_US = 1.0e6                           # trace timestamps are microseconds

_INSTANT_KINDS = (TraceKind.WAKEUP, TraceKind.SLEEP, TraceKind.RELEASE,
                  TraceKind.DROP, TraceKind.THROTTLE_CROSSING,
                  TraceKind.CTRL_TICK, TraceKind.FLOW_SPAWN,
                  TraceKind.FLOW_FINISH)


def to_chrome_trace(events: np.ndarray, cfg: SimConfig, state=None,
                    racks=None, n_dropped: int = 0) -> dict:
    """Event array -> Chrome trace event format dict (``json.dump`` it —
    or use :func:`save_chrome_trace` — and load in ui.perfetto.dev or
    chrome://tracing).

    Rows are servers (thread tracks) grouped into rack processes
    (``racks`` (N,) overrides the default ``i // thermal.rack_size``
    grouping); task executions become duration ("X") events via the
    START records + the final state's finish stamps, the remaining kinds
    become instant ("i") events, and — when ``state`` carries enabled
    telemetry — queue-depth and farm-power counter ("C") tracks are
    reconstructed from the windowed series.
    """
    N = cfg.n_servers
    if racks is None:
        rack_of = np.arange(N) // max(cfg.thermal.rack_size, 1)
    else:
        rack_of = np.asarray(racks)

    def pid_tid(srv):
        if srv < 0:
            return {"pid": -1, "tid": 0}        # farm-level track
        return {"pid": int(rack_of[srv]), "tid": int(srv)}

    out = [{"name": "process_name", "ph": "M", "pid": -1,
            "args": {"name": "farm"}}]
    for r in sorted(set(rack_of.tolist())):
        out.append({"name": "process_name", "ph": "M", "pid": int(r),
                    "args": {"name": f"rack {r}"}})
    for s in range(N):
        out.append({"name": "thread_name", "ph": "M",
                    "pid": int(rack_of[s]), "tid": s,
                    "args": {"name": f"server {s}"}})

    # task executions: START records paired with the finish stamps
    finish = None
    if state is not None:
        finish = _np(state.jobs.finish, np.float64)
    for e in events[events["kind"] == TraceKind.START]:
        t0 = float(e["time"])
        tid = int(e["tid"])
        if finish is not None and tid < len(finish) \
                and finish[tid] < INF / 2:
            dur = max(finish[tid] - t0, 0.0)
        else:
            dur = max(float(e["aux"]), 0.0)     # stamped duration
        out.append({"name": f"task {tid}", "cat": "task", "ph": "X",
                    "ts": t0 * _US, "dur": dur * _US,
                    **pid_tid(int(e["server"])),
                    "args": {"job": tid // cfg.tasks_per_job,
                             "task": tid}})

    for e in events[np.isin(events["kind"], _INSTANT_KINDS)]:
        k = int(e["kind"])
        srv = int(e["server"])
        out.append({"name": TraceKind.NAMES[k], "cat": "event",
                    "ph": "i", "ts": float(e["time"]) * _US,
                    "s": "t" if srv >= 0 else "g", **pid_tid(srv),
                    "args": {"tid": int(e["tid"]),
                             "aux": float(e["aux"])}})

    # counter tracks from the windowed telemetry
    if state is not None and cfg.telemetry.enabled:
        from . import telemetry as telem_mod
        win = _np(state.telem.win, np.float64)
        occ = win[:, telem_mod.WIN_OCC]
        tctr = (np.arange(cfg.telemetry.n_windows) + 0.5) \
            * cfg.telemetry.window_dt
        for w in np.nonzero(occ > 0)[0]:
            ts = tctr[w] * _US
            out.append({"name": "queue depth", "ph": "C", "pid": -1,
                        "ts": ts, "args": {"tasks": float(
                            win[w, telem_mod.WIN_QDEPTH] / occ[w])}})
            out.append({"name": "farm power", "ph": "C", "pid": -1,
                        "ts": ts, "args": {"watts": float(
                            win[w, telem_mod.WIN_SRV_POWER] / occ[w])}})

    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"n_servers": N, "n_events": int(len(events)),
                          "trace_dropped": int(n_dropped)}}


def save_chrome_trace(path: str, events: np.ndarray, cfg: SimConfig,
                      state=None, racks=None, n_dropped: int = 0) -> dict:
    doc = to_chrome_trace(events, cfg, state, racks, n_dropped)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc
