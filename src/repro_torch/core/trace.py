"""Device-side event flight recorder, port of ``repro.core.trace``.

A fixed-capacity ring in ``SimState.trace``, written from inside the
engine's passes -- the cheap macro-step passes and the full step -- so the
recorded stream is the same for every ``events_per_step``.  Each record is
(kind, time, server, tid, aux); ``types.TraceKind`` lists the kinds and
their payloads.

Emission is two-phase, as in the reference.  Every site :func:`stage`\\ s
its records -- a Python list of (mask, kind, payload) tuples, no device
work -- and the pass :func:`flush`\\ es them once.  The reference's flush
loops over 16-record batches on a device count; here one fixed-shape pass
writes them all, with no host read, so a macro-step never waits for the
device:

  1. the staged masks are concatenated into one (L,) lane vector; an
     int32 cumsum gives every set lane its rank r and the pass's count n;
  2. lane r goes to slot (ptr + r) % cap when r >= n - cap -- the last
     cap records of the pass, whose slots are distinct -- and every other
     lane to a sentinel row past the ring, so no two lanes that count
     write one slot and the result cannot depend on the order in which
     the card scatters;
  3. the payloads are concatenated into an (L, 5) row matrix and written
     with one ``scatter_``.

This equals the reference's batches, in which a later rank overwrites an
earlier one, whenever ``cap >= 16`` (below that the reference writes
duplicate slots within one batch and its own result is unspecified).

The ring is written in place.  ``TraceState.buf`` is the first ``cap``
rows of a (cap + 1, 5) tensor whose last row is the sentinel; the engine
copies the ring once when a run or a step begins (:func:`own`), so a
caller's state is never modified.  A cheap pass that the macro-step
discards must write nothing: the engine ANDs every staged mask with the
pass's ``alive`` flag, so a closed pass counts n = 0 and writes only the
sentinel.  Every emission site sits behind a Python-level ``if
cfg.trace.enabled:``, so a disabled recorder adds no work to the step and
its (1, 5) placeholder never changes.

``ptr`` is monotonic (slot = ptr % cap) and the records overwritten by
wrap-around are counted in ``dropped``.  Host-side decoding and export
live in ``core/traceio.py``.

A replica batch (``core/montecarlo.py``) keeps one ring a replica, as the
reference does: ``buf`` is (R, cap, 5), the first ``cap`` rows of each
replica's (cap + 1, 5) block, and ``ptr``/``dropped`` are (R,).  The
cumsum ranks each replica's lanes, and the one write scatters every
replica's rows into its own block, so frozen replicas (their ``alive``
false) write only their sentinels.  A user decodes replica r's ring
(``TraceState(buf[r], ptr[r], dropped[r])``).
"""
from __future__ import annotations

import math

import torch

from .types import SimConfig, TraceKind, TraceState, replace

__all__ = ["init_trace", "own", "stage", "stage1", "flush"]

I32 = torch.int32
I64 = torch.int64


def init_trace(cfg: SimConfig, device) -> TraceState:
    """A fresh ring of ``-1`` records in the clock's dtype (at least
    float32); the (1, 5) placeholder when the recorder is off."""
    dt = torch.promote_types(cfg.time_dtype, torch.float32)
    if cfg.trace.enabled:
        cap = cfg.trace.capacity
        buf = torch.full((cap + 1, 5), -1.0, dtype=dt, device=device)[:cap]
    else:
        buf = torch.full((1, 5), -1.0, dtype=dt, device=device)
    return TraceState(buf=buf,
                      ptr=torch.zeros((), dtype=I32, device=device),
                      dropped=torch.zeros((), dtype=I32, device=device))


def _ring_strides(batch: tuple, cap: int) -> tuple:
    """Strides of a contiguous (*batch, cap + 1, 5) ring."""
    strides, n = [5, 1], (cap + 1) * 5
    for b in reversed(batch):
        strides.insert(0, n)
        n *= b
    return tuple(strides)


def _ring(buf: torch.Tensor, cap: int) -> torch.Tensor:
    """The (*B, cap + 1, 5) tensor whose first ``cap`` rows (in each
    replica's block) are ``buf``."""
    batch = tuple(buf.shape[:-2])
    full = batch + (cap + 1, 5)
    if not (tuple(buf.shape[-2:]) == (cap, 5)
            and buf.stride() == _ring_strides(batch, cap)
            and buf.storage_offset() == 0
            and buf.untyped_storage().nbytes()
            >= math.prod(full) * buf.element_size()):
        raise ValueError("trace.flush writes a ring made by init_trace or "
                         "own, with its sentinel row behind it")
    return buf.as_strided(full, _ring_strides(batch, cap))


def own(tr: TraceState, cfg: SimConfig) -> TraceState:
    """``tr`` with its ring (one a replica) copied into a fresh (*B, cap +
    1, 5) tensor, which :func:`flush` then writes in place."""
    cap = cfg.trace.capacity
    batch = tuple(tr.buf.shape[:-2])
    ring = torch.empty(batch + (cap + 1, 5), dtype=tr.buf.dtype,
                       device=tr.buf.device)
    ring[..., :cap, :].copy_(tr.buf)
    return replace(tr, buf=ring[..., :cap, :])


def stage(records: list, mask, kind: int, server=None, tid=None,
          aux=None) -> None:
    """Queue one record per set lane of ``mask`` ((*B, M) bool) for the
    pass's flush.  ``server``/``tid``/``aux`` are (*B, M) or (M,)
    tensors, 0-d tensors or Python numbers (broadcast at flush time);
    ``None`` takes the column's default (-1, -1, 0).  Records land in the
    ring in stage-call order, ascending lane within each call."""
    records.append((mask, int(kind), server, tid, aux))


def stage1(records: list, pred, kind: int, server=-1, tid=-1,
           aux=0.0) -> None:
    """Queue a single record when the batch-shaped ``pred`` holds."""
    stage(records, pred[..., None], kind, server, tid, aux)


def _column(parts, consts, dt, dev, batch) -> torch.Tensor:
    """One (*B, L) payload column from each record's (payload, M,
    default).  -1 and the kind values are views of ``consts`` (``consts[v
    + 1] == v``), so a constant payload launches nothing; tensors are
    cast by the concatenation's type promotion, then once to the ring's
    dtype."""
    cols = []
    for p, m, default in parts:
        if p is None:
            p = default
        if isinstance(p, torch.Tensor):
            cols.append(p.expand(batch + (m,)))
        elif float(p).is_integer() and -1 <= p < TraceKind.NUM:
            cols.append(consts[int(p) + 1].expand(batch + (m,)))
        else:
            cols.append(torch.full(batch + (m,), float(p), dtype=dt,
                                   device=dev))
    return torch.cat(cols, dim=-1).to(dt)


def flush(tr: TraceState, cfg: SimConfig, t, records: list,
          alive=None) -> TraceState:
    """Write one pass's staged records to the ring, in place (see the
    module note); ``alive`` (batch-shaped bool) keeps each replica's
    records only while it holds.  The returned state shares ``tr``'s
    ring, which ``init_trace`` or ``own`` made.  Callers hold ``cfg.trace.enabled``
    true."""
    if not records:
        return tr
    cap = cfg.trace.capacity
    ring = _ring(tr.buf, cap)
    buf = tr.buf
    dt, dev = buf.dtype, buf.device
    batch = tuple(tr.ptr.shape)
    sizes = [r[0].shape[-1] for r in records]
    mask = torch.cat([r[0] for r in records], dim=-1)         # (*B, L)
    if alive is not None:
        mask = mask & alive[..., None]
    count = torch.cumsum(mask, -1, dtype=I32)         # rank + 1 on set lanes
    n = count[..., -1]
    # the last cap records of the pass survive, each in its own slot
    keep = mask & (count > (n - cap)[..., None])
    slot = torch.where(keep, (count + (tr.ptr - 1)[..., None]) % cap,
                       cap).to(I64)
    consts = torch.arange(-1, TraceKind.NUM, dtype=dt, device=dev)
    kinds = torch.cat([consts[r[1] + 1].expand(batch + (m,))
                       for r, m in zip(records, sizes)], dim=-1)
    cols = [_column([(r[c], m, d) for r, m in zip(records, sizes)],
                    consts, dt, dev, batch)
            for c, d in ((2, -1), (3, -1), (4, 0))]
    rows = torch.stack([kinds, t.to(dt)[..., None].expand(kinds.shape),
                        *cols], dim=-1)                    # (*B, L, 5)
    ring.scatter_(-2, slot[..., None].expand(rows.shape), rows)
    new_ptr = tr.ptr + n
    over = (new_ptr - cap).clamp(min=0) - (tr.ptr - cap).clamp(min=0)
    return TraceState(buf=buf, ptr=new_ptr, dropped=tr.dropped + over)
