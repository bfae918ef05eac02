"""The rebuild sentinel, counterpart of ``repro.analysis.retrace``: a
second build for an identical key is a bug.

The port traces and compiles nothing; what it builds once per key and then
reuses is the kernel libraries (``kernels.build.load``, keyed by the
library's path, a hash of its source and flags), the engine kernels'
per-device scratch words (``dcsim_step.scratch``, keyed by device, clock
and batch size; ``telemetry_bin.scratch``, by device, bins and batch
size).  The ``repro_torch::`` op registrations (``kernels/ops.py``) run
once a process, at import, and torch itself refuses a second.  A silent
miss -- a key that stops hashing stably, a cache dropped between calls --
costs a rebuild or a fresh allocation a call, which a benchmark sees only
as noise.

Each of those caches counts its misses in ``kernels.build.MISSES``.
:func:`build_guard` reads the counts that rose inside it: run the same
simulation twice inside the guard, and any key built more than once is a
named violation.
"""
from __future__ import annotations

import collections
import contextlib

from ..kernels import build


def _events(since: collections.Counter, min_builds: int) -> list:
    grown = build.MISSES - since
    return [{"tag": tag, "key": repr(key), "builds": n}
            for (tag, key), n in sorted(grown.items(),
                                        key=lambda kv: repr(kv[0]))
            if n >= min_builds]


@contextlib.contextmanager
def build_guard():
    """Count the builds made within the block; yields a callable that
    returns the keys built more than once so far (``rebuilt()``), or every
    key built with ``rebuilt(min_builds=1)``."""
    since = collections.Counter(build.MISSES)
    yield lambda min_builds=2: _events(since, min_builds)


def simulate_twice(rank, world, device=None):
    """The sentinel's runs, on a rank of a one-rank process group
    (``core.shard_sim.spawn``, a fresh process, so its kernel loads are
    its first): ``farm.simulate`` twice on the plain path and twice with
    ``mesh=`` under the guard.  Returns (rebuilt keys, every build)."""
    from ..core import farm, shard_sim, workload
    from ..core.jobs import dag_single
    from ..core.types import SimConfig

    cfg = SimConfig(n_servers=8, n_cores=2, max_jobs=32, max_events=5_000)
    arr = workload.poisson_arrivals(40.0, 10, seed=3)
    specs = [dag_single(0.02) for _ in range(10)]
    mesh = shard_sim.make_mesh(1, device=device)
    with build_guard() as rebuilt:
        for m in (None, mesh):           # engine.run, then run_sharded
            farm.simulate(cfg, arr, specs, device=device, mesh=m)
            farm.simulate(cfg, arr, specs, device=device, mesh=m)
        return rebuilt(), rebuilt(min_builds=1)


__all__ = ["build_guard", "simulate_twice"]
