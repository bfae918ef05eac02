"""Named regions of the engine's step, the counterpart of the reference's
``jax.named_scope`` tags.

``with region("cheap_core"):`` pushes a name on a thread-local stack and
pops it on exit; the graph audit (``analysis/graph_audit.py``) tags every
op it records with the "/"-joined stack, so a rule can target "the
cheap-core passes" or "the thermal code" separately from the rest of the
step.  When nothing records, a region costs one push and one pop.

The engine marks five regions:

* ``cheap_core`` -- a cheap pass (``engine._consume_cheap``);
* ``full_step`` -- the full step (``engine._full_step``);
* ``f32_domain`` -- the declared exit from the clock into float32 physics
  (the interval's ``dt`` downcast in ``engine._advance_interval``): values
  downcast inside it are physics, not clocks, and carry no degraded-clock
  taint (``graph_audit.clock_audit``);
* ``thermal`` -- the thermal subsystem's calls;
* ``trace`` -- the flight recorder's flushes.

A recording on the CPU runs each kernel op's plain version inside
``kernel_ref/<name>``, so that a card recording (one ``repro_torch::`` op
a launch) and a CPU recording (the op and the plain version's ops below
it) fold onto each other (``graph_audit.Inventory.folded``).
"""
from __future__ import annotations

import threading

CHEAP_CORE = "cheap_core"
FULL_STEP = "full_step"
F32_DOMAIN = "f32_domain"
THERMAL = "thermal"
TRACE = "trace"
KERNEL_REF = "kernel_ref"

_LOCAL = threading.local()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def current() -> str:
    """The "/"-joined names of the regions entered on this thread ("" at
    the top)."""
    return "/".join(_stack())


class region:
    """``with region(name):`` -- tag what runs inside with ``name``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _stack().append(self.name)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


__all__ = ["region", "current", "CHEAP_CORE", "FULL_STEP", "F32_DOMAIN",
           "THERMAL", "TRACE", "KERNEL_REF"]
