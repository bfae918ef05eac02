"""The graph audit: static analysis over the ops the engine's step really
dispatches, port of ``repro.analysis`` (simlint).

The reference audits traced jaxprs; the port has no traced program, so it
records one macro-step on real tensors under a ``TorchDispatchMode``, one
level below PyTorch's Python API, on the CPU or the card alike:

* :mod:`.graph_audit` -- ``record``: an :class:`~.graph_audit.Inventory`
  of every op with its source line and region (the engine's named
  regions, ``core/regions.py``, the counterpart of ``jax.named_scope``);
  ``clock_audit``: the clock-dtype taint through the recorded ops.
* :mod:`.rules` -- declarative rules (``ForbidOp``, ``ExactCount``,
  ``DtypePolicy``, ``NoNewOps``) diffed against a committed baseline
  (``baseline.json`` here) with explicit waivers.
* :mod:`.costmodel` -- bytes and operations per recorded op, a step's
  bound on the H100, and the state footprint sized on fake (meta)
  tensors.
* :mod:`.recompile` -- the rebuild sentinel: a second build of a kernel
  library or a per-key cache entry for an identical key is a failure
  (the caches count their misses in ``kernels.build.MISSES``).
* :mod:`.matrix` -- the audited configurations (every SchedPolicy,
  thermal off/tracking/throttling, trace on, the replica batch, sharded
  on 1/2/8 ranks, float64-clock twins).
* :mod:`.simlint` -- the ``python -m repro_torch.analysis.simlint`` CLI.

Imports torch and numpy only, and nothing here when the package itself is
imported: the engine and the kernels do not depend on it.
"""
