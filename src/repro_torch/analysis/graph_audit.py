"""The op-level auditor, port of ``repro.analysis.jaxpr_audit``: an
inventory of every op one call dispatches, with region provenance, and the
clock-dtype taint through those ops.

The reference walks a traced jaxpr.  The port's step is eager, so
:func:`record` runs it once on real tensors under a ``TorchDispatchMode``
and writes down every op that reaches PyTorch's dispatcher, one level
below its Python API: an ``x[i] = v`` is ``aten.index_put_``, a
``bool(t)`` is ``aten._local_scalar_dense`` (the host sync), a gloo or
NCCL ``all_gather_into_tensor`` is ``c10d._allgather_base_`` and each of
the port's kernels is one ``repro_torch.<name>`` op (``kernels/ops.py``).
It records on the CPU and on the card alike.  Each op is tagged with the
engine's regions (``core/regions.py``) and with its source line, the
first frame under ``src/repro_torch/`` (outside this package and the
kernels' dispatch module), or the caller's own line when no frame of the
package is on the stack.

On the CPU a kernel op's plain version runs with the recording on, so its
ops are recorded too, inside ``kernel_ref/<name>``; :meth:`Inventory.folded`
drops them, which leaves the card's recording: one node a launch.

Two analyses share the recording:

* :func:`record` -- an :class:`Inventory`: op name, region, source,
  dtypes, shapes and bytes of every op; scatter, gather, collective,
  host-sync and kernel counts and per-region histograms come from it.
* :func:`clock_audit` -- forward taint from the declared time-valued
  state leaves (``TIME_LEAVES``).  A float output below ``time_dtype``
  computed from a time value outside ``f32_domain`` is DEGRADED; a
  DEGRADED value that reaches a time-valued output leaf is a
  clock-precision leak, reported with the downcast's source line.  Taint
  lives on storages, so an in-place op (``index_put_``, ``copy_``, any op
  whose schema writes an argument) taints the tensor it writes and every
  view of it, and a Python loop carries it because the recording sees the
  loop unrolled.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pathlib
import sys
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import regions
from ..core.regions import F32_DOMAIN, KERNEL_REF
from ..core.types import tree_leaves


class OpSet:
    """A set of op names (``"aten.index_put_"``) and op namespaces (every
    ``c10d.*`` op), less some excluded names.  ``in`` tests an op name;
    ``a - b`` excludes ``b``'s names from ``a``."""

    def __init__(self, names=(), namespaces=(), exclude=()):
        self.names = frozenset(names)
        self.namespaces = frozenset(namespaces)
        self.exclude = frozenset(exclude)

    def __contains__(self, op: str) -> bool:
        return op not in self.exclude and (
            op in self.names or op.split(".", 1)[0] in self.namespaces)

    def __sub__(self, other: "OpSet") -> "OpSet":
        return OpSet(self.names - other.names, self.namespaces,
                     self.exclude | other.names)

    def __iter__(self):
        return iter(sorted(self.names - self.exclude)
                    + [f"{ns}.*" for ns in sorted(self.namespaces)])

    def __repr__(self) -> str:
        return f"OpSet({list(self)})"


def as_opset(ops) -> OpSet:
    if isinstance(ops, OpSet):
        return ops
    if isinstance(ops, str):
        ops = {ops}
    return OpSet(ops)


def _both(*names) -> list:
    """Each name and its in-place form."""
    return [n for name in names for n in (f"aten.{name}", f"aten.{name}_")]


D2H, H2D = "[d2h]", "[h2d]"
COPY_OPS = frozenset({"aten._to_copy", "aten.copy_", "aten._copy_from",
                      "aten._copy_from_and_resize"})
SCATTER_OPS = OpSet(_both("index_put", "scatter", "scatter_add",
                          "scatter_reduce", "index_add", "index_copy",
                          "masked_scatter") + ["aten._index_put_impl_"])
GATHER_OPS = OpSet({"aten.gather", "aten.index", "aten.index_select",
                    "aten.take", "aten.embedding"})
# every op of torch.distributed's dispatcher namespaces
COLLECTIVE_OPS = OpSet(namespaces={"c10d", "_c10d_functional",
                                   "c10d_functional"})
ALL_GATHER_OPS = OpSet({"c10d._allgather_base_", "c10d.allgather_",
                        "c10d.allgather_coalesced_",
                        "c10d.allgather_into_tensor_coalesced_",
                        "_c10d_functional.all_gather_into_tensor",
                        "_c10d_functional.all_gather_into_tensor_coalesced"})
# ops that wait for the device and bring a value to the host (the
# reference's host callbacks): scalar reads, data-dependent output shapes,
# and any copy from the card to the host
HOST_SYNC_OPS = OpSet(
    {"aten._local_scalar_dense", "aten.item", "aten.is_nonzero",
     "aten.nonzero", "aten.masked_select", "aten.unique",
     "aten._unique", "aten._unique2", "aten.unique_consecutive",
     "aten.unique_dim", "aten.unique_dim_consecutive", "aten.equal",
     "aten.allclose", "aten.repeat_interleave.Tensor"}
    | {op + D2H for op in COPY_OPS})
KERNEL_NAMESPACE = "repro_torch"
KERNEL_OPS = OpSet(namespaces={KERNEL_NAMESPACE})
ANY_OP = OpSet(namespaces={"aten", "prims", "c10d", "_c10d_functional",
                           "c10d_functional", KERNEL_NAMESPACE})


@dataclasses.dataclass(frozen=True)
class Site:
    """One op occurrence: name, region provenance, source, and the
    dtypes, shapes and bytes the cost model reads."""

    op: str
    region: str                 # "/"-joined region names ("" = outer)
    src: str                    # "path:line (function)"
    dtypes: tuple = ()          # outputs' dtypes
    shapes: tuple = ()          # outputs' shapes
    in_dtypes: tuple = ()
    in_shapes: tuple = ()
    in_bytes: int = 0           # each input's distinct elements, once
    out_bytes: int = 0
    view: bool = False          # the op returns a view: moves no bytes

    def in_region(self, region: str) -> bool:
        return region in self.region.split("/")

    @property
    def folded_away(self) -> bool:
        """Inside a kernel's plain version (the CPU's view of one node)."""
        return KERNEL_REF in self.region.split("/")


@dataclasses.dataclass
class Inventory:
    """Flat per-op inventory of one recorded call; ``result`` is what the
    call returned."""

    sites: list
    result: object = dataclasses.field(default=None, repr=False)

    @property
    def n_ops(self) -> int:
        return len(self.sites)

    def count(self, ops, region: Optional[str] = None) -> int:
        return len(self.sites_of(ops, region))

    def sites_of(self, ops, region: Optional[str] = None) -> list:
        ops = as_opset(ops)
        return [s for s in self.sites
                if s.op in ops and (region is None or s.in_region(region))]

    def histogram(self) -> dict:
        """``{region: {op: count}}`` with the full region path as key."""
        out: dict = {}
        for s in self.sites:
            reg = out.setdefault(s.region, {})
            reg[s.op] = reg.get(s.op, 0) + 1
        return {r: dict(sorted(v.items())) for r, v in sorted(out.items())}

    def folded(self) -> "Inventory":
        """The inventory without the ops inside a kernel's plain version:
        each kernel one node, as the card records it."""
        return Inventory([s for s in self.sites if not s.folded_away],
                         self.result)

    def summary(self) -> dict:
        return {
            "ops": self.n_ops,
            "scatter": self.count(SCATTER_OPS),
            "scatter_cheap_core": self.count(SCATTER_OPS,
                                             regions.CHEAP_CORE),
            "gather": self.count(GATHER_OPS),
            "collectives": _by_op(self.sites_of(COLLECTIVE_OPS)),
            "host_syncs": self.count(HOST_SYNC_OPS),
            "host_to_device": sum(s.op.endswith(H2D) for s in self.sites),
            "kernels": _by_op(self.sites_of(KERNEL_OPS)),
        }


def _by_op(sites) -> dict:
    out: dict = {}
    for s in sites:
        out[s.op] = out.get(s.op, 0) + 1
    return dict(sorted(out.items()))


# --------------------------------------------------------------------------
# recording
# --------------------------------------------------------------------------

_PKG = pathlib.Path(__file__).resolve().parents[1]          # repro_torch/
_PKG_DIR = str(_PKG)
_ROOT = str(_PKG.parent) + os.sep                           # its parent
_HIDDEN = (str(_PKG / "analysis"), str(_PKG / "kernels" / "ops.py"))
_SKIP = (str(pathlib.Path(torch.__file__).resolve().parent),
         str(pathlib.Path(dataclasses.__file__).resolve().parent),
         _PKG_DIR, "<")                   # torch, the stdlib, the package


def _source(depth: int = 3) -> str:
    """The first frame under the package (outside this package and the
    kernels' dispatch), else the first frame outside torch and the
    standard library: "path:line (function)"."""
    f = sys._getframe(depth)
    outside = None
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG_DIR) and not fn.startswith(_HIDDEN):
            return f"{fn[len(_ROOT):]}:{f.f_lineno} ({f.f_code.co_name})"
        if outside is None and not fn.startswith(_SKIP):
            outside = f
        f = f.f_back
    if outside is None:
        return "<unknown>"
    return (f"{os.path.basename(outside.f_code.co_filename)}:"
            f"{outside.f_lineno} ({outside.f_code.co_name})")


def _tensors(tree) -> list:
    """The tensors in an op's (nested tuple/list/dict) arguments or
    outputs, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (an expanded axis counts once)."""
    strides = t.stride()
    if 0 not in strides:
        return t.numel() * t.element_size()
    n = math.prod(s for s, st in zip(t.shape, strides) if st != 0)
    return n * t.element_size() if t.numel() else 0


def op_name(func) -> str:
    """``aten.index_put_``: the op's namespace and name, without its
    overload, except where the overload decides what the op does
    (``aten.repeat_interleave.Tensor`` reads its repeats on the host)."""
    name = str(func.overloadpacket)
    if name == "aten.repeat_interleave" and \
            func._overloadname == "Tensor":
        return "aten.repeat_interleave.Tensor"
    return name


def _copy_direction(name, args, outs) -> str:
    """``D2H``/``H2D`` for a copy between the card and the host."""
    if name not in COPY_OPS:
        return ""
    ins = _tensors(args)
    if not ins:
        return ""
    if name == "aten._to_copy":
        src, dst = ins[0], (_tensors(outs) or [None])[0]
    else:                                   # copy_(dst, src)
        dst, src = ins[0], ins[1] if len(ins) > 1 else None
    if src is None or dst is None or src.device == dst.device:
        return ""
    if src.device.type == "cuda" and dst.device.type == "cpu":
        return D2H
    if src.device.type == "cpu" and dst.device.type == "cuda":
        return H2D
    return ""


def _written(func, args, kwargs) -> list:
    """The tensors an op writes in place (its schema's mutable args)."""
    out = []
    schema = func._schema
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        val = args[i] if i < len(args) else kwargs.get(arg.name)
        out.extend(_tensors(val))
    return out


class _Recorder(TorchDispatchMode):
    """Appends a :class:`Site` for every op it sees; with a taint tracker,
    propagates clock taint as well."""

    def __init__(self, taint=None):
        super().__init__()
        self.sites: list = []
        self.taint = taint

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = op_name(func)
        region = regions.current()
        src = _source()
        slot = len(self.sites)
        self.sites.append(None)             # the node comes before its
        ins = _tensors((args, kwargs))      # plain version's ops
        if name.split(".", 1)[0] == KERNEL_NAMESPACE and ins \
                and all(t.device.type == "cpu" for t in ins):
            from ..kernels import ops
            # see the plain version's ops, inside kernel_ref/<name>
            with self, regions.region(
                    f"{KERNEL_REF}/{name.split('.', 1)[1]}"):
                out = ops.PLAIN[name](*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        name += _copy_direction(name, args, outs)
        self.sites[slot] = Site(
            op=name, region=region, src=src,
            dtypes=tuple(str(t.dtype).removeprefix("torch.") for t in outs),
            shapes=tuple(tuple(t.shape) for t in outs),
            in_dtypes=tuple(str(t.dtype).removeprefix("torch.")
                            for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            in_bytes=sum(distinct_bytes(t) for t in ins),
            out_bytes=sum(distinct_bytes(t) for t in outs),
            view=bool(func.is_view))
        if self.taint is not None:
            self.taint.apply(name, region, src, ins, outs,
                             _written(func, args, kwargs))
        return out


def record(fn, *args, **kwargs) -> Inventory:
    """Run ``fn(*args, **kwargs)`` once under the recorder: the
    :class:`Inventory` of every op it dispatched, ``result`` its return
    value."""
    rec = _Recorder()
    with rec:
        result = fn(*args, **kwargs)
    return Inventory(sites=rec.sites, result=result)


# ==========================================================================
# clock-dtype taint propagation
# ==========================================================================

# taint lattice: NONE < CLEAN (a time value) < DEGRADED (a time value that
# went through a float below time_dtype outside F32_DOMAIN)
NONE, CLEAN, DEGRADED = 0, 1, 2
_NO_TAINT = (NONE, None)

# state leaves that carry absolute simulation times (suffix-matched on the
# "."-prefixed dotted paths of types.tree_leaves; the reference's list)
TIME_LEAVES = (
    ".t",
    ".farm.core_busy_until",
    ".farm.srv_wake_at",
    ".farm.srv_idle_since",
    ".farm.srv_tau",
    ".jobs.arrival",
    ".jobs.task_end",
    ".jobs.start_at",
    ".jobs.finish",
    ".jobs.job_finish",
    ".jobs.admit_at",
    ".jobs.deadline",
    ".flows.done_at",
    ".flows.extra",
    ".net.port_idle_since",
    ".thermal.ctrl_next",
)


def leaves(tree) -> list:
    """[(".dotted.path", tensor)] of a dataclass tree of tensors (a state),
    in field order: ``core.types.tree_leaves`` with the reference's
    leading dot."""
    return [("." + p, x) for p, x in tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def time_leaves(tree) -> list:
    """[(path, tensor)] of the declared clock leaves of ``tree``."""
    return [(p, x) for p, x in leaves(tree)
            if any(p.endswith(s) for s in TIME_LEAVES)]


def _key(t: torch.Tensor):
    if t.numel() == 0:
        return None
    return (t.device.type, t.device.index, t.untyped_storage().data_ptr())


def _is_float(t) -> bool:
    return t.dtype.is_floating_point


def _bits(t) -> int:
    return t.element_size() * 8


def _join(a: tuple, b: tuple) -> tuple:
    return a if a[0] >= b[0] else b


class _Taint:
    """Storage -> (level, origin site): what each op's outputs and
    in-place targets carry, from its inputs."""

    def __init__(self, time_dtype: torch.dtype):
        self.tbits = torch.finfo(time_dtype).bits
        self.env: dict = {}
        self.downcasts: list = []

    def read(self, t) -> tuple:
        k = _key(t)
        return _NO_TAINT if k is None else self.env.get(k, _NO_TAINT)

    def write(self, t, taint: tuple) -> None:
        k = _key(t)
        if k is None:
            return
        if taint[0] == NONE:
            self.env.pop(k, None)
        else:
            self.env[k] = taint

    def apply(self, name, region, src, ins, outs, written) -> None:
        kernel = name.split(".", 1)[0] == KERNEL_NAMESPACE
        f32_domain = F32_DOMAIN in region.split("/")
        joined = _NO_TAINT
        for t in ins:
            joined = _join(joined, self.read(t))
        # a float input at the clock's width carrying a time value
        wide_time = any(_is_float(t) and _bits(t) >= self.tbits
                        and self.read(t)[0] != NONE for t in ins)
        in_place = {id(w) for w in written}
        targets = list(outs) + [w for w in written
                                if not any(w is o for o in outs)]
        for t in targets:
            if not _is_float(t) or joined[0] == NONE:
                self.write(t, self.read(t) if id(t) in in_place
                           else _NO_TAINT)
                continue
            if kernel:
                # a kernel's outputs below its clock inputs' width are its
                # own f32 physics (energy, busy seconds): no clock taint;
                # the others carry their same-dtype inputs' taint
                taint = _NO_TAINT
                for i in ins:
                    if i.dtype == t.dtype:
                        taint = _join(taint, self.read(i))
            elif _bits(t) < self.tbits and wide_time:
                if f32_domain:
                    # the declared exit into the f32 physics domain: the
                    # result is no longer a clock
                    taint = _NO_TAINT
                else:
                    self.downcasts.append(src)
                    taint = (DEGRADED, src)
            else:
                taint = joined
            if id(t) in in_place:
                taint = _join(taint, self.read(t))
            self.write(t, taint)


@dataclasses.dataclass
class ClockReport:
    """Result of :func:`clock_audit`."""

    time_dtype: str
    # {leaf name: dtype} for declared time leaves, inputs and outputs
    in_census: dict
    out_census: dict
    # [(leaf name, downcast site)]: time outputs built from a value that
    # lost precision outside F32_DOMAIN
    degraded_leaves: list
    # every downcast site that created degraded taint (for diagnostics)
    downcast_sites: list

    @property
    def census_violations(self) -> list:
        bad = []
        for census, tag in ((self.in_census, "input"),
                            (self.out_census, "output")):
            for name, dtype in census.items():
                if dtype != self.time_dtype:
                    bad.append((name, tag, dtype))
        return bad


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def audit(fn, state, time_dtype) -> tuple:
    """Run ``fn(state)`` (a state -> state step) once under the recorder,
    propagating clock taint from ``state``'s declared time leaves through
    every op: (its :class:`Inventory`, its :class:`ClockReport`, which
    gives the time leaves' dtypes in and out and those rebuilt from a
    degraded value)."""
    taint = _Taint(time_dtype)
    t_in = time_leaves(state)
    for _, x in t_in:
        taint.write(x, (CLEAN, None))
    rec = _Recorder(taint)
    with rec:
        out = fn(state)
    t_out = time_leaves(out)
    degraded = [(p, taint.read(x)[1] or "<unknown>") for p, x in t_out
                if taint.read(x)[0] == DEGRADED]
    report = ClockReport(
        time_dtype=_dtype_name(time_dtype),
        in_census={p: _dtype_name(x.dtype) for p, x in t_in},
        out_census={p: _dtype_name(x.dtype) for p, x in t_out},
        degraded_leaves=degraded,
        downcast_sites=sorted(set(taint.downcasts)))
    return Inventory(sites=rec.sites, result=out), report


def clock_audit(fn, state, time_dtype) -> ClockReport:
    """The :class:`ClockReport` of one run of ``fn(state)`` (see
    :func:`audit`)."""
    return audit(fn, state, time_dtype)[1]


__all__ = ["OpSet", "Site", "Inventory", "record", "audit", "clock_audit",
           "ClockReport", "TIME_LEAVES", "SCATTER_OPS", "GATHER_OPS",
           "COLLECTIVE_OPS", "ALL_GATHER_OPS", "HOST_SYNC_OPS", "KERNEL_OPS",
           "ANY_OP", "leaves", "time_leaves", "distinct_bytes", "op_name"]
