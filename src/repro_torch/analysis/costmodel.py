"""Op-level cost model: bytes moved and operations per recorded op, a
call's bound on the H100, and the state-footprint (HBM budget) table.
Port of ``repro.analysis.costmodel`` with the H100's constants in place of
the TPU v5e's.

An estimate over the recorded ops (``graph_audit.record``), not a
measurement: each op reads each input's distinct elements once and writes
each output once (a view moves nothing), so the bytes of a step are what
its eager ops must move at the least, with no fusion.  A kernel op
(``repro_torch.*``) is charged its own inputs and outputs once; on the CPU
its plain version's ops are folded into it (``Inventory.folded``).  The
bound of a call is the larger of its bytes at the HBM rate and its
operations at the float32 rate (float64 and integer operations counted
at the float32 rate too, so the bound stays a lower one).

``state_footprint`` sizes the state a function builds on fake tensors
(``FakeTensorMode``: every tensor a meta tensor, no storage), so the
65,536-server farm's HBM budget is a printed table, not an allocation.
"""
from __future__ import annotations

import dataclasses
import math

import torch


# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): HBM3 bytes/s,
# float32 operations/s outside the tensor cores, bf16 tensor-core flop/s,
# exponentials a clock on one SM's special-function units, HBM bytes
H100_HBM_BYTES_S = 3.35e12
H100_F32_OPS_S = 67e12
H100_BF16_FLOP_S = 989e12
H100_EXP_PER_SM_CLOCK = 16
H100_HBM_BYTES = 80e9


def hbm_capacity() -> float:
    """The card's memory in bytes: the device's own figure on a card, the
    data sheet's 80 GB otherwise."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return H100_HBM_BYTES


# operations an output element costs, beyond 1 (the default)
_ELEMENTWISE_WEIGHT = {
    "aten.exp": 8, "aten.log": 8, "aten.log1p": 8, "aten.sin": 8,
    "aten.cos": 8, "aten.tanh": 8, "aten.erf": 8, "aten.pow": 8,
    "aten.rsqrt": 4, "aten.sqrt": 4, "aten.div": 4, "aten.div_": 4,
    "aten.remainder": 4, "aten.fmod": 4, "aten.sigmoid": 8,
    "aten.silu": 8, "aten.gelu": 8,
}
# ops charged one operation an input element
_REDUCTIONS = frozenset({
    "aten.sum", "aten.amin", "aten.amax", "aten.min", "aten.max",
    "aten.any", "aten.all", "aten.argmin", "aten.argmax", "aten.mean",
    "aten.prod", "aten.cumsum", "aten.cumprod", "aten.cummax",
    "aten.cummin", "aten.logsumexp", "aten._softmax", "aten.norm",
})
# ops that only move data (or make it): no operations
_ZERO_OP = frozenset({
    "aten._to_copy", "aten.copy_", "aten.clone", "aten.cat", "aten.stack",
    "aten.index", "aten.index_select", "aten.gather", "aten.take",
    "aten.index_put", "aten.index_put_", "aten._index_put_impl_",
    "aten.scatter", "aten.scatter_", "aten.masked_fill",
    "aten.masked_fill_", "aten.where", "aten.full", "aten.full_like",
    "aten.empty", "aten.empty_like", "aten.empty_strided",
    "aten.new_empty", "aten.new_full", "aten.new_zeros", "aten.zeros",
    "aten.zeros_like", "aten.ones", "aten.ones_like", "aten.arange",
    "aten.fill_", "aten.zero_", "aten.lift_fresh", "aten.repeat",
    "aten.repeat_interleave", "aten.flip", "aten.roll",
    "aten.constant_pad_nd", "aten.embedding", "aten.tril", "aten.triu",
})
_MATMUL = frozenset({"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm"})
_SORTS = frozenset({"aten.sort", "aten.argsort", "aten.topk"})


def _numel(shape) -> int:
    return math.prod(shape)


def kernel_ops(site) -> int:
    """Operations of one kernel op, by what it computes (the counts
    ``chip_smoke.py``'s bounds use)."""
    name = site.op.split(".", 1)[1]
    if name == "dcsim_advance":
        *_, n, c = site.in_shapes[0]                     # core_busy
        servers = _numel(site.in_shapes[0]) // max(c, 1)
        return servers * (3 * c + 15)
    if name == "telemetry_accum":
        values = _numel(site.in_shapes[0]) + _numel(site.in_shapes[2])
        return values * 25 + _numel(site.in_shapes[8])
    if name == "flash_attention":
        B, H, Sq, hd = site.in_shapes[0]
        Skv = site.in_shapes[1][2]
        return 4 * B * H * Sq * Skv * hd
    if name == "ssm_scan":
        B, S, Dss = site.in_shapes[3]
        return 6 * B * S * Dss * site.in_shapes[1][-1]
    return 0


def op_cost(site) -> tuple:
    """(bytes, operations) of one recorded op."""
    if site.view:
        return 0, 0
    n_bytes = site.in_bytes + site.out_bytes
    op = site.op.split("[", 1)[0]
    if op.startswith("repro_torch."):
        return n_bytes, kernel_ops(site)
    if op in _ZERO_OP or not site.shapes:
        return n_bytes, 0
    if op in _MATMUL:
        a, b = site.in_shapes[-2], site.in_shapes[-1]
        return n_bytes, 2 * _numel(site.shapes[0]) * a[-1] \
            if a and b else 0
    if op in _REDUCTIONS:
        return n_bytes, _numel(site.in_shapes[0]) if site.in_shapes else 0
    if op in _SORTS:
        n = _numel(site.in_shapes[0]) if site.in_shapes else 0
        return n_bytes, n * max(int(math.log2(max(n, 2))), 1)
    return n_bytes, _ELEMENTWISE_WEIGHT.get(op, 1) * _numel(site.shapes[0])


@dataclasses.dataclass
class CostReport:
    """Rolled-up cost of one recorded call."""

    total_bytes: int
    total_ops: int
    by_region: dict  # {region: {"bytes": int, "ops": int, "nodes": int}}

    @property
    def arithmetic_intensity(self) -> float:
        return self.total_ops / max(self.total_bytes, 1)

    @property
    def bound_s(self) -> float:
        """The least time the H100 could take: bytes at the HBM rate or
        operations at the float32 rate, the larger."""
        return max(self.total_bytes / H100_HBM_BYTES_S,
                   self.total_ops / H100_F32_OPS_S)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.total_bytes / H100_HBM_BYTES_S >= \
            self.total_ops / H100_F32_OPS_S else "operations"

    def to_json(self) -> dict:
        return {"bytes": self.total_bytes, "ops": self.total_ops,
                "arithmetic_intensity": round(self.arithmetic_intensity, 4),
                "bound_s": self.bound_s, "bound_by": self.bound_by,
                "by_region": self.by_region}


def cost_of(inv) -> CostReport:
    """The cost of a recorded call, each kernel one node."""
    by_region: dict = {}
    total_b = total_o = 0
    for s in inv.folded().sites:
        b, o = op_cost(s)
        slot = by_region.setdefault(s.region,
                                    {"bytes": 0, "ops": 0, "nodes": 0})
        slot["bytes"] += b
        slot["ops"] += o
        slot["nodes"] += 1
        total_b += b
        total_o += o
    return CostReport(total_bytes=total_b, total_ops=total_o,
                      by_region=dict(sorted(by_region.items())))


# ==========================================================================
# state footprint / HBM budget
# ==========================================================================

def state_footprint(state_fn, *args) -> dict:
    """Size the state returned by ``state_fn(*args)``, built on fake
    tensors (meta storage: nothing is allocated).  Returns
    ``{"total_bytes", "by_field"}`` with ``by_field`` grouped on the first
    path component (".farm", ".jobs", ...; the reference's keys)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from .graph_audit import leaves
    with FakeTensorMode():
        state = state_fn(*args)
    by_field: dict = {}
    total = 0
    for path, x in leaves(state):
        b = x.numel() * x.element_size()
        key = "." + path.split(".")[1]
        by_field[key] = by_field.get(key, 0) + b
        total += b
    return {"total_bytes": total, "by_field": dict(sorted(by_field.items()))}


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:8.2f} {unit}"
        n /= 1024
    return f"{n:.2f} GiB"


def footprint_table(footprints: dict, hbm: float = None) -> str:
    """Render ``{label: footprint_dict}`` as the HBM-budget table."""
    hbm = hbm_capacity() if hbm is None else hbm
    lines = [f"{'config':<28} {'state bytes':>14} {'% of HBM':>14}",
             "-" * 58]
    for label, fp in footprints.items():
        total = fp["total_bytes"]
        lines.append(f"{label:<28} {_fmt_bytes(total):>14} "
                     f"{100 * total / hbm:13.4f}%")
    return "\n".join(lines)


def field_table(fp: dict) -> str:
    lines = [f"{'field':<24} {'bytes':>14}", "-" * 40]
    for field, b in sorted(fp["by_field"].items(), key=lambda kv: -kv[1]):
        lines.append(f"{field:<24} {_fmt_bytes(b):>14}")
    lines.append("-" * 40)
    lines.append(f"{'total':<24} {_fmt_bytes(fp['total_bytes']):>14}")
    return "\n".join(lines)


__all__ = ["H100_HBM_BYTES_S", "H100_F32_OPS_S", "H100_BF16_FLOP_S",
           "H100_EXP_PER_SM_CLOCK", "H100_HBM_BYTES", "hbm_capacity",
           "op_cost", "kernel_ops", "CostReport", "cost_of",
           "state_footprint", "footprint_table", "field_table"]
