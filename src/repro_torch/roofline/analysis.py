"""Three-term roofline of one dry-run cell on the H100 (port of
``repro.roofline.analysis``):

  compute    = operations_per_device / peak bf16 flop/s of one card
  memory     = bytes_per_device / HBM bytes/s of one card
  collective = collective_bytes_per_device / link bytes/s of one card

The reference reads XLA's ``cost_analysis()`` and the HLO text of the
compiled per-device module.  The port's step is eager, so the dry run
(``launch/dryrun.py``) runs it on rank 0 of a fake process group over
fake tensors, recorded by ``analysis.graph_audit.record``: each op's
operations and bytes come from ``analysis.costmodel.op_cost`` (no
fusion: every op reads its inputs and writes its outputs once, so the
bytes are an eager step's, above a fused module's), and the collective
bytes by type sum the result bytes of the recorded ``torch.distributed``
ops (``graph_audit.COLLECTIVE_OPS``), as the reference sums the result
shapes of the HLO's collectives; ``C10D_COLLECTIVES`` maps c10d's op
names onto the reference's five keys.  The collectives' operations are
not counted; their bytes are.

Depth: XLA counts a loop body once, so the reference extrapolates from
unrolled 1- and 2-period probes (``extrapolate``) and adds the time
loops of the recurrences analytically (``recurrent_flop_correction``).
An eager trace records every op of every iteration, the recurrences'
time loops included, so the port's ``collect`` extrapolates from its
probes too (a full-depth trace of the xLSTM's sLSTM, about 20 ops a
position a layer, would take hours of host time) but never adds the
correction: the probes count those loops in full.  The correction is
kept, equal to the reference's, for comparison.

Memory: ``LiveBytes`` counts the storages alive through the traced step
on rank 0 (state, inputs, activations, temporaries), each rounded up to
the CUDA caching allocator's 512-byte block, and keeps the peak; the
port's counterpart of ``memory_analysis()``.

Hardware model: NVIDIA H100 SXM (the data sheet's dense figures, at the
700 W limit), the constants of ``analysis/costmodel.py``.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..analysis import costmodel
from ..analysis.graph_audit import COLLECTIVE_OPS

PEAK_FLOPS = costmodel.H100_BF16_FLOP_S     # 989e12 bf16 dense flop/s a card
HBM_BW = costmodel.H100_HBM_BYTES_S         # 3.35e12 HBM3 bytes/s a card
# NVLink 4: 18 links of 25 GB/s a direction, 450 GB/s a direction a card
# (H100 SXM data sheet: 900 GB/s bidirectional), within one 8-card node
NVLINK_BW = 450e9
# between nodes: one 400 Gb/s ConnectX-7 NDR port a GPU (DGX H100), 50
# GB/s a direction a card
NIC_BW = 50e9
NODE_GPUS = 8
# the rate of the production meshes: their 16-wide axes span two nodes
ICI_BW = NIC_BW

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# c10d's dispatcher ops by the reference's collective they are
C10D_COLLECTIVES = {
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}


def link_bw(chips: int) -> float:
    """The collective term's bytes/s a card: NVLink within one node, the
    node's network beyond it."""
    return NVLINK_BW if chips <= NODE_GPUS else NIC_BW


def collective_bytes(inv) -> Dict[str, float]:
    """{collective: result bytes, "total", "count"} of a recording, the
    reference's ``hlo_collective_bytes``; a c10d op outside the five (a
    barrier, a broadcast) counts in ``count`` only."""
    out = {k: 0.0 for k in _COLLECTIVES}
    out["total"] = 0.0
    out["count"] = 0
    for s in inv.sites_of(COLLECTIVE_OPS):
        kind = C10D_COLLECTIVES.get(s.op)
        out["count"] += 1
        if kind is not None:
            out[kind] += s.out_bytes
            out["total"] += s.out_bytes
    return out


# metadata queries that fake tensors send through the dispatcher (a
# tensor's device), which move and compute nothing
_METADATA = ("prim.",)


def raw_stats(inv) -> dict:
    """Per-device operations, bytes and collective bytes of one recorded
    step (kernels one node each, ``Inventory.folded``; fake tensors'
    metadata queries left out)."""
    inv = inv.folded()
    flops = nbytes = 0
    for s in inv.sites:
        if s.op.startswith(_METADATA):
            continue
        b, o = costmodel.op_cost(s)
        nbytes += b
        if s.op not in COLLECTIVE_OPS:
            flops += o
    coll = collective_bytes(inv)
    return {"flops": float(flops), "bytes": float(nbytes),
            "coll": float(coll["total"]),
            "coll_by_type": {k: v for k, v in coll.items()
                             if k in _COLLECTIVES}}


def extrapolate(p1: dict, p2: dict, n_periods: int) -> dict:
    """Linear depth extrapolation from two unrolled probes at 1 and 2
    pattern-periods: total(L) = p1 + (L-1)·(p2-p1)."""
    out = {}
    for k in ("flops", "bytes", "coll"):
        delta = max(p2[k] - p1[k], 0.0)
        out[k] = p1[k] + (n_periods - 1) * delta
    out["coll_by_type"] = {
        k: p1["coll_by_type"][k] + (n_periods - 1) * max(
            p2["coll_by_type"][k] - p1["coll_by_type"][k], 0.0)
        for k in p1["coll_by_type"]}
    return out


def recurrent_flop_correction(cfg, shp, chips: int) -> float:
    """Per-device FLOPs inside time-step lax.scan loops (sLSTM recurrence,
    Mamba state scan) that even unrolled-layer probes undercount (the time
    loop body is counted once).  Analytic, documented in EXPERIMENTS.md.
    Train ≈ 3× forward (fwd + 2× transpose), +1 if full remat.  The
    reference's; the port's eager probes count these loops in full, so
    ``collect`` does not add it."""
    if shp.kind == "decode":
        return 0.0                      # single step, fully counted
    tokens = shp.tokens
    mult = 1.0
    if shp.kind == "train":
        mult = 3.0 + (1.0 if cfg.remat == "full" else 0.0)
    per_layer = 0.0
    counts = {k: cfg.block_pattern.count(k) * cfg.n_periods
              for k in set(cfg.block_pattern)}
    if counts.get("slstm"):
        dh = cfg.d_model // cfg.n_heads
        per_layer += counts["slstm"] * 2 * cfg.n_heads * dh * 4 * dh
    n_mamba = counts.get("mamba", 0) + counts.get("hymba", 0)
    if n_mamba and cfg.ssm_state:
        per_layer += n_mamba * 6 * cfg.d_ssm * cfg.ssm_state
    return mult * tokens * per_layer / max(chips, 1)


def model_flops(cfg, shp) -> float:
    """Paper-convention useful FLOPs: 6·N·D train, 2·N·D inference, with
    N = active params for MoE."""
    n_active = cfg.param_count(active_only=True)
    tokens = shp.tokens if shp.kind != "decode" else shp.global_batch
    mult = 6.0 if shp.kind == "train" else 2.0
    return mult * n_active * tokens


# the CUDA caching allocator's smallest block
_BLOCK = 512
# out-of-place writes that autograd's formulas run on a buffer they have
# just made (``grad.new_zeros(...).scatter_add(...)`` in
# ``gather_backward``, ``select_scatter``, ``slice_scatter``, ...) where
# a tensor is a subclass or a Python dispatch mode is on: fake tensors
# and ``LiveBytes`` itself.  The eager program writes the buffer in place.
_WRITES_A_FRESH_BUFFER = frozenset(
    getattr(torch.ops.aten, name) for name in (
        "scatter", "scatter_add", "scatter_reduce", "index_add",
        "index_copy", "index_put", "masked_scatter", "slice_scatter",
        "select_scatter", "diagonal_scatter", "as_strided_scatter"))


def _tensors(tree) -> list:
    """The tensors of nested tuples, lists, dicts and modules (their
    parameters)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive while it is on, and their peak:
    an op's output storage counts from the first op that returns it
    until it is freed (a weak reference's callback), rounded up to 512
    bytes as the CUDA caching allocator rounds a block.  ``add`` counts
    tensors made before (the state, the inputs).  Works on fake tensors,
    whose storages are freed as real ones would be.

    Under a Python dispatch mode (this one, or fake tensors') autograd's
    formulas take their tensor-subclass branches, which write a buffer
    they have just made out of place (``_WRITES_A_FRESH_BUFFER``) where
    the eager program writes it in place: at a train step's loss,
    ``gather_backward`` would hold a second (B, S, vocab) float32 buffer
    at the peak.  Such a write, on a buffer the op before it returned,
    takes the buffer's place in the count, as the in-place write would."""

    def __init__(self):
        super().__init__()
        self.live: dict = {}            # id(storage) -> [bytes, weakref]
        self.now = self.peak = 0
        self._fresh: set = set()        # the last op's output storages

    def add(self, *trees) -> int:
        """Count the storages of ``trees``' tensors; returns their bytes
        not counted before."""
        before = self.now
        for t in _tensors(trees):
            self._see(t)
        return self.now - before

    def _see(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage if it is new; returns its id."""
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return key
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        rec = [n, None]

        def freed(_, key=key, rec=rec):
            self.live.pop(key, None)
            self.now -= rec[0]
        rec[1] = weakref.ref(st, freed)
        self.live[key] = rec
        self.now += n
        self.peak = max(self.peak, self.now)
        return key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _WRITES_A_FRESH_BUFFER and args \
                and isinstance(args[0], torch.Tensor):
            key = id(args[0].untyped_storage())
            if key in self._fresh:
                # the buffer's bytes pass to the output: it counts no more
                rec = self.live.get(key)
                if rec is not None:
                    self.now -= rec[0]
                    rec[0] = 0
        self._fresh = {self._see(t) for t in _tensors(out)}
        return out


def collect(cfg, shp, mesh_shape: dict, stats, memory: dict, *,
            t_lower=0.0, t_compile=0.0, probes=None) -> dict:
    """The cell's JSON in the reference's schema.  ``mesh_shape``
    {axis: size}; ``stats`` the full-depth trace's ``raw_stats`` (None
    when it was not recorded); ``memory`` {"peak_bytes", "state_bytes",
    "input_bytes", ...}; probes: (p1, p2) raw_stats of the 1- and
    2-period probes; when given, flops/bytes/collectives are
    depth-extrapolated from them (without ``recurrent_flop_correction``:
    see the module's note).  ``t_lower`` is the host seconds spent making
    the rank's fake state and inputs, ``t_compile`` those of the
    full-depth trace."""
    chips = math.prod(mesh_shape.values())
    if probes is not None:
        p1, p2 = probes
        tot = extrapolate(p1, p2, cfg.n_periods)
        flops, bytes_acc = tot["flops"], tot["bytes"]
        coll_total, coll_by_type = tot["coll"], tot["coll_by_type"]
    else:
        flops, bytes_acc = stats["flops"], stats["bytes"]
        coll_total, coll_by_type = stats["coll"], stats["coll_by_type"]
    terms = {
        "t_compute": flops / PEAK_FLOPS,
        "t_memory": bytes_acc / HBM_BW,
        "t_collective": coll_total / link_bw(chips),
    }
    dominant = max(terms, key=terms.get)
    step_est = max(terms.values())
    mflops = model_flops(cfg, shp)
    useful = mflops / max(flops * chips, 1.0)
    roofline_frac = (mflops / chips / PEAK_FLOPS) / max(step_est, 1e-30)
    return {
        "arch": cfg.name, "shape": shp.name, "kind": shp.kind,
        "chips": chips,
        "mesh": dict(mesh_shape),
        "flops": flops, "bytes_accessed": bytes_acc,
        "collective_bytes": coll_total,
        "collectives": coll_by_type,
        "flops_scanned_module": stats["flops"] if stats else 0.0,
        **terms,
        "dominant": dominant,
        "step_time_est": step_est,
        "model_flops": mflops,
        "useful_flop_ratio": useful,
        "roofline_fraction": roofline_frac,
        "bytes_per_device": memory["peak_bytes"],
        "memory": memory,
        "t_lower": t_lower, "t_compile": t_compile,
        "params": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
        "link_bw": link_bw(chips),
    }
