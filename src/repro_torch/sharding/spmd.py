"""What XLA's SPMD partitioner inserts into the reference's sharded steps,
written out for ``torch.distributed``: a rank's block of a leaf under a
spec, a leaf gathered from its blocks, a full gradient summed and cut
back to blocks, the expert-parallel combine's all-reduce over "model",
and the sums of the loss statistics over the batch ranks.

The program is SPMD, one process a rank (``torchrun``, or
``core.shard_sim.spawn``), over a ``DeviceMesh`` with the axes
("pod",) "data", "model" (``launch/mesh.py``).  A spec is
``sharding.partition``'s tuple: entry d names the mesh axes that split
dim d, the first axis major, as in the reference (a dim over ("pod",
"data") holds block ``pod * n_data + data`` on a rank).  Collectives run
axis by axis on the mesh's per-axis groups, the minor axis first for a
gather and the major one first for a reduce-scatter, and an axis of size
1 calls none, so a one-rank mesh calls no collective at all.  The port calls
every collective through ``torch.distributed``'s attributes (so
``tests/torch_spmd.py``'s counter sees them).

The reduce-scatter is ``reduce_scatter_single`` where torch has it and
``reduce_scatter_tensor`` where it has not (the same call, renamed);
gloo takes it on CUDA tensors, staging them through the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import partition

MODEL = "model"


class Share:
    """A rank's segment of one microbatch in a sharded train step whose
    microbatches cross the batch ranks (``train/step.py``): the segment's
    losses are its sums over the microbatch's global ``rows`` and label
    ``count``, so the segments' shares add up to the microbatch's means.
    The MoE load-balance term needs the microbatch's top-1 fractions,
    summed over the ranks that hold its rows; ``models.moe.route``
    registers each layer's counts here (``route``), the step sums them
    over the batch ranks between the segment's forward and its backward
    (``set_fractions``), and the term's gradient and value read the sums
    (``balance``)."""

    class Route:
        """One MoE layer's share: its top-1 counts and mean
        probabilities, and the microbatch's fractions once summed."""
        counts = mean_p = z = frac = tokens = None

    def __init__(self, rows: int, count: torch.Tensor):
        self.rows, self.count = rows, count
        self.routes: Dict[int, "Share.Route"] = {}

    def route(self, key: int, counts, mean_p, z, tokens: int) -> "Share.Route":
        """The layer ``key``'s record (the same one when a checkpoint
        recomputes the layer), with this forward's values; ``tokens`` the
        microbatch's."""
        r = self.routes.setdefault(key, Share.Route())
        r.counts, r.mean_p, r.z = counts, mean_p.detach(), z.detach()
        r.tokens = tokens
        return r

    def counts(self) -> torch.Tensor:
        """(layers, E) top-1 counts of this segment, in forward order."""
        return torch.stack([r.counts for r in self.routes.values()])

    def set_fractions(self, summed: torch.Tensor) -> None:
        """The microbatch's fractions from its (layers, E) counts summed
        over the batch ranks."""
        for r, c in zip(self.routes.values(), summed):
            r.frac = c / r.tokens

    def balance(self, n_experts: int, zloss: float) -> tuple:
        """(sum over layers of the balance terms E sum(frac mean_p), sum of
        the layers' whole aux shares in forward order): what the forward's
        aux left out, and the aux share it should have been."""
        lb_sum = aux = None
        for r in self.routes.values():
            lb = n_experts * torch.sum(r.frac * r.mean_p)
            a = lb + zloss * r.z
            lb_sum = lb if lb_sum is None else lb_sum + lb
            aux = a if aux is None else aux + a
        return lb_sum, aux


@dataclasses.dataclass(frozen=True)
class Ctx:
    """A rank's view of the mesh for one step: the axes' sizes, its
    coordinate on each, and whether the step's batch is split over the
    batch axes (``split``: this rank holds its block of the rows, so
    means over the batch are global sums over global counts).  ``share``
    is set inside a microbatch's segment (``Share``): means are over the
    microbatch's global rows and labels.  ``mesh`` gives the per-axis
    process groups; a context of a mesh whose axes are all 1 calls no
    collective."""
    mesh: object
    sizes: Dict[str, int]
    coord: Dict[str, int]
    split: bool = False
    share: Optional[Share] = None

    @classmethod
    def of(cls, mesh, split: bool = False) -> "Ctx":
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"{mesh}")
        sizes = partition.mesh_sizes(mesh)
        coord = {a: int(mesh.get_local_rank(a)) for a in sizes}
        return cls(mesh, sizes, coord, split)

    # a context is also a mesh to ``partition``: its names and sizes
    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return tuple(self.sizes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.sizes.values())

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return partition.batch_axes(self)

    @property
    def n_batch(self) -> int:
        return math.prod(self.sizes[a] for a in self.batch_axes)

    @property
    def batch_index(self) -> int:
        return self.index(self.batch_axes)

    @property
    def n_model(self) -> int:
        return self.sizes.get(MODEL, 1)

    @property
    def model_index(self) -> int:
        return self.coord.get(MODEL, 0)

    def for_batch(self, global_batch: int) -> "Ctx":
        """This context for a step on ``global_batch`` rows: split over
        the batch axes when they divide it (``partition.batch_pspec``),
        replicated otherwise."""
        split = self.n_batch > 1 and \
            partition.batch_pspec(self, global_batch) != ()
        return dataclasses.replace(self, split=split)

    def local(self) -> "Ctx":
        """This context with the rank's rows taken as a whole batch: means
        over them are local (serving, whose MoE aux is discarded)."""
        return dataclasses.replace(self, split=False)

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block index along ``axes``, the first major."""
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coord[a]
        return i

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    # ---- sums --------------------------------------------------------
    def sum_over(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """``t`` summed over the ranks of ``axes`` (a new tensor; no
        gradient flows through)."""
        t = t.detach().clone()
        for a in axes:
            if self.sizes[a] > 1:
                dist.all_reduce(t, group=self.group(a))
        return t

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch ranks when the batch is split, else
        ``t`` itself: a global count or sum from this rank's share."""
        return self.sum_over(t, self.batch_axes) if self.split else t

    def batch_rows(self, t: Optional[torch.Tensor]):
        """This rank's rows of a global batch tensor (all of them when the
        batch is not split)."""
        if t is None or not self.split:
            return t
        n = t.shape[0] // self.n_batch
        i = self.batch_index
        return t[i * n:(i + 1) * n]


# one device: the sharded step's context where there is no mesh, which
# cuts, gathers and sums nothing
ONE_DEVICE = Ctx(None, {"data": 1, "model": 1}, {"data": 0, "model": 0})


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)


# --------------------------------------------------------------------------
# collectives along one dim
# --------------------------------------------------------------------------

def all_gather(x: torch.Tensor, dim: int, group, k: int) -> torch.Tensor:
    """``x`` of the ``k`` ranks of ``group`` concatenated along ``dim`` in
    rank order: one collective."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((k * xt.shape[0],) + tuple(xt.shape[1:]))
    single = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    single(out, xt, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group, k: int) -> torch.Tensor:
    """``x`` summed over the ``k`` ranks of ``group``, this rank's block
    along ``dim`` kept: one collective."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // k,) + tuple(xt.shape[1:]))
    single = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    single(out, xt, group=group)
    return out.movedim(0, dim)


def _cut(x: torch.Tensor, dim: int, k: int, i: int) -> torch.Tensor:
    n = x.shape[dim] // k
    return x.narrow(dim, i * n, n)


# --------------------------------------------------------------------------
# leaves under a spec
# --------------------------------------------------------------------------

def block(x: torch.Tensor, spec: tuple, ctx: Ctx) -> torch.Tensor:
    """This rank's block of a full leaf under ``spec`` (a view)."""
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if axes:
            x = _cut(x, d, ctx.size(axes), ctx.index(axes))
    return x


def gather(x: torch.Tensor, spec: tuple, ctx: Ctx,
           keep: Sequence[int] = ()) -> torch.Tensor:
    """A leaf gathered from this rank's block to full, except along the
    dims in ``keep``, which stay this rank's block."""
    for d, entry in enumerate(spec):
        if d in keep:
            continue
        for a in reversed(_axes(entry)):
            if ctx.sizes[a] > 1:
                x = all_gather(x, d, ctx.group(a), ctx.sizes[a])
    return x


def reduce_grad(g: torch.Tensor, spec: tuple, ctx: Ctx,
                keep: Sequence[int] = ()) -> torch.Tensor:
    """A rank's gradient of a full leaf (of its block along ``keep``) cut
    to its block under ``spec``.  When the batch is split, each batch rank
    holds the gradient of its share of the loss, so the gradient is summed
    over them: reduce-scattered along the dim the batch axes split (FSDP),
    all-reduced where none does.  The "model" ranks computed the same
    gradient (the non-expert compute is repeated on each), so "model"
    only cuts."""
    batch = set(ctx.batch_axes) if ctx.split else set()
    summed = set()
    for d, entry in enumerate(spec):
        if d in keep:
            continue
        for a in _axes(entry):
            if a in batch:
                if ctx.sizes[a] > 1:
                    g = reduce_scatter(g, d, ctx.group(a), ctx.sizes[a])
                summed.add(a)
            else:
                g = _cut(g, d, ctx.sizes[a], ctx.coord[a])
    rest = [a for a in ctx.batch_axes if a in batch and a not in summed
            and ctx.sizes[a] > 1]
    if rest:
        g = g.clone(memory_format=torch.contiguous_format)
        for a in rest:
            dist.all_reduce(g, group=ctx.group(a))
    return g


def owns(spec: tuple, ctx: Ctx) -> bool:
    """Whether this rank counts its block of a leaf in a global sum over
    blocks: the leaf is replicated over the mesh axes its spec does not
    name, and only the rank at 0 on each of those counts it."""
    used = {a for e in spec for a in _axes(e)}
    return all(ctx.coord[a] == 0 for a in ctx.sizes if a not in used)


def global_norm(grads: Sequence[torch.Tensor], specs: Sequence[tuple],
                ctx: Ctx) -> torch.Tensor:
    """The norm of the full logical gradient from this rank's blocks: each
    leaf's float32 sum of squares counted once over the mesh, summed in
    one all-reduce an axis."""
    total = None
    for g, spec in zip(grads, specs):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        if not owns(spec, ctx):
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    return torch.sqrt(ctx.sum_over(total, tuple(ctx.sizes)))


# --------------------------------------------------------------------------
# the expert-parallel region (models/moe.py)
# --------------------------------------------------------------------------

class _ModelCopy(torch.autograd.Function):
    """Identity forward; the gradient summed over "model" backward: a
    replicated tensor that each model rank uses for its own experts
    only."""

    @staticmethod
    def forward(ctx_, x, ctx):
        ctx_.spmd = ctx
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx_.spmd.group(MODEL))
        return g, None


class _ModelSum(torch.autograd.Function):
    """Summed over "model" forward; the gradient passed through unchanged
    backward, since every model rank computes the same loss from the
    sum."""

    @staticmethod
    def forward(ctx_, x, ctx):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=ctx.group(MODEL))
        return y

    @staticmethod
    def backward(ctx_, g):
        return g, None


class _ModelSlice(torch.autograd.Function):
    """This model rank's block along ``dim`` forward; the blocks' gradients
    gathered back along ``dim`` backward."""

    @staticmethod
    def forward(ctx_, x, dim, ctx):
        ctx_.dim, ctx_.spmd = dim, ctx
        return _cut(x, dim, ctx.n_model, ctx.model_index).contiguous()

    @staticmethod
    def backward(ctx_, g):
        c = ctx_.spmd
        return all_gather(g, ctx_.dim, c.group(MODEL), c.n_model), None, None


def model_copy(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return _ModelCopy.apply(x, ctx)


def model_sum(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return _ModelSum.apply(x, ctx)


def model_slice(x: torch.Tensor, dim: int, ctx: Ctx) -> torch.Tensor:
    return _ModelSlice.apply(x, dim, ctx)


__all__ = ["Ctx", "ONE_DEVICE", "Share", "all_gather", "block", "gather",
           "global_norm", "model_copy", "model_slice", "model_sum", "owns",
           "reduce_grad", "reduce_scatter"]
