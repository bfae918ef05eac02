"""What XLA's SPMD partitioner inserts into the reference's sharded steps,
written out for ``torch.distributed``: a rank's block of a leaf under a
spec, a leaf's compute form gathered from its blocks a group at a time
(``Gatherer``, with the next group's gathers in flight) and its gradient
summed and cut back to blocks, the tensor-parallel region's entry and
exit over "model" and its vocab-parallel loss, the expert-parallel
combine's all-reduce, and the sums of the loss statistics over the batch
ranks.

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

import contextlib
import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

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
    collective.  ``rows_split`` says whether this rank holds its block of
    the batch's rows: ``split``, kept by ``local`` where the means are
    local (serving), so a layer whose weights are split over the batch
    axes (the serve layout's experts) knows whose rows it holds."""
    mesh: object
    sizes: Dict[str, int]
    coord: Dict[str, int]
    split: bool = False
    share: Optional[Share] = None
    gather: Optional["Gatherer"] = None
    rows_split: bool = False

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
        return dataclasses.replace(self, split=split, rows_split=split)

    def local(self) -> "Ctx":
        """This context with the rank's rows taken as a whole batch: means
        over them are local (serving, whose MoE aux is discarded);
        ``rows_split`` still says whether the rows are a block."""
        return dataclasses.replace(self, split=False, rows_split=self.split)

    def part(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this model rank's share of ``n`` heads or channels
        (``split_range``)."""
        return split_range(n, self.n_model, self.model_index)

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


def is_part(t: torch.Tensor, full: int, ctx: Optional[Ctx],
            dim: int = -1) -> bool:
    """Whether the compute form ``t`` is a model rank's part of a leaf
    whose dim ``dim`` is ``full`` long (``transformer.tp_layout``'s
    verdict, read off the shape): a tensor-parallel region's weight, or a
    vocab-parallel head or embedding."""
    return ctx is not None and t.shape[dim] != full


def split_range(n: int, k: int, i: int) -> Tuple[int, int]:
    """[lo, hi) of part ``i`` of ``n`` items split over ``k`` parts, the
    first ``n % k`` parts one longer (25 heads over 2: 13 and 12)."""
    q, r = divmod(n, k)
    lo = i * q + min(i, r)
    return lo, lo + q + (i < r)


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)


# --------------------------------------------------------------------------
# collectives along one dim
# --------------------------------------------------------------------------

def all_gather(x: torch.Tensor, dim: int, group, k: int) -> torch.Tensor:
    """``x`` of the ``k`` ranks of ``group`` concatenated along ``dim`` in
    rank order: one collective."""
    out, _ = start_gather(x, dim, group, k, async_op=False)
    return out.movedim(0, dim)


def start_gather(x: torch.Tensor, dim: int, group, k: int,
                 async_op: bool = True):
    """The collective of ``all_gather``, started: (the gathered buffer
    with ``dim`` moved first, its work handle, or None when it ran
    synchronously)."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((k * xt.shape[0],) + tuple(xt.shape[1:]))
    single = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    work = single(out, xt, group=group, async_op=async_op)
    return out, work


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


class _ModelReduce(torch.autograd.Function):
    """Summed over "model" forward and backward: the model ranks' partial
    products of a tensor that each rank then uses for its own share of the
    compute only (the SSM's B and C over split channels), so its gradient
    on a rank is a share too."""

    @staticmethod
    def forward(ctx_, x, ctx):
        ctx_.spmd = ctx
        y = x.contiguous().clone()
        dist.all_reduce(y, group=ctx.group(MODEL))
        return y

    @staticmethod
    def backward(ctx_, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx_.spmd.group(MODEL))
        return g, None


def model_copy(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return _ModelCopy.apply(x, ctx)


def model_sum(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return _ModelSum.apply(x, ctx)


def model_slice(x: torch.Tensor, dim: int, ctx: Ctx) -> torch.Tensor:
    return _ModelSlice.apply(x, dim, ctx)


def model_reduce(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return _ModelReduce.apply(x, ctx)


# --------------------------------------------------------------------------
# the tensor-parallel region (models/layers.py, ssm.py, moe.py,
# transformer.py): Megatron's entry and exit points are ``model_copy``
# (identity forward, the gradient all-reduced over "model") before a
# column-parallel product and ``model_sum`` (all-reduced forward) after a
# row-parallel one; the head and the losses run vocab-parallel
# --------------------------------------------------------------------------

def vocab_xent(lg: torch.Tensor, labels: torch.Tensor, ctx: Ctx):
    """(lse, gold) float32 of logits ``lg`` (..., V/n) of this model
    rank's block of the vocab (block ``model_index``) against ``labels``
    (< 0: padding, read at 0 as ``_xent_parts`` does): the row max in
    ``lg``'s dtype, all-reduced (max) over "model" (no gradient: lse's
    derivative by it is 0), then the sum of exponentials in float32 and
    the gold logit, from the rank whose block holds its column and 0 on
    the others, summed over "model" in one all-reduce."""
    V = lg.shape[-1]
    m = lg.amax(dim=-1).float().detach().clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=ctx.group(MODEL))
    lf = lg.float()
    se = torch.exp(lf - m[..., None]).sum(dim=-1)
    local = labels.clamp_min(0).long() - ctx.model_index * V
    own = (local >= 0) & (local < V)
    gold = torch.gather(lf, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    both = model_sum(torch.stack([se, torch.where(own, gold, 0.0)]), ctx)
    return torch.log(both[0]) + m, both[1]


def model_gather(x: torch.Tensor, dim: int, ctx: Ctx, n: int) -> torch.Tensor:
    """The model ranks' parts of ``n`` heads or channels along ``dim``
    (rank i's ``split_range(n, ...)``), concatenated in rank order, with
    no gradient: a decode step's queries over a sequence-sharded cache
    (``decode_combine``), and the serving caches that stay whole on every
    model rank (the mLSTM's states, whisper's cross keys), or an SSM state
    whose layout differs from its compute's.  Uneven parts are padded for
    the one all-gather."""
    k = ctx.n_model
    if k == 1:
        return x
    sizes = [hi - lo for lo, hi in (split_range(n, k, i) for i in range(k))]
    big = max(sizes)
    if x.shape[dim] < big:
        pad = list(x.shape)
        pad[dim] = big - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    out = all_gather(x, dim, ctx.group(MODEL), k)
    if min(sizes) == big:
        return out
    return torch.cat([out.narrow(dim, i * big, s)
                      for i, s in enumerate(sizes)], dim)


# --------------------------------------------------------------------------
# serving: the flash-decode combine over a sequence-sharded cache, and the
# rows of the serve layout's experts over the batch axes (no gradient)
# --------------------------------------------------------------------------

def decode_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   ctx: Ctx) -> torch.Tensor:
    """Decode attention over a cache whose slots "model" splits, from each
    model rank's float32 statistics over its own slots
    (``layers.attend_partial``): the max ``m`` and sum ``l`` (B, Sq, H)
    and the unnormalised output ``o`` (B, Sq, H, hd).  Two all-reduces
    over "model": the max of ``m``, then the sums of ``o`` and ``l``, each
    scaled by exp(m_r - m) first.  A rank with no valid slot has m_r = ``NEG_INF`` (finite) and
    ``l``, ``o`` zero, so its weight is 0.  Returns (B, Sq, H, hd)
    float32, the same on every model rank."""
    if ctx.n_model == 1:
        return o / l[..., None]
    g = ctx.group(MODEL)
    mx = m.clone()
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=g)
    w = torch.exp(m - mx)
    both = torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1)
    dist.all_reduce(both, group=g)
    return both[..., :-1] / both[..., -1:]


def rows_gather(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Every batch rank's rows of ``x`` along dim 0, in block order (one
    all-gather a batch axis of size > 1), with no gradient: the input rows
    of an MoE layer whose expert weights split "e_ff" over the batch axes
    (``partition.serve_rules``)."""
    return gather(x, (ctx.batch_axes,), ctx)


def rows_reduce(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``x`` (every batch rank's rows, or the same rows on every rank)
    summed over the batch ranks, with no gradient: reduce-scattered to
    this rank's rows along dim 0 when it holds a block of them
    (``ctx.rows_split``), else all-reduced.  The return of
    ``rows_gather``'s rows through expert weights split over the batch
    axes."""
    for a in ctx.batch_axes:
        k = ctx.sizes[a]
        if k == 1:
            continue
        if ctx.rows_split:
            x = reduce_scatter(x, 0, ctx.group(a), k)
        else:
            x = x.contiguous().clone()
            dist.all_reduce(x, group=ctx.group(a))
    return x


# --------------------------------------------------------------------------
# a leaf's compute form: the FSDP gathers and the tensor-parallel blocks
# --------------------------------------------------------------------------

class LeafPlan(NamedTuple):
    """How a sharded step turns this rank's block of a leaf into what its
    compute takes, and the gradient back: ``spec`` the leaf at rest;
    ``keep`` the dims that stay this rank's block (the experts' dim, and
    the "model" dims that the compute splits on); ``take`` (dim, [(lo,
    hi), ...], size): the ranges of the leaf, gathered whole (``size``)
    over "model" along ``dim``, that this rank computes on (heads that a
    block cuts mid-head, the mamba ``in_proj``'s x and z halves);
    ``partial``: a leaf replicated over "model" that the rank uses for its
    share of a tensor-parallel region only, so its gradient is a share
    too, summed over "model"."""
    spec: tuple
    keep: tuple = ()
    take: Optional[tuple] = None
    partial: bool = False


def _gather_steps(lp: LeafPlan, ctx: Ctx) -> list:
    """[(dim, axis)]: the all-gathers from a block to the compute form, in
    ``gather``'s order (a dim's minor axis first)."""
    return [(d, a) for d, entry in enumerate(lp.spec) if d not in lp.keep
            for a in reversed(_axes(entry)) if ctx.sizes[a] > 1]


def _take(x: torch.Tensor, take) -> torch.Tensor:
    """The ranges of ``take`` from a leaf gathered over "model", as a new
    tensor (a view would hold the whole leaf)."""
    if take is None:
        return x
    dim, ranges, _ = take
    return torch.cat([x.narrow(dim, lo, hi - lo) for lo, hi in ranges], dim)


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it is a view into a larger storage."""
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone(memory_format=torch.contiguous_format)
    return t


def to_compute(x: torch.Tensor, lp: LeafPlan, ctx: Ctx) -> torch.Tensor:
    """A leaf's compute form from this rank's block (``LeafPlan``)."""
    for d, a in _gather_steps(lp, ctx):
        x = all_gather(x, d, ctx.group(a), ctx.sizes[a])
    return _take(x, lp.take)


def to_block_grad(g: torch.Tensor, lp: LeafPlan, ctx: Ctx) -> torch.Tensor:
    """The gradient of a leaf's compute form, taken back to this rank's
    block: the ranges of ``take`` put in a zero leaf and reduce-scattered
    over "model" (the model ranks' ranges summed, this rank's block kept),
    then ``reduce_grad`` (the batch ranks' sum, FSDP), then, for a
    ``partial`` leaf, all-reduced over "model".  A new tensor, never a
    view into the whole gradient."""
    keep = lp.keep
    if lp.take is not None:
        dim, ranges, size = lp.take
        shape = list(g.shape)
        shape[dim] = size
        z = g.new_zeros(shape)
        off = 0
        for lo, hi in ranges:
            z.narrow(dim, lo, hi - lo).copy_(g.narrow(dim, off, hi - lo))
            off += hi - lo
        g = reduce_scatter(z, dim, ctx.group(MODEL), ctx.n_model)
        keep = keep + (dim,)
    cut = reduce_grad(g, lp.spec, ctx, keep)
    g = g if cut is g else _own(cut)
    if lp.partial and ctx.n_model > 1:
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group(MODEL))
    return g


@functools.cache
def _selective_modes() -> tuple:
    """The dispatch modes of ``torch.utils.checkpoint``'s selective
    checkpoint, or ``RuntimeError`` naming them where this torch has
    neither (its recompute would then replay no gather)."""
    from torch.utils import checkpoint as ck
    names = ("_CachingTorchDispatchMode", "_CachedTorchDispatchMode")
    sac = tuple(getattr(ck, n) for n in names if hasattr(ck, n))
    if len(sac) != len(names):
        raise RuntimeError(
            f"torch {torch.__version__}: torch.utils.checkpoint lacks "
            f"{[n for n in names if not hasattr(ck, n)]}; the per-period "
            f"gathers cannot be hidden from remat 'dots'")
    return sac


@contextlib.contextmanager
def _unseen_by_selective_checkpoint():
    """Hide a gather's ops from a selective checkpoint (remat "dots"),
    whose recompute must replay the ops its forward recorded: a forward
    that takes prefetched leaves runs none, its recompute gathers.  Other
    dispatch modes (a recording, fake tensors) still see them.  The
    selective checkpoint's modes are private classes of
    ``torch.utils.checkpoint`` (checked on torch 2.11 and 2.13): a torch
    without them raises here rather than let the gathers be recorded."""
    from torch.utils import _python_dispatch as pd
    if isinstance(pd._get_current_dispatch_mode(), _selective_modes()):
        with pd._pop_mode_temporarily():
            yield
    else:
        yield


# hooks a test or a probe may add: fn(event, key, tensors), called by a
# ``Gatherer`` as it starts a group's gathers ahead ("start", the buffers),
# finishes them ("wait"), hands them to the group's compute ("take") or
# gathers a group where it is used ("sync", a recompute's included)
ON_GATHER: list = []


class _Gathered(torch.autograd.Function):
    """A group's compute forms from this rank's blocks forward
    (``Gatherer.forward``); each leaf's ``to_block_grad`` backward, so a
    group's whole gradients are freed as its backward ends."""

    @staticmethod
    def forward(ctx_, gatherer, key, names, *blocks):
        ctx_.gatherer, ctx_.names = gatherer, names
        out = gatherer.forward(key, names, blocks)
        return tuple(o.view_as(o) if o is b else o
                     for o, b in zip(out, blocks))

    @staticmethod
    def backward(ctx_, *grads):
        return (None, None, None) + tuple(
            ctx_.gatherer.backward(ctx_.names, grads))


class Gatherer:
    """One step's gathers of the leaves a forward takes from this rank's
    blocks, a group at a time (a period of the block pattern, or a leaf
    outside the periods at its use), under ``plan`` ({name: LeafPlan}) on
    the step's context ``ctx``, whose ``split`` says whether a gradient
    sums over the batch ranks.

    ``gatherer(key, named)`` returns the compute forms of the blocks
    ``named`` ([(name, block)]) through ``_Gathered``.  ``prefetch(key,
    named)`` starts the first all-gather of each leaf of a group ahead
    (``async_op=True``) and ``wait(key)`` finishes them; the next call
    with ``key`` takes those tensors, once: a recompute under a checkpoint
    gathers again, synchronously.  A forward waits on a handle before the
    checkpoint of the group that uses it, so no handle crosses a
    checkpoint's boundary unwaited."""

    def __init__(self, ctx: Ctx, plan: dict):
        self.ctx, self.plan = ctx, plan
        self.pending: dict = {}
        self.ready: dict = {}

    @staticmethod
    def _emit(event, key, tensors) -> None:
        for fn in ON_GATHER:
            fn(event, key, tensors)

    def prefetch(self, key, named) -> None:
        started = []
        for n, b in named:
            steps = _gather_steps(self.plan[n], self.ctx)
            if steps:
                d, a = steps[0]
                buf, work = start_gather(b.detach(), d, self.ctx.group(a),
                                         self.ctx.sizes[a])
                started.append((buf, work, d))
            else:
                started.append((None, None, None))
        self.pending[key] = (named, started)
        self._emit("start", key, [s[0] for s in started if s[0] is not None])

    def wait(self, key) -> None:
        named, started = self.pending.pop(key)
        out = []
        for (n, b), (buf, work, d) in zip(named, started):
            lp = self.plan[n]
            steps = _gather_steps(lp, self.ctx)
            if not steps and lp.take is None:
                out.append(b)
                continue
            x = b.detach()
            if buf is not None:
                if work is not None:
                    work.wait()
                x, steps = buf.movedim(0, d), steps[1:]
            for dd, a in steps:
                x = all_gather(x, dd, self.ctx.group(a), self.ctx.sizes[a])
            out.append(_take(x, lp.take))
        self.ready[key] = out
        self._emit("wait", key, [o for o, (_, b) in zip(out, named)
                                 if o is not b])

    def forward(self, key, names, blocks) -> list:
        got = self.ready.pop(key, None)
        if got is not None:
            self._emit("take", key, [o for o, b in zip(got, blocks)
                                     if o is not b])
            return got
        with _unseen_by_selective_checkpoint():
            out = [to_compute(b, self.plan[n], self.ctx)
                   for n, b in zip(names, blocks)]
        self._emit("sync", key, [o for o, b in zip(out, blocks) if o is not b])
        return out

    def backward(self, names, grads) -> list:
        return [to_block_grad(g, self.plan[n], self.ctx)
                for n, g in zip(names, grads)]

    def __call__(self, key, named) -> list:
        names = tuple(n for n, _ in named)
        blocks = [b for _, b in named]
        if torch.is_grad_enabled() and any(b.requires_grad for b in blocks):
            return list(_Gathered.apply(self, key, names, *blocks))
        return self.forward(key, names, blocks)


__all__ = ["Ctx", "Gatherer", "LeafPlan", "ON_GATHER", "ONE_DEVICE", "Share",
           "all_gather", "block", "decode_combine", "gather", "global_norm",
           "model_copy", "model_gather", "model_reduce", "model_slice",
           "model_sum", "owns", "reduce_grad", "reduce_scatter",
           "rows_gather", "rows_reduce", "split_range", "start_gather",
           "to_block_grad", "to_compute", "vocab_xent"]
