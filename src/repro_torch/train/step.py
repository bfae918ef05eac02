"""Train and serve steps (port of ``repro.train.step``), for every
configuration the model runs (attn/swa/hymba/mamba/mlstm/slstm blocks,
dense, MoE or no FFN, rotary or learned positions, whisper's
encoder-decoder, whose train step and prefill take the frames), on one
device or over a mesh.

``init_state`` + ``make_train_step(cfg, mesh=None, opt_cfg)(state, batch)
-> (state, metrics)`` is the reference's training API: the loss
(``lm_loss``, or ``lm_loss_chunked`` when ``cfg.xent_chunk`` is set) and
its gradient by autograd (the LM kernels' gradients are the backward
kernels, ``kernels/ops.py``), then AdamW (``train/optim.py``).  With
``cfg.microbatches == 1`` the gradients keep the parameter dtype, as
``jax.value_and_grad``'s do; with more, a Python loop over the
microbatches adds float32 gradients and divides them, the loss and the
parts' means by their number, as the reference's ``lax.scan``.  The
update writes the state's parameters and moments in place and returns
the same dicts; ``step`` is a new int32 tensor.  Metrics are 0-d tensors
on the device: the step reads nothing back to the host.

The mesh side: ``state_shardings(cfg, mesh)`` resolves the reference's
logical specs (``transformer.param_specs``) with
``sharding.partition``'s rules, and ``shard_state`` keeps this rank's
block of every leaf (the counterpart of ``jax.device_put(state,
shardings)``): "embed" over the batch axes (FSDP), vocab, heads, ff,
expert and ssm over "model".  A step with a mesh takes the global batch
on every rank and, in the place of XLA's partitioner
(``sharding/spmd.py``), under ``tp_plan``:

  1. keeps the "model" blocks that its compute splits on (the
     reference's tensor parallelism: heads, ff, vocab and the SSM's
     channels, ``transformer.tp_layout``; the experts' dim, expert
     parallelism), and gathers the rest where it is used: a period of the
     block pattern at a time, inside the period's ``remat`` checkpoint
     (a recompute gathers again), the next period's all-gathers started
     (``async_op=True``) before the current one runs, and the leaves
     outside the periods (``embed``, ``lm_head``, ``final_norm``,
     ``dec_pos``, the encoder's) at their use (``spmd.Gatherer``);
  2. runs the forward and backward on this rank's rows
     (``partition.batch_pspec``; every row when the batch axes do not
     divide the batch), each tensor-parallel region between a
     ``spmd.model_copy`` and a ``spmd.model_sum``, the head and the
     losses vocab-parallel, the losses' means global sums over global
     counts;
  3. cuts each period's gradients back to blocks as its backward ends
     (``spmd.to_block_grad``: reduce-scatter along the FSDP dim,
     all-reduce where there is none, and over "model" for a leaf that a
     region uses whole), so only one period's whole gradients live at a
     time;
  4. updates the blocks in place, clipped by the norm of the full
     gradient (``spmd.global_norm``).

Microbatches whose segments differ between the batch ranks
(``split_microbatch_grads``) make every compute form up front
(``gather_params``) and cut the gradients back at the end, so the batch
ranks' collectives stay in step; their compute splits over "model" all
the same.  Without a mesh the same step runs on ``spmd.ONE_DEVICE``, a
context of one device, where every gather, sum and cut is the leaf
itself.  With microbatches and a split batch, a microbatch may span
several batch ranks and a rank's rows several microbatches, whatever the
two numbers are: each rank runs one gradient for each of its rows'
segments of a microbatch.

``make_prefill`` and ``make_serve_step`` return plain functions of
(params, tensors); as in the reference they discard ``forward``'s aux
(the MoE loss).  With a mesh they take the parameters' blocks, the
global tokens and this rank's blocks of the cache
(``transformer.init_cache(..., ctx=)`` under ``transformer.cache_specs``:
rows over the batch axes; an attn layer's slots over "model", attended
in the flash-decode form; the SSM's channels over "model", the split its
compute takes, so no state moves; the sliding-window rings, the xLSTM
states and whisper's cross keys whole on every model rank, gathered
after each step where a rank computes them in part), run the same
tensor-parallel forward, and return the logits of every row and every
vocab column.  The parameters are at rest in the train layout
(``state_shardings(cfg, mesh)``), whose FSDP blocks the steps gather a
period at a time each call, or, with ``cfg.serve_weights_stationary``,
in the reference's weights-stationary layout
(``state_shardings(cfg, mesh, rules=partition.serve_rules(mesh))``: no
FSDP, the experts' "e_ff" over the batch axes), where the steps gather
nothing over the batch axes (``serve_shardings``, ``reshard_params``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..kernels.ref import div_const
from ..models import transformer
from ..models.config import ModelConfig
from ..sharding import partition, spmd
from . import optim


def mesh_axes_of(mesh):
    return partition.batch_axes(mesh) + ("model",) if mesh is not None \
        else ("data", "model")


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

def init_state(cfg: ModelConfig, generator: torch.Generator, max_seq: int = 0,
               device=None) -> dict:
    """{"params": Params with gradients on, "opt": float32 moments,
    "step": int32 0-d tensor}, all on ``device`` (the card unless the
    caller asks for the CPU; the generator must live there too)."""
    params = transformer.make_params(cfg, generator, device=device,
                                     max_seq=max_seq)
    return train_state(params)


def train_state(params, opt=None, step=None) -> dict:
    """A train state around ``params`` (their gradients turned on), with
    zero moments and step 0 unless given."""
    for p in params.parameters():
        p.requires_grad_(True)
    dev = next(params.parameters()).device
    return {"params": params,
            "opt": optim.init_moments(params) if opt is None else opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)
            if step is None else step}


@functools.lru_cache(maxsize=64)
def state_shapes_and_specs(cfg: ModelConfig, max_seq: int = 0):
    """(state_shapes, state_logical_specs) without allocating anything:
    the shapes are tensors on ``torch.device("meta")``, in the train
    state's layout with the parameters as {name: tensor}; made once a
    (cfg, max_seq), as the reference's, so a sharded step's plan makes no
    tensor after its first (a dry run's memory count sees none)."""
    params = transformer.make_params(cfg, None, device="meta",
                                     max_seq=max_seq)
    pshapes = {n: p.detach() for n, p in params.named_parameters()}
    f32 = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
           for n, p in pshapes.items()}
    specs = transformer.param_specs(cfg, max_seq)
    shapes = {"params": pshapes, "opt": {"m": f32, "v": dict(f32)},
              "step": torch.empty((), dtype=torch.int32, device="meta")}
    return shapes, {"params": specs, "opt": {"m": specs, "v": specs},
                    "step": ()}


def state_shardings(cfg: ModelConfig, mesh, max_seq: int = 0, rules=None):
    """(shardings, shapes): a ``partition.Sharding`` a leaf of the train
    state, in ``state_shapes_and_specs``' layout."""
    shapes, specs = state_shapes_and_specs(cfg, max_seq)
    return partition.tree_shardings(specs, shapes, mesh, rules), shapes


def _cut(t, sh, ctx):
    return spmd.block(t.detach(), sh.spec, ctx).clone(
        memory_format=torch.contiguous_format)


def shard_params(params, shardings: dict):
    """This rank's blocks of full parameters under ``shardings`` ({name:
    Sharding}, ``state_shardings(...)[0]["params"]``), as a new
    ``Params``."""
    ctx = spmd.Ctx.of(next(iter(shardings.values())).mesh)
    return transformer.params_from_named(
        {n: _cut(p, shardings[n], ctx) for n, p in params.named_parameters()})


def shard_state(state: dict, shardings: dict) -> dict:
    """This rank's blocks of a full train state under ``shardings`` (from
    ``state_shardings``), as new contiguous tensors; every rank passes the
    same full state.  The counterpart of ``jax.device_put(state,
    shardings)``."""
    ctx = spmd.Ctx.of(shardings["step"].mesh)
    opt = {k: {n: _cut(t, shardings["opt"][k][n], ctx)
               for n, t in state["opt"][k].items()} for k in ("m", "v")}
    return train_state(shard_params(state["params"], shardings["params"]),
                       opt, state["step"].clone())


def _serve_rules(cfg: ModelConfig, mesh):
    """The serve steps' rules: ``partition.serve_rules`` with
    ``cfg.serve_weights_stationary``, else None (the train layout's)."""
    return partition.serve_rules(mesh) if cfg.serve_weights_stationary \
        else None


def serve_shardings(cfg: ModelConfig, mesh, max_seq: int = 0):
    """``state_shardings`` of the serve steps' parameters (``_serve_rules``:
    the weights-stationary layout with ``cfg.serve_weights_stationary``,
    else the train layout)."""
    return state_shardings(cfg, mesh, max_seq, _serve_rules(cfg, mesh))


def reshard_params(params, src: dict, dst: dict):
    """This rank's blocks under ``dst`` ({name: Sharding}) of parameters
    held as its blocks under ``src``, a leaf at a time (each gathered
    whole, then cut), as a new ``Params``: the serve engine's one change
    from the train layout to the weights-stationary one."""
    ctx = spmd.Ctx.of(next(iter(dst.values())).mesh)
    return transformer.params_from_named(
        {n: p if src[n].spec == dst[n].spec else
         _cut(spmd.gather(p.detach(), src[n].spec, ctx), dst[n], ctx)
         for n, p in params.named_parameters()})


def _kept_dims(logical: tuple, spec: tuple) -> tuple:
    """The dims a sharded step keeps split beside the tensor-parallel
    ones: the experts' dim where "model" splits it (expert parallelism)
    and their hidden dim where the batch axes split it (the serve
    layout)."""
    return tuple(d for d, (name, entry) in
                 enumerate(zip(logical, spec + (None,) * len(logical)))
                 if name in ("expert", "e_ff") and entry is not None)


def tp_plan(cfg: ModelConfig, mesh, params, rules=None) -> dict:
    """{name: ``spmd.LeafPlan``} of the parameters at rest under the
    mesh's ``rules`` (its default rules unless given; ``mesh`` a mesh or
    an ``spmd.Ctx``): the experts' dims (and their "e_ff" block under
    ``partition.serve_rules``) and the dims the tensor-parallel compute
    splits on kept as this rank's blocks, the rest gathered (FSDP), the
    heads a block cuts taken from the leaf gathered over "model", the
    leaves whole on every model rank inside a tensor-parallel region
    marked ``partial`` (``transformer.tp_layout``)."""
    max_seq = params["dec_pos"].shape[0] if "dec_pos" in params else 0
    shardings, _ = state_shardings(cfg, mesh, max_seq, rules)
    logical = transformer.param_specs(cfg, max_seq)
    specs = {n: sh.spec for n, sh in shardings["params"].items()}
    ctx = mesh if isinstance(mesh, spmd.Ctx) else spmd.Ctx.of(mesh)
    lay = transformer.tp_layout(cfg, specs, ctx.n_model, ctx.model_index)
    return {n: spmd.LeafPlan(sp, _kept_dims(logical[n], sp) + lay[n][0],
                             lay[n][1], lay[n][2])
            for n, sp in specs.items()}


def _planner(cfg: ModelConfig, mesh, rules=None):
    """``tp_plan`` for a step's parameters under ``rules``, made once a
    ``max_seq`` (``mesh`` a mesh or an ``spmd.Ctx``)."""
    plans = {}

    def plan(params):
        key = params["dec_pos"].shape[0] if "dec_pos" in params else 0
        if key not in plans:
            plans[key] = tp_plan(cfg, mesh, params, rules)
        return plans[key]
    return plan


def gather_params(params, plan: dict, ctx: spmd.Ctx, grad: bool = False):
    """A ``Params`` of every leaf's compute form under ``plan``
    (``tp_plan``'s, ``spmd.to_compute``) made at once, with gradients on
    when ``grad``."""
    full = transformer.params_from_named(
        {n: spmd.to_compute(p.detach(), plan[n], ctx)
         for n, p in params.named_parameters()})
    if grad:
        for p in full.parameters():
            p.requires_grad_(True)
    return full


def _loss_fn(cfg: ModelConfig):
    """(params, tokens, labels, frames, ctx) -> (loss, {"nll", "aux"}) of
    one (micro)batch; ``ctx`` as ``transformer.lm_loss``'s."""

    def loss_fn(params, tokens, labels, frames, ctx):
        if cfg.xent_chunk:
            x, _, aux = transformer.forward(cfg, params, tokens, mode="train",
                                            frames=frames, skip_head=True,
                                            ctx=ctx)
            head = transformer.head_weight(cfg, params, ctx)
            return transformer.lm_loss_chunked(
                cfg, x, head.to(x.dtype), labels, aux,
                final_softcap=cfg.final_softcap, ctx=ctx)
        logits, _, aux = transformer.forward(cfg, params, tokens,
                                             mode="train", frames=frames,
                                             ctx=ctx)
        return transformer.lm_loss(cfg, logits, labels, aux, ctx=ctx)
    return loss_fn


def _grads_of(loss, leaves):
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, gs)]


def _check_microbatches(cfg: ModelConfig, B: int) -> None:
    if B % cfg.microbatches:
        raise ValueError(f"{cfg.name}: batch {B} is not a multiple of "
                         f"{cfg.microbatches} microbatches")


def make_grad_fn(cfg: ModelConfig, ctx=None):
    """(params, batch) -> (loss, parts, grads): the train step's loss, its
    parts and the gradient of every parameter in ``named_parameters``
    order (zeros for one the loss does not reach), microbatched as
    ``cfg.microbatches`` says, each microbatch on every row it holds.
    ``ctx`` is a sharded step's view of the mesh (``sharding.spmd.Ctx``):
    with a split batch the loss and its parts are this rank's shares of
    the global ones (one microbatch; ``split_microbatch_grads`` runs
    more)."""
    loss_fn = _loss_fn(cfg)

    def grad_fn(params, batch):
        leaves = [p for _, p in params.named_parameters()]
        tokens, labels = batch["tokens"], batch["labels"]
        frames = batch.get("frames")
        B, mb = tokens.shape[0], cfg.microbatches
        _check_microbatches(cfg, B)
        if mb == 1:
            loss, parts = loss_fn(params, tokens, labels, frames, ctx)
            return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
                _grads_of(loss, leaves)
        n = B // mb
        acc, loss_sum, seen = None, None, []
        for i in range(mb):
            sl = slice(i * n, (i + 1) * n)
            loss, parts = loss_fn(params, tokens[sl], labels[sl],
                                  None if frames is None else frames[sl], ctx)
            gs = _grads_of(loss, leaves)
            acc = [g.float() for g in gs] if acc is None else \
                [a + g.float() for a, g in zip(acc, gs)]
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
            seen.append({k: v.detach() for k, v in parts.items()})
        parts = {k: torch.stack([p[k] for p in seen]).mean() for k in seen[0]}
        return div_const(loss_sum, mb), parts, [div_const(a, mb) for a in acc]

    return grad_fn


def segments(B: int, mb: int, n: int, r: int) -> list:
    """[(i, lo, hi)]: the rows of microbatch i (the global rows [i B/mb,
    (i+1) B/mb)) that batch rank r holds (its block [r B/n, (r+1) B/n)),
    as rows lo:hi of its block, in microbatch order."""
    m, per = B // mb, B // n
    out = []
    for i in range(mb):
        lo, hi = max(i * m, r * per), min((i + 1) * m, (r + 1) * per)
        if lo < hi:
            out.append((i, lo - r * per, hi - r * per))
    return out


def waves(B: int, mb: int, n: int) -> list:
    """The wave of each microbatch over n batch ranks: one after the
    wave of the microbatch before it when the two share a rank, else 0.
    A wave holds at most one segment a rank, and every segment of a
    microbatch runs in the same wave."""
    m, per = B // mb, B // n
    out = [0]
    for i in range(1, mb):
        out.append(out[-1] + 1 if (i * m) % per else 0)
    return out


def split_microbatch_grads(cfg: ModelConfig, ctx: spmd.Ctx, params,
                           batch: dict):
    """``make_grad_fn``'s (loss, parts, grads) as this rank's shares, for
    ``cfg.microbatches`` > 1 over a split batch (the global batch in
    ``batch``; this rank holds the block ``ctx.batch_rows``).  Microbatch
    i is the global rows [i B/mb, (i+1) B/mb), as in the reference; the
    rank runs one gradient a segment (its rows of a microbatch,
    ``segments``), whose losses are sums over the microbatch's global
    label count (one all-reduce of the (mb,) counts over the batch axes)
    and rows, so the ranks' shares add up to the microbatch's means.  The
    loss, parts and float32 gradients are the segments' sums over mb: the
    reference's means over the microbatches once summed over the batch
    ranks.  With MoE layers the segments run in ``waves``, every rank in
    step, each wave's forward followed by one all-reduce of its (mb,
    layers, E) top-1 counts (``spmd.Share``) before its backward."""
    loss_fn = _loss_fn(cfg)
    leaves = [p for _, p in params.named_parameters()]
    B, mb, n = batch["tokens"].shape[0], cfg.microbatches, ctx.n_batch
    _check_microbatches(cfg, B)
    rows = {k: ctx.batch_rows(v) for k, v in batch.items()}
    mine = {i: (lo, hi) for i, lo, hi in segments(B, mb, n, ctx.batch_index)}
    labels = rows["labels"]
    zero = torch.zeros((), dtype=torch.float32, device=labels.device)
    counts = ctx.sum_over(torch.stack([
        (labels[mine[i][0]:mine[i][1]] >= 0).sum(dtype=torch.float32)
        if i in mine else zero for i in range(mb)]), ctx.batch_axes)
    n_moe = sum("ffn" in p for p in params["layers"]) if cfg.is_moe else 0
    if n_moe:
        wave = waves(B, mb, n)
        schedule = [[i for i in mine if wave[i] == w]
                    for w in range(max(wave) + 1)]
    else:
        schedule = [[i] for i in mine]
    acc = loss_sum = parts_sum = None
    for group in schedule:
        if group:
            (i,) = group
            lo, hi = mine[i]
            share = spmd.Share(B // mb, counts[i])
            loss, parts = loss_fn(
                params, rows["tokens"][lo:hi], labels[lo:hi],
                rows["frames"][lo:hi] if "frames" in rows else None,
                dataclasses.replace(ctx, split=False, share=share))
        if n_moe:           # the wave's top-1 counts, summed
            c = torch.zeros((mb, n_moe, cfg.n_experts), dtype=torch.float32,
                            device=labels.device)
            if group:
                c[i] = share.counts()
            c = ctx.sum_over(c, ctx.batch_axes)
            if group:
                share.set_fractions(c[i])
        if not group:
            continue
        gs = _grads_of(loss, leaves)
        loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
        if n_moe:
            lb, parts["aux"] = share.balance(cfg.n_experts, cfg.router_zloss)
            loss = loss + transformer.AUX_COEF * lb
        acc = [g.float() for g in gs] if acc is None else \
            [a + g.float() for a, g in zip(acc, gs)]
        loss_sum = loss if loss_sum is None else loss_sum + loss
        parts_sum = parts if parts_sum is None else \
            {k: parts_sum[k] + v for k, v in parts.items()}
    return (div_const(loss_sum, mb),
            {k: div_const(v, mb) for k, v in parts_sum.items()},
            [div_const(a, mb) for a in acc])


def make_train_step(cfg: ModelConfig, mesh=None,
                    opt_cfg: optim.AdamWConfig = optim.AdamWConfig()):
    """(state, batch) -> (state, metrics): batch {"tokens" (B, S),
    "labels" (B, S) (< 0: padding), "frames" (B, enc_seq, D) for an
    encoder-decoder}; metrics {"loss", "grad_norm", "lr", "nll", "aux"}.
    With ``mesh`` (a ``DeviceMesh`` with the axes ("pod",) "data",
    "model", from ``launch.mesh``), the state is this rank's blocks
    (``shard_state``), every rank passes the global batch, and the
    metrics are the global ones on every rank."""
    if isinstance(mesh, optim.AdamWConfig):
        raise TypeError("make_train_step(cfg, mesh=None, opt_cfg=...): the "
                        "second argument is the mesh; pass the optimizer "
                        "as opt_cfg=")
    transformer.check_supported(cfg)
    # one device runs the same body on a context of one: every gather,
    # cut and sum there is the leaf itself, and the norm the same sum
    base = spmd.ONE_DEVICE if mesh is None else spmd.Ctx.of(mesh)
    planner = _planner(cfg, base)

    def sharded_step(state, batch):
        params = state["params"]
        plan = planner(params)
        ctx = base.for_batch(batch["tokens"].shape[0])
        named = list(params.named_parameters())
        rows = {k: ctx.batch_rows(v) for k, v in batch.items()}
        if mesh is not None and not (ctx.split and cfg.microbatches > 1):
            # the forward gathers a period at a time, each period's
            # gradients cut back to blocks as its backward ends
            gctx = dataclasses.replace(ctx, gather=spmd.Gatherer(ctx, plan))
            loss, parts, blocks = make_grad_fn(cfg, gctx)(params, rows)
        else:
            # one device, or microbatches whose segments differ between
            # the batch ranks: every compute form made up front and every
            # gradient cut back at the end
            full = gather_params(params, plan, ctx, grad=True)
            if ctx.split and cfg.microbatches > 1:
                loss, parts, grads = split_microbatch_grads(cfg, ctx, full,
                                                            batch)
            else:
                loss, parts, grads = make_grad_fn(cfg, ctx)(full, rows)
            del full
            blocks = [spmd.to_block_grad(g, plan[nm], ctx)
                      for (nm, _), g in zip(named, grads)]
            del grads
        specs = [plan[nm].spec for nm, _ in named]
        gnorm = spmd.global_norm(blocks, specs, ctx)
        stats = optim.adamw_update(opt_cfg, named, blocks, state["opt"],
                                   state["step"], gnorm=gnorm)
        if ctx.split:           # the shares' sums: one all-reduce an axis
            loss, nll, aux = ctx.batch_sum(
                torch.stack([loss, parts["nll"], parts["aux"]]))
            parts = {"nll": nll, "aux": aux}
        new_state = {"params": params, "opt": state["opt"],
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **stats, **parts}

    return sharded_step


# --------------------------------------------------------------------------
# serve steps
# --------------------------------------------------------------------------


def _sharded_serving(cfg: ModelConfig, mesh):
    """(params, B) -> the context of a serve step's call over ``mesh``,
    whose forward gathers the blocks a period at a time (``ctx.gather``)
    and keeps the tensor-parallel blocks; with
    ``cfg.serve_weights_stationary`` the parameters are at rest under
    ``partition.serve_rules``, and only a leaf whose "model" block is not
    its compute's split is gathered (over "model")."""
    base = spmd.Ctx.of(mesh)
    planner = _planner(cfg, mesh, _serve_rules(cfg, mesh))

    def setup(params, B):
        ctx = base.for_batch(B)
        return dataclasses.replace(
            ctx, gather=spmd.Gatherer(ctx, planner(params)))
    return setup


def _all_rows(x, ctx: spmd.Ctx):
    """Every rank's rows of ``x`` (the rank's own when the batch is not
    split)."""
    return spmd.gather(x, (ctx.batch_axes,), ctx) if ctx.split else x


def make_prefill(cfg: ModelConfig, mesh=None):
    """(params, tokens (B, S), cache, frames=None) -> (logits (B, vocab)
    at the last position, new_cache); ``frames`` (B, enc_seq, D) for an
    encoder-decoder, whose prefill runs the encoder and stores its
    projected keys and values in the cache.  The head runs on the last
    position only: the same logits as the reference's full head sliced
    at -1.  With ``mesh``: see the module's note."""
    setup = None if mesh is None else _sharded_serving(cfg, mesh)

    def prefill(params, tokens, cache, frames=None):
        ctx = None
        if setup is not None:
            ctx = setup(params, tokens.shape[0])
            tokens, frames = ctx.batch_rows(tokens), ctx.batch_rows(frames)
        # serving discards the MoE aux: no collective for its global means
        x, new_cache, _ = transformer.forward(
            cfg, params, tokens, mode="prefill", cache=cache, frames=frames,
            skip_head=True, ctx=ctx and ctx.local())
        logits = transformer.head(cfg, params, x[:, -1:], ctx)[:, 0]
        if ctx is None:
            return logits, new_cache
        return _all_rows(transformer.full_logits(cfg, logits, ctx),
                         ctx), new_cache

    return prefill


def make_serve_step(cfg: ModelConfig, mesh=None):
    """One-token decode: (params, cache, token (B, 1), pos int) ->
    (logits (B, vocab), new_cache).  With ``mesh``: see the module's
    note (``cfg.serve_weights_stationary`` takes the parameters in the
    reference's ``partition.serve_rules`` layout)."""
    setup = None if mesh is None else _sharded_serving(cfg, mesh)

    def serve_step(params, cache, token, pos):
        ctx = None
        if setup is not None:
            ctx = setup(params, token.shape[0])
            token = ctx.batch_rows(token)
        logits, new_cache, _ = transformer.forward(
            cfg, params, token, mode="decode", cache=cache, pos=pos,
            ctx=ctx and ctx.local())
        logits = logits[:, 0]
        if ctx is None:
            return logits, new_cache
        return _all_rows(transformer.full_logits(cfg, logits, ctx),
                         ctx), new_cache

    return serve_step
