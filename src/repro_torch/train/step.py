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
(``sharding/spmd.py``):

  1. gathers every leaf to full, except the experts' "expert" dim, which
     stays this rank's E/n (``models/moe.py``'s expert parallelism);
  2. runs the one-device forward and backward on this rank's rows
     (``partition.batch_pspec``; every row when the batch axes do not
     divide the batch), the losses' means global sums over global counts;
  3. sums the gradients over the batch ranks and cuts them to blocks
     (reduce-scatter along the FSDP dim, all-reduce where there is none);
  4. updates the blocks in place, clipped by the norm of the full
     gradient (``spmd.global_norm``).

Without a mesh the same step runs on ``spmd.ONE_DEVICE``, a context of
one device, where every gather, sum and cut is the leaf itself.

The non-expert compute is repeated on every "model" rank: the same
results as the reference's, without its split of heads and ff.  With
microbatches and a split batch, each rank runs whole microbatches of its
own rows, so ``microbatches`` must be a multiple of the batch ranks
(else ``NotImplementedError``, ROADMAP Queue 1 item 24).

``make_prefill`` and ``make_serve_step`` return plain functions of
(params, tensors); as in the reference they discard ``forward``'s aux
(the MoE loss).  With a mesh they take the parameters' blocks (gathered
each call, the experts kept split), the global tokens and this rank's
rows of the cache (``transformer.cache_specs``: rows over the batch
axes, replicated over "model"), and return the logits of every row.
"""
from __future__ import annotations

import dataclasses

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


def state_shapes_and_specs(cfg: ModelConfig, max_seq: int = 0):
    """(state_shapes, state_logical_specs) without allocating anything:
    the shapes are tensors on ``torch.device("meta")``, in the train
    state's layout with the parameters as {name: tensor}."""
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


def _expert_dims(logical: tuple, spec: tuple) -> tuple:
    """The dims a sharded step keeps split: the experts' dim where "model"
    splits it (expert parallelism)."""
    return tuple(d for d, (name, entry) in
                 enumerate(zip(logical, spec + (None,) * len(logical)))
                 if name == "expert" and entry is not None)


def param_plan(cfg: ModelConfig, mesh, params) -> dict:
    """{name: (spec, kept dims)} of the parameters at rest under the
    mesh's default rules (learned positions read ``max_seq`` off
    ``dec_pos``, which no rule splits by rows)."""
    max_seq = params["dec_pos"].shape[0] if "dec_pos" in params else 0
    shardings, _ = state_shardings(cfg, mesh, max_seq)
    logical = transformer.param_specs(cfg, max_seq)
    return {n: (sh.spec, _expert_dims(logical[n], sh.spec))
            for n, sh in shardings["params"].items()}


def _planner(cfg: ModelConfig, mesh):
    """``param_plan`` for a step's parameters, made once a ``max_seq``
    (``mesh`` a mesh or an ``spmd.Ctx``)."""
    plans = {}

    def plan(params):
        key = params["dec_pos"].shape[0] if "dec_pos" in params else 0
        if key not in plans:
            plans[key] = param_plan(cfg, mesh, params)
        return plans[key]
    return plan


def gather_params(params, plan: dict, ctx: spmd.Ctx, grad: bool = False):
    """A ``Params`` of every leaf gathered from this rank's block (the
    experts' dim kept split), with gradients on when ``grad``."""
    full = transformer.params_from_named(
        {n: spmd.gather(p.detach(), plan[n][0], ctx, plan[n][1])
         for n, p in params.named_parameters()})
    if grad:
        for p in full.parameters():
            p.requires_grad_(True)
    return full


def make_grad_fn(cfg: ModelConfig, ctx=None):
    """(params, batch) -> (loss, parts, grads): the train step's loss, its
    parts and the gradient of every parameter in ``named_parameters``
    order (zeros for one the loss does not reach), microbatched as
    ``cfg.microbatches`` says.  ``ctx`` is a sharded step's view of the
    mesh (``sharding.spmd.Ctx``): with a split batch the loss and its
    parts are this rank's shares of the global ones."""

    def loss_fn(params, tokens, labels, frames):
        """(loss, {"nll", "aux"}) of one (micro)batch."""
        if cfg.xent_chunk:
            x, _, aux = transformer.forward(cfg, params, tokens, mode="train",
                                            frames=frames, skip_head=True,
                                            ctx=ctx)
            head = params["embed"].T if cfg.tie_embeddings \
                else params["lm_head"]
            return transformer.lm_loss_chunked(
                cfg, x, head.to(x.dtype), labels, aux,
                final_softcap=cfg.final_softcap, ctx=ctx)
        logits, _, aux = transformer.forward(cfg, params, tokens,
                                             mode="train", frames=frames,
                                             ctx=ctx)
        return transformer.lm_loss(cfg, logits, labels, aux, ctx=ctx)

    def grads_of(loss, leaves):
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def grad_fn(params, batch):
        leaves = [p for _, p in params.named_parameters()]
        tokens, labels = batch["tokens"], batch["labels"]
        frames = batch.get("frames")
        B, mb = tokens.shape[0], cfg.microbatches
        if B % mb:
            raise ValueError(f"{cfg.name}: batch {B} is not a multiple of "
                             f"{mb} microbatches")
        if mb == 1:
            loss, parts = loss_fn(params, tokens, labels, frames)
            return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
                grads_of(loss, leaves)
        n = B // mb
        acc, loss_sum, seen = None, None, []
        for i in range(mb):
            sl = slice(i * n, (i + 1) * n)
            loss, parts = loss_fn(params, tokens[sl], labels[sl],
                                  None if frames is None else frames[sl])
            gs = grads_of(loss, leaves)
            acc = [g.float() for g in gs] if acc is None else \
                [a + g.float() for a, g in zip(acc, gs)]
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
            seen.append({k: v.detach() for k, v in parts.items()})
        parts = {k: torch.stack([p[k] for p in seen]).mean() for k in seen[0]}
        return div_const(loss_sum, mb), parts, [div_const(a, mb) for a in acc]

    return grad_fn


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
        full = gather_params(params, plan, ctx, grad=True)
        rows = {k: ctx.batch_rows(v) for k, v in batch.items()}
        mb, n = cfg.microbatches, ctx.n_batch
        if ctx.split and mb > 1:
            # whole microbatches of this rank's rows: local means
            if mb % n:
                raise NotImplementedError(
                    f"{cfg.name}: {mb} microbatches over {n} batch ranks: "
                    f"not ported yet: microbatches the batch ranks do not "
                    f"divide (item 24) -- see ROADMAP.md Queue 1")
            loss, parts, grads = make_grad_fn(
                dataclasses.replace(cfg, microbatches=mb // n), ctx.local())(
                    full, rows)
            loss, grads = div_const(loss, n), [div_const(g, n) for g in grads]
            parts = {k: div_const(v, n) for k, v in parts.items()}
        else:
            loss, parts, grads = make_grad_fn(cfg, ctx)(full, rows)
        del full
        named = list(params.named_parameters())
        specs = [plan[nm][0] for nm, _ in named]
        blocks = [spmd.reduce_grad(g, plan[nm][0], ctx, plan[nm][1])
                  for (nm, _), g in zip(named, grads)]
        del grads
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
    """(params, B) -> (ctx of a call, the parameters gathered) for a serve
    step over ``mesh``."""
    base, planner = spmd.Ctx.of(mesh), _planner(cfg, mesh)

    def setup(params, B):
        ctx = base.for_batch(B)
        return ctx, gather_params(params, planner(params), ctx)
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
            ctx, params = setup(params, tokens.shape[0])
            tokens, frames = ctx.batch_rows(tokens), ctx.batch_rows(frames)
        # serving discards the MoE aux: no collective for its global means
        x, new_cache, _ = transformer.forward(
            cfg, params, tokens, mode="prefill", cache=cache, frames=frames,
            skip_head=True, ctx=ctx and ctx.local())
        logits = transformer.head(cfg, params, x[:, -1:])[:, 0]
        return (logits if ctx is None else _all_rows(logits, ctx)), new_cache

    return prefill


def make_serve_step(cfg: ModelConfig, mesh=None):
    """One-token decode: (params, cache, token (B, 1), pos int) ->
    (logits (B, vocab), new_cache).  With ``mesh``: see the module's
    note."""
    setup = None if mesh is None else _sharded_serving(cfg, mesh)

    def serve_step(params, cache, token, pos):
        ctx = None
        if setup is not None:
            ctx, params = setup(params, token.shape[0])
            token = ctx.batch_rows(token)
        logits, new_cache, _ = transformer.forward(
            cfg, params, token, mode="decode", cache=cache, pos=pos,
            ctx=ctx and ctx.local())
        logits = logits[:, 0]
        return (logits if ctx is None else _all_rows(logits, ctx)), new_cache

    return serve_step
