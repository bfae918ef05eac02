"""Mixture-of-Experts layer in PyTorch (port of ``repro.models.moe``):
GShard-style top-k routing with token dropping at a capacity factor, for
qwen3-moe and moonshot.

Function by function as the reference:

  1. ``route``: the router product in float32, top-k experts per token,
     gates renormalised over the chosen k, the switch load-balance loss
     plus ``router_zloss`` times the z-loss;
  2. ``_positions_in_expert``: the running index of each (token, choice)
     within its expert, capacity C = ceil(S·k·cf / E);
  3. ``_dispatch``: the inverse map (B, E, C) -> source token, overflow
     written to a sentinel column C and sliced away, then one gather;
  4. ``_expert_ffn``: three batched products over the experts, in the
     activations' dtype (the reference leaves them to XLA outside any
     Pallas kernel; here they go to ``torch.einsum``);
  5. ``_combine_local``: each token's k expert outputs, gate-weighted,
     added one choice at a time in the expert output's dtype.

``moe_einsum`` is the reference's one-hot oracle.  Under a mesh
(``ctx``, a ``sharding.spmd.Ctx``) with n "model" shards and E % n == 0,
the experts are parallel as in the reference: each rank holds E/n
experts' weights, runs ``_expert_ffn`` on its slice of the dispatched
(B, E, C, D) tensor and ``_combine_local`` at its ``e_base``, and the
partial outputs are summed over "model" (the reference's ``shard_map``
combine and ``psum``).  Every model rank routes the same tokens and
computes the same loss from the sum, so the sum passes its gradient
through unchanged, and the gradients of the replicated dispatch and
gates are summed over "model" (``spmd.model_slice``/``model_copy``).
With E % n != 0 the experts are replicated (``resolve_spec``'s rail) and
the local path runs.  The shared experts' "ff" splits over "model" like
a dense MLP's when their compute form holds a rank's columns; their
partial output joins the experts' before the sum.  When the batch is
split over the batch axes (``ctx.split``), ``route``'s aux is this rank's
share of the global one:
the top-1 fractions are summed over the batch ranks (they carry no
gradient), the mean probabilities and the z-loss are this rank's sums
over the global token count, so the shares add up to the reference's
aux and their gradients to its gradient.  In a segment of a microbatch
that crosses the batch ranks (``ctx.share``, ``spmd.Share``) the
fractions are the microbatch's, summed once after the forward, so the
balance term's value and gradient come from them then (``_Balance``).
Under the weights-stationary serve layout (``partition.serve_rules``)
each rank also holds its block of the experts' hidden dim "e_ff" over
the batch axes (its ``wg`` narrower than ``d_expert``): the layer
gathers every batch rank's input rows (``spmd.rows_gather``; activations
only), routes them (rows are routed apart and capacity is a sequence's,
so the routes are one device's), runs its "e_ff" block of every expert
it holds, a partial sum, and sums that over the batch ranks back to its
own rows (``spmd.rows_reduce``) before the sum over "model"; ``dropped``
then counts every batch rank's rows.
The router product must run in full float32: on the card that needs
TF32 off for matrix products, PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32`` False).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding import spmd
from . import layers


def capacity(cfg, S: int) -> int:
    return max(1, math.ceil(S * cfg.top_k * cfg.capacity_factor
                            / cfg.n_experts))


class _Balance(torch.autograd.Function):
    """The load-balance term E sum(frac mean_p) of a microbatch's segment,
    whose fractions are known only after the forward (``spmd.Share``): 0
    forward (the step adds the value once the fractions are summed), E
    frac backward, read from the layer's record then."""

    @staticmethod
    def forward(ctx_, mean_p, record, n_experts):
        ctx_.record, ctx_.n_experts = record, n_experts
        return mean_p.new_zeros(())

    @staticmethod
    def backward(ctx_, g):
        return g * ctx_.n_experts * ctx_.record.frac, None, None


def route(p, x, cfg, ctx=None):
    """Returns (topi (B,S,k) int32, gates (B,S,k) f32, aux_loss f32);
    with a split batch (``ctx.split``) aux is this rank's share, and in a
    microbatch's segment (``ctx.share``) its share less the balance term,
    which the step adds once the fractions are summed."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(logits, cfg.top_k, dim=-1)
    gates = torch.softmax(topv, dim=-1)                # renormalized over k
    # switch load-balance loss: E * mean(f_e * p_e)
    # the top-1 one-hot as a comparison: F.one_hot reads its indices' range
    # back to the host on the CPU
    ohot = (topi[..., :1] == torch.arange(cfg.n_experts,
                                          device=x.device)).float()
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if ctx is not None and ctx.share is not None:
        # a microbatch's segment: its fractions are summed over the batch
        # ranks after the forward (spmd.Share)
        tokens = ctx.share.rows * x.shape[1]
        mean_p = probs.sum(dim=(0, 1)) / tokens
        z = lse2.sum() / tokens
        r = ctx.share.route(id(p), ohot.sum(dim=(0, 1)), mean_p, z, tokens)
        lb = _Balance.apply(mean_p, r, cfg.n_experts)
        return topi.to(torch.int32), gates, lb + cfg.router_zloss * z
    if ctx is not None and ctx.split:
        tokens = x.shape[0] * x.shape[1] * ctx.n_batch
        frac = ctx.batch_sum(ohot.sum(dim=(0, 1))) / tokens
        mean_p = probs.sum(dim=(0, 1)) / tokens
        z = lse2.sum() / tokens
    else:
        frac = ohot.mean(dim=(0, 1))
        mean_p = probs.mean(dim=(0, 1))
        z = torch.mean(lse2)
    lb = cfg.n_experts * torch.sum(frac * mean_p)
    return topi.to(torch.int32), gates, lb + cfg.router_zloss * z


def _positions_in_expert(topi, cfg):
    """topi (B, S, k) -> pos (B, S, k) int32: the running index of each
    (token, choice) within its expert, token-major over the flattened S·k
    choices.  Integer work, so one unchunked one-hot cumsum gives the
    reference's chunked scan's answer.  The one-hot is laid out (B, E,
    S·k), so the count scans its last dim: along the token axis of a (B,
    S·k, E) layout, an outer-dim scan, it took 1.6 ms a layer on an H100
    at B·S = 6,144, E = 64, k = 6 (chip_smoke.py's [profile])."""
    B, S, k = topi.shape
    ek = topi.reshape(B, 1, S * k).long()
    experts = torch.arange(cfg.n_experts, device=topi.device)[:, None]
    oh = (ek == experts).to(torch.int32)                     # (B, E, S*k)
    within = torch.cumsum(oh, dim=-1, dtype=torch.int32) - oh
    pos = torch.gather(within, 1, ek)[:, 0]
    return pos.reshape(B, S, k)


def _dispatch(x, topi, pos, keep, C, cfg):
    """Batched-gather dispatch -> ((B, E, C, D), inv (B, E, C)); empty
    slots are zero (they read the sentinel token S, a zero row)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    slot_e = topi.reshape(B, -1).long()                            # (B, S*k)
    slot_c = torch.where(keep, pos, C).reshape(B, -1).long()       # overflow->C
    src = torch.arange(S, dtype=torch.int32,
                       device=x.device).repeat_interleave(k)
    b_ix = torch.arange(B, device=x.device)[:, None].expand_as(slot_e)
    inv = torch.full((B, E, C + 1), S, dtype=torch.int32, device=x.device)
    inv[b_ix, slot_e, slot_c] = src.expand_as(slot_e)
    inv = inv[:, :, :C]                                            # (B, E, C)
    x_pad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    out = torch.gather(x_pad, 1, inv.reshape(B, E * C, 1).long()
                       .expand(B, E * C, D))
    return out.reshape(B, E, C, D), inv


def _expert_ffn(p, h, cfg):
    """h (B, E, C, D) -> (B, E, C, D); the weights cast to h's dtype (a
    no-op when they already are: bf16 weights stay bf16)."""
    dt = h.dtype
    g = torch.einsum("becd,edf->becf", h, p["wg"].to(dt))
    u = torch.einsum("becd,edf->becf", h, p["wu"].to(dt))
    a = F.silu(g) * u
    return torch.einsum("becf,efd->becd", a, p["wd"].to(dt))


def _combine_local(expert_out, topi, pos, keep, gates, e_base, E_loc, S):
    """Sum each token's local-expert outputs, one choice at a time in the
    expert output's dtype, each gate cast to it first (the reference's
    order and roundings).  The slots and weights of all k choices are
    computed, and their rows gathered, at once: the same values the
    reference's per-choice loop takes, in a few launches."""
    B, _, C, D = expert_out.shape
    k = topi.shape[-1]
    sel = (topi >= e_base) & (topi < e_base + E_loc) & keep      # (B, S, k)
    el = torch.clamp(topi - e_base, 0, E_loc - 1)
    cj = torch.clamp(pos, 0, C - 1)
    flat = (el * C + cj).long().reshape(B, S * k, 1)
    vals = torch.gather(expert_out.reshape(B, -1, D), 1,
                        flat.expand(B, S * k, D)).reshape(B, S, k, D)
    w = (gates * sel).to(expert_out.dtype)
    out = expert_out.new_zeros((B, S, D))
    for j in range(k):                                 # static k loop
        out = out + vals[:, :, j] * w[:, :, j, None]
    return out


def expert_parallel(cfg, ctx) -> bool:
    """Whether the experts are split over "model" under ``ctx``: more
    than one model shard, and E a multiple of their number."""
    return ctx is not None and ctx.n_model > 1 \
        and cfg.n_experts % ctx.n_model == 0


def e_ff_split(p, cfg, ctx) -> bool:
    """Whether the expert weights hold this rank's block of "e_ff" over
    the batch axes (the serve layout, ``spmd.is_part``)."""
    return spmd.is_part(p["wg"], cfg.d_expert, ctx)


def moe_scatter(p, x, cfg, ctx=None):
    """The production MoE path.  Returns (out (B, S, D) in x's dtype, aux
    f32, dropped int32: the kept-out (token, choice) pairs with a nonzero
    gate).  Under expert parallelism (``expert_parallel``) ``p``'s expert
    weights are this rank's E/n experts; under the serve layout
    (``e_ff_split``) their "e_ff" block too (see the module's note)."""
    rows = x
    ef = e_ff_split(p, cfg, ctx)
    if ef and ctx.rows_split:
        x = spmd.rows_gather(x, ctx)
    B, S, D = x.shape
    E = cfg.n_experts
    C = capacity(cfg, S)
    ep = expert_parallel(cfg, ctx)
    E_loc = E // ctx.n_model if ep else E
    if p["wg"].shape[0] != E_loc:
        raise ValueError(
            f"{cfg.name}: the expert weights hold {p['wg'].shape[0]} "
            f"experts; this rank runs {E_loc} of {E} "
            f"({ctx.n_model if ep else 1} model shard(s))")
    topi, gates, aux = route(p, x, cfg, ctx)
    pos = _positions_in_expert(topi, cfg)
    keep = pos < C
    dropped = torch.sum(~keep & (gates > 0), dtype=torch.int32)
    h, _ = _dispatch(x, topi, pos, keep, C, cfg)        # (B, E, C, D)
    # the shared experts' "ff" splits over "model" like a dense MLP's (its
    # compute form holds a rank's columns): its partial sum joins the
    # experts' before their one sum over "model"
    sp = p["shared"] if cfg.n_shared_experts else None
    tp_shared = sp is not None and _shared_split(sp, cfg, ctx)
    if ep:
        h = _expert_ffn(p, spmd.model_slice(h, 1, ctx), cfg)
        out = _combine_local(h, topi, pos, keep, spmd.model_copy(gates, ctx),
                             ctx.model_index * E_loc, E_loc, S)
        if ef:          # the "e_ff" blocks' partial sums, to this rank's rows
            out = spmd.rows_reduce(out, ctx)
        if tp_shared:
            out = out + layers.mlp(sp, spmd.model_copy(rows, ctx), "silu")
        out = spmd.model_sum(out, ctx)
        if sp is not None and not tp_shared:
            out = out + layers.mlp(sp, rows, "silu")
    else:
        h = _expert_ffn(p, h, cfg)
        out = _combine_local(h, topi, pos, keep, gates, 0, E, S)
        if ef:
            out = spmd.rows_reduce(out, ctx)
        if sp is not None:
            out = out + _shared(sp, rows, cfg, ctx)
    return out.to(x.dtype), aux, dropped


def _shared_split(sp, cfg, ctx) -> bool:
    """Whether the shared experts' compute form holds a rank's columns of
    "ff" (``spmd.is_part``)."""
    return spmd.is_part(sp["wu"], cfg.n_shared_experts * cfg.d_expert, ctx)


def _shared(sp, x, cfg, ctx):
    """The shared experts' output, summed over "model" when their compute
    form holds a rank's columns of "ff"."""
    if _shared_split(sp, cfg, ctx):
        return spmd.model_sum(layers.mlp(sp, spmd.model_copy(x, ctx),
                                         "silu"), ctx)
    return layers.mlp(sp, x, "silu")


# --------------------------------------------------------------------------
# small-shape oracle: classic GShard one-hot einsum dispatch/combine
# --------------------------------------------------------------------------

def moe_einsum(p, x, cfg, ctx=None):
    B, S, D = x.shape
    E = cfg.n_experts
    C = capacity(cfg, S)
    topi, gates, aux = route(p, x, cfg, ctx)
    pos = _positions_in_expert(topi, cfg)
    keep = pos < C
    oh_e = F.one_hot(topi.long(), E).float()                      # (B,S,k,E)
    # jax.nn.one_hot of the overflow index C over C classes is all zeros
    oh_c = F.one_hot(torch.where(keep, pos, C).long(),
                     C + 1)[..., :C].float()                      # (B,S,k,C)
    disp = torch.einsum("bske,bskc->bsec", oh_e, oh_c)            # bool-ish
    # the top-k experts are distinct, so each (e, c) sums one gate: exact
    comb = torch.einsum("bske,bskc->bsec", oh_e * gates[..., None], oh_c)
    h = torch.einsum("bsec,bsd->becd", disp.to(x.dtype), x)
    h = _expert_ffn(p, h, cfg)
    out = torch.einsum("bsec,becd->bsd", comb.to(x.dtype), h)
    if cfg.n_shared_experts:
        out = out + _shared(p["shared"], x, cfg, ctx)
    dropped = torch.sum(~keep & (gates > 0), dtype=torch.int32)
    return out.to(x.dtype), aux, dropped


def moe_block(p, x, cfg, ctx=None):
    """``moe_impl == "einsum"`` runs the oracle, anything else ("scatter",
    "dense") the scatter path, as in the reference.  The oracle holds
    every expert: under expert parallelism it raises ValueError."""
    if cfg.moe_impl == "einsum":
        if expert_parallel(cfg, ctx):
            raise ValueError(f"{cfg.name}: the einsum oracle holds every "
                             f"expert; moe_impl='scatter' splits them over "
                             f"{ctx.n_model} model shards")
        return moe_einsum(p, x, cfg, ctx)
    return moe_scatter(p, x, cfg, ctx)
