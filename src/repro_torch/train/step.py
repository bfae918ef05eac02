"""Train and serve step builders (port of ``repro.train.step`` on one
device), for every configuration the model runs (attn/swa/hymba/mamba/
mlstm/slstm blocks, dense, MoE or no FFN, rotary or learned positions,
whisper's encoder-decoder, whose train step and prefill take the frames).

``init_state`` + ``make_train_step(cfg, opt_cfg)(state, batch) -> (state,
metrics)`` is the reference's training API: the loss (``lm_loss``, or
``lm_loss_chunked`` when ``cfg.xent_chunk`` is set) and its gradient by
autograd (the LM kernels' gradients are the backward kernels,
``kernels/ops.py``), then AdamW (``train/optim.py``).  With
``cfg.microbatches == 1`` the gradients keep the parameter dtype, as
``jax.value_and_grad``'s do; with more, a Python loop over the
microbatches adds float32 gradients and divides them, the loss and the
parts' means by their number, as the reference's ``lax.scan``.  The
update writes the state's parameters and moments in place and returns
the same dicts; ``step`` is a new int32 tensor.  Metrics are 0-d tensors
on the device: the step reads nothing back to the host.

``make_prefill`` and ``make_serve_step`` return plain functions of
(params, tensors); as in the reference they discard ``forward``'s aux
(the MoE loss).  The mesh side of the reference's steps (sharded states,
data-parallel training) is not ported (ROADMAP Queue 1 item 17, its open
part)."""
from __future__ import annotations

import torch

from ..kernels.ref import div_const
from ..models import transformer
from ..models.config import ModelConfig
from . import optim


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


def make_grad_fn(cfg: ModelConfig):
    """(params, batch) -> (loss, parts, grads): the train step's loss, its
    parts and the gradient of every parameter in ``named_parameters``
    order (zeros for one the loss does not reach), microbatched as
    ``cfg.microbatches`` says."""

    def loss_fn(params, tokens, labels, frames):
        """(loss, {"nll", "aux"}) of one (micro)batch."""
        if cfg.xent_chunk:
            x, _, aux = transformer.forward(cfg, params, tokens, mode="train",
                                            frames=frames, skip_head=True)
            head = params["embed"].T if cfg.tie_embeddings \
                else params["lm_head"]
            return transformer.lm_loss_chunked(
                cfg, x, head.to(x.dtype), labels, aux,
                final_softcap=cfg.final_softcap)
        logits, _, aux = transformer.forward(cfg, params, tokens,
                                             mode="train", frames=frames)
        return transformer.lm_loss(cfg, logits, labels, aux)

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


def make_train_step(cfg: ModelConfig,
                    opt_cfg: optim.AdamWConfig = optim.AdamWConfig()):
    """(state, batch) -> (state, metrics): batch {"tokens" (B, S),
    "labels" (B, S) (< 0: padding), "frames" (B, enc_seq, D) for an
    encoder-decoder}; metrics {"loss", "grad_norm", "lr", "nll", "aux"}."""
    transformer.check_supported(cfg)
    grad_fn = make_grad_fn(cfg)

    def train_step(state, batch):
        params = state["params"]
        loss, parts, grads = grad_fn(params, batch)
        stats = optim.adamw_update(opt_cfg, list(params.named_parameters()),
                                   grads, state["opt"], state["step"])
        new_state = {"params": params, "opt": state["opt"],
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **stats, **parts}

    return train_step


# --------------------------------------------------------------------------
# serve steps
# --------------------------------------------------------------------------


def make_prefill(cfg: ModelConfig):
    """(params, tokens (B, S), cache, frames=None) -> (logits (B, vocab)
    at the last position, new_cache); ``frames`` (B, enc_seq, D) for an
    encoder-decoder, whose prefill runs the encoder and stores its
    projected keys and values in the cache.  The head runs on the last
    position only: the same logits as the reference's full head sliced
    at -1."""

    def prefill(params, tokens, cache, frames=None):
        x, new_cache, _ = transformer.forward(
            cfg, params, tokens, mode="prefill", cache=cache, frames=frames,
            skip_head=True)
        return transformer.head(cfg, params, x[:, -1:])[:, 0], new_cache

    return prefill


def make_serve_step(cfg: ModelConfig):
    """One-token decode: (params, cache, token (B, 1), pos int) ->
    (logits (B, vocab), new_cache)."""

    def serve_step(params, cache, token, pos):
        logits, new_cache, _ = transformer.forward(
            cfg, params, token, mode="decode", cache=cache, pos=pos)
        return logits[:, 0], new_cache

    return serve_step
