"""AdamW on the port's parameters (port of ``repro.train.optim``).

Plain functions over ``{name: tensor}`` maps keyed as
``Params.named_parameters()`` names the leaves (``"layers.3.mixer.attn.wq"``).
Moments are float32 whatever the parameter dtype; the update is computed
in float32 and cast back.  The update writes the parameters and the
moments in place (no second copy of 13 GB of moments at hymba-1.5b's
size); the reference returns new trees.

Two points where the port has to choose to stay the reference's
optimizer:

* Weight decay.  The reference decays a leaf when ``p.ndim >= 2``, but
  its layer parameters are stacked over periods, so every leaf under
  ``layers`` and ``enc.layers`` (norm scales and biases included) has
  rank 2 or more there and is decayed; only the top-level vectors
  (``final_norm``, ``enc.final_norm``) are not.  The port keeps one tensor
  a layer, so ``decays`` decides by the reference's stacked rank.
* Roundings.  ``lr_at``'s cosine and the bias corrections' ``b ** t`` are
  taken in float64 and rounded once to float32 (XLA:CPU's float32 ones are
  not correctly rounded, so the two packages can differ by an ulp there);
  divisions by Python constants go through ``kernels.ref.div_const`` as
  the reference's compiled step computes them.  ``global_norm`` sums its
  leaves in the order it is given them, the reference in
  ``jax.tree.leaves`` order over its stacked leaves: the float32 sums
  differ in their last bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.ref import div_const

F64 = torch.float64


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the reference decays this leaf: rank >= 2 in its stacked
    layout, which every per-layer leaf has."""
    return p.ndim >= 2 or name.startswith(("layers.", "enc.layers."))


def init_moments(params) -> dict:
    """{"m": {name: zeros}, "v": {name: zeros}}, float32, on each
    parameter's device."""
    named = list(params.named_parameters())
    return {k: {n: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for n, p in named}
            for k in ("m", "v")}


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to ``min_lr_ratio * lr`` at
    ``total_steps``; a float32 0-d tensor on step's device."""
    s = step.to(torch.float32)
    warm = div_const(cfg.lr * s, max(cfg.warmup_steps, 1))
    prog = torch.clamp(div_const(s - cfg.warmup_steps,
                                 max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    # cos of the float32 product pi * prog, taken in float64, rounded once
    cos = torch.cos((prog * math.pi).to(F64)).to(torch.float32)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + cos)
    return torch.where(s < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in the order given."""
    total = None
    for g in grads:
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, named_params, grads, moments,
                 step) -> dict:
    """One AdamW step, in place: ``named_params`` [(name, parameter)],
    ``grads`` the gradients in that order, ``moments`` {"m", "v"} of
    ``init_moments``, ``step`` the int32 step count before this update.
    Returns {"grad_norm", "lr"} as float32 0-d tensors."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0) \
        if cfg.grad_clip else 1.0
    lr = lr_at(cfg, step)
    t = step.to(torch.float32) + 1.0
    # b ** t of b rounded to float32, taken in float64, rounded once
    c1, c2 = (1.0 - torch.pow(torch.full_like(t, b).to(F64),
                              t.to(F64)).to(torch.float32)
              for b in (cfg.b1, cfg.b2))
    with torch.no_grad():
        for (name, p), g in zip(named_params, grads):
            m, v = moments["m"][name], moments["v"][name]
            g = g.to(torch.float32) * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            pf = p.to(torch.float32)
            if cfg.weight_decay and decays(name, p):
                u = u + cfg.weight_decay * pf
            p.copy_((pf - lr * u).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
