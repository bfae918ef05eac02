"""Batched serving engine (port of ``repro.serve.engine``): prefill, then
step-synchronous decode with greedy or temperature sampling.

As in the reference, prompts are right-padded with token 0 to the longest
prompt, every sequence decodes from that common position, and the cache
holds ``max_seq`` positions (a ring of ``sliding_window`` slots for
swa/hymba layers; mamba, mLSTM and sLSTM layers keep fixed-size
recurrent states instead).  MoE layers route every prompt position,
padding included, and take capacity from it, and the recurrent mixers
run through the pad positions, so a shorter prompt's state has absorbed
them, as in the reference; the MoE aux loss ``forward`` returns is
discarded.  Rotary and learned positions both serve; an
encoder-decoder (whisper) does not: the reference's ``generate`` passes
no frames to its prefill, so it cannot run one either, and its serving
entry points are ``make_prefill(cfg)(params, tokens, cache, frames)``
then ``make_serve_step(cfg)``.  The sampled tokens stay on the device as
the next step's input; the host reads them once per token.  ``timings``
holds the last ``generate``'s host-clock seconds to the first token
(cache, prefill, first sample) and of the decode steps; each ends in
that host read, so the device work is inside it.

With ``mesh`` (a ``DeviceMesh`` over the ranks of the default process
group, ``launch/mesh.py``) every rank runs ``generate`` on the same
prompts with its blocks of the parameters (``train.step.shard_state``'s
layout; the steps gather them each call, the experts kept split over
"model"), its rows of the batch when the batch axes divide it, and its
blocks of the cache of those rows (``transformer.init_cache(...,
ctx=)``: a full cache's slots and the SSM's channels split over
"model"); the logits of every row are gathered each step, so every rank
samples the same tokens and returns the same results.  With
``cfg.serve_weights_stationary`` the engine lays its blocks out once
under ``partition.serve_rules`` (``train.step.reshard_params``), and the
steps gather nothing over the batch axes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.types import resolve_device
from ..models import transformer
from ..models.config import ModelConfig
from ..sharding import spmd
from ..train import step as step_lib


@dataclasses.dataclass
class GenResult:
    tokens: List[int]
    prompt_len: int
    steps: int


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_seq: int = 256, mesh=None, device=None):
        """``params`` from ``transformer.make_params`` or
        ``convert.params_from_jax`` (this rank's blocks with ``mesh``, in
        the train layout), on ``device`` (the card unless the caller asks
        for the CPU)."""
        transformer.check_supported(cfg)
        self.device = resolve_device(device)
        where = {p.device.type for p in params.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"parameters are on {sorted(where)}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.mesh = mesh
        self._ctx = None if mesh is None else spmd.Ctx.of(mesh)
        if mesh is not None and cfg.serve_weights_stationary:
            rows = params["dec_pos"].shape[0] if "dec_pos" in params else 0
            params = step_lib.reshard_params(
                params, step_lib.state_shardings(cfg, mesh, rows)[0]["params"],
                step_lib.serve_shardings(cfg, mesh, rows)[0]["params"])
        self.params = params
        self._prefill = step_lib.make_prefill(cfg, mesh)
        self._decode = step_lib.make_serve_step(cfg, mesh)
        self.timings: dict = {}

    @torch.inference_mode()
    def generate(self, prompts: List[List[int]], max_new: int = 32,
                 temperature: float = 0.0, eos: Optional[int] = None,
                 seed: int = 0) -> List[GenResult]:
        """Generate for up to max_batch prompts (batched, left-aligned).
        Greedy (``temperature <= 0``) takes the argmax, ties to the lowest
        index; otherwise tokens are drawn from a ``torch.Generator`` seeded
        with ``seed`` (not the reference's ``jax.random`` stream).  An
        encoder-decoder raises ValueError (see the module's note)."""
        if self.cfg.is_enc_dec:
            raise ValueError(
                f"{self.cfg.name} is an encoder-decoder: generate passes no "
                f"frames to the prefill, as the reference's does, so it "
                f"cannot run it; serve it with make_prefill(cfg)(params, "
                f"tokens, cache, frames) and make_serve_step(cfg) "
                f"(repro_torch.train.step)")
        if len(prompts) > self.max_batch:
            raise ValueError(f"{len(prompts)} prompts exceed max_batch="
                             f"{self.max_batch}")
        B = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((B, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p                 # right-pad with 0
        dev = self.device
        t0 = time.perf_counter()
        # this rank's blocks of the cache with a mesh
        cache = transformer.init_cache(self.cfg, B, self.max_seq, device=dev,
                                       ctx=self._ctx)
        logits, cache = self._prefill(self.params,
                                      torch.from_numpy(toks).to(dev), cache)

        gen = torch.Generator(device=dev).manual_seed(seed)
        out = [list(p) for p in prompts]
        alive = np.ones(B, bool)
        last = self._sample(logits, temperature, gen)
        for i, t in enumerate(last.tolist()):
            out[i].append(t)
        t1 = time.perf_counter()
        pos = plen
        steps = 0
        while alive.any() and pos < self.max_seq and steps < max_new - 1:
            logits, cache = self._decode(self.params, cache, last[:, None],
                                         pos)
            last = self._sample(logits, temperature, gen)
            for i, t in enumerate(last.tolist()):   # the one host read
                if alive[i]:
                    out[i].append(t)
                    if eos is not None and t == eos:
                        alive[i] = False
            pos += 1
            steps += 1
        self.timings = {"first_token_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1,
                        "decode_steps": steps}
        return [GenResult(tokens=o, prompt_len=len(p), steps=steps + 1)
                for o, p in zip(out, prompts)]

    @staticmethod
    def _sample(logits, temperature, gen):
        """(B,) int64 on the logits' device."""
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(logits.float() / temperature + gumbel, dim=-1)
