"""Model assembly in PyTorch (port of ``repro.models.transformer``):
parameters, decode caches, the encoder and the forward pass, for models
whose decoder blocks are ``attn``, ``swa``, ``hymba``, ``mamba``,
``mlstm`` or ``slstm`` (the mixers of the last three in ``models.ssm``),
with a dense or an MoE feed-forward (``models.moe``) or none (``d_ff=0``,
xLSTM), rotary or learned positions (``pos``), and whisper's
encoder-decoder: a stack of bidirectional ``enc`` blocks over frame
embeddings plus sinusoidal positions (``encode``), and cross-attention in
every decoder block (``cross_attn``), whose encoder keys and values the
prefill stores in the cache.  The front ends are stubs in the reference
too: whisper's frames arrive as embeddings (B, enc_seq, d_model), and
chameleon's VQ image tokens are ordinary ids of the shared vocab, so
``frontend`` is carried and not read.

The reference stacks each pattern position's parameters over periods and
scans over them; here every layer has its own parameters (``Params``, an
``nn.Module`` that reads like the reference's nested dict) and a plain
Python loop runs the layers.  Caches are one dict per layer, holding what
its kind needs.  ``remat`` is read in train mode when a gradient is
wanted, as the reference's ``jax.checkpoint`` of its scan body: each
period of the block pattern (and each encoder block) runs under
``torch.utils.checkpoint`` (non-reentrant); ``"full"`` recomputes the
whole period in the backward pass, ``"dots"`` saves the outputs of the
products without batch dimensions (``aten.mm``/``aten.addmm``, the 2-D
weight products) through a selective-checkpoint policy, as
``checkpoint_dots_with_no_batch_dims`` does, and ``"nothing"`` saves
everything; the numbers do not depend on it.  ``microbatches`` is read by
the train step (``train/step.py``).  Mesh sharding, ``scan_layers``,
``fsdp_embed`` and ``use_flash`` have no counterpart on one card, and
``attn_bf16_scores`` tunes the reference's jnp attention, which the flash
kernel replaces: they are carried in the config and not read.
``attn_chunk`` is read by the mLSTM's parallel form only.  The
one thing the reference's forward supports that the port does not,
``skip_attention`` (a roofline probe), raises ``NotImplementedError``
naming ROADMAP Queue 1 item 19.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..core.types import resolve_device
from . import layers, moe, ssm
from .config import ModelConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
KINDS = ("attn", "swa", "hymba", "mamba", "mlstm", "slstm")


def cdtype(cfg):
    return DTYPES[cfg.compute_dtype]


def pdtype(cfg):
    return DTYPES[cfg.param_dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a decoder block kind the reference does not
    know either, and NotImplementedError for ``skip_attention``, which the
    port does not run yet, naming the ROADMAP Queue 1 item that brings
    it."""
    unknown = sorted(set(cfg.block_pattern) - set(KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}")
    if cfg.skip_attention:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: skip_attention, a roofline probe "
            f"(item 19) -- see ROADMAP.md Queue 1")


# ==========================================================================
# parameters
# ==========================================================================

class Params(nn.Module):
    """A nested parameter dictionary as an ``nn.Module``: tensors are
    parameters (without gradients: serving; ``train.step.init_state``
    turns them on), dicts are submodules, lists are ``nn.ModuleList``s.
    Read like the reference's pytree: ``p["mixer"]["attn"]["wq"]``,
    ``"q_norm" in p``; ``named_parameters()`` names a leaf by its path
    (``"layers.3.mixer.attn.wq"``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(Params(t) for t in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in self._parameters or key in self._modules


class _Init:
    """The port's own initializer: the reference's distributions (normal,
    scaled by 1/sqrt(fan_in)) drawn from one ``torch.Generator``."""

    def __init__(self, cfg, generator, device):
        self.cfg, self.gen, self.dev = cfg, generator, device

    def normal(self, shape, scale):
        return torch.randn(shape, generator=self.gen, dtype=torch.float32,
                           device=self.dev) * scale

    def dense(self, fan_in, shape, dtype=None):
        return self.normal(shape, 1.0 / math.sqrt(fan_in)).to(
            dtype or pdtype(self.cfg))

    def zeros(self, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.dev)

    def full(self, shape, val):
        return torch.full(shape, val, dtype=torch.float32, device=self.dev)


def _attn_params(cfg, init, cross=False):
    """Self-attention, or with ``cross`` a decoder block's cross-attention:
    its ``wk``/``wv`` project the encoder output to all n_heads heads
    (D, q_dim), and it has no bias and no QK-norm."""
    D, Qd = cfg.d_model, cfg.q_dim
    KVd = Qd if cross else cfg.kv_dim
    p = {"wq": init.dense(D, (D, Qd)), "wk": init.dense(D, (D, KVd)),
         "wv": init.dense(D, (D, KVd)), "wo": init.dense(Qd, (Qd, D))}
    if cross:
        return p
    if cfg.attn_bias:
        dt = pdtype(cfg)
        p |= {"bq": init.zeros((Qd,), dt), "bk": init.zeros((KVd,), dt),
              "bv": init.zeros((KVd,), dt)}
    if cfg.qk_norm:
        p |= {"q_norm": init.zeros((cfg.head_dim,)),
              "k_norm": init.zeros((cfg.head_dim,))}
    return p


def _mlp_params(cfg, init, d_ff=None):
    D, F = cfg.d_model, d_ff or cfg.d_ff
    p = {"wu": init.dense(D, (D, F)), "wd": init.dense(F, (F, D))}
    if cfg.act in ("silu", "geglu"):
        p["wg"] = init.dense(D, (D, F))
    return p


def _moe_params(cfg, init):
    """The router stays float32 whatever ``param_dtype`` is."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_expert
    p = {"router": init.dense(D, (D, E), torch.float32),
         "wg": init.dense(D, (E, D, F)), "wu": init.dense(D, (E, D, F)),
         "wd": init.dense(F, (E, F, D))}
    if cfg.n_shared_experts:
        p["shared"] = _mlp_params(cfg, init,
                                  d_ff=cfg.n_shared_experts * cfg.d_expert)
    return p


def _ssm_params(cfg, init):
    D, Dss, N, K = cfg.d_model, cfg.d_ssm, cfg.ssm_state, cfg.ssm_conv
    a = torch.arange(1, N + 1, dtype=torch.float32,
                     device=init.dev)[None].repeat(Dss, 1)
    return {"in_proj": init.dense(D, (D, 2 * Dss)),
            "conv_w": init.dense(K, (K, Dss)),
            "conv_b": init.zeros((Dss,), pdtype(cfg)),
            "dt_w": init.full((Dss,), 1.0),
            "dt_b": init.full((Dss,), -4.6),         # softplus ~ 0.01
            "w_B": init.dense(Dss, (Dss, N)),
            "w_C": init.dense(Dss, (Dss, N)),
            "A_log": torch.log(a),
            "d_skip": init.full((Dss,), 1.0),
            "out_proj": init.dense(Dss, (Dss, cfg.d_model))}


def _mlstm_params(cfg, init):
    """The gates' ``wi`` and ``wf`` stay float32 whatever ``param_dtype``
    is."""
    D, Qd, H = cfg.d_model, cfg.q_dim, cfg.n_heads
    return {"wq": init.dense(D, (D, Qd)), "wk": init.dense(D, (D, Qd)),
            "wv": init.dense(D, (D, Qd)),
            "wi": init.dense(D, (D, H), torch.float32),
            "wf": init.dense(D, (D, H), torch.float32),
            "wo_gate": init.dense(D, (D, Qd)),
            "out_proj": init.dense(Qd, (Qd, D))}


def _slstm_params(cfg, init):
    """The bias ``b`` and the recurrent ``R`` stay float32 whatever
    ``param_dtype`` is."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    return {"W": init.dense(D, (D, 4 * D)),
            "b": init.zeros((4 * D,)),
            "R": init.dense(dh, (H, dh, 4 * dh), torch.float32),
            "out_proj": init.dense(D, (D, D))}


_MIXERS = {"attn": _attn_params, "swa": _attn_params, "enc": _attn_params,
           "mamba": _ssm_params, "mlstm": _mlstm_params,
           "slstm": _slstm_params}


def _block_params(cfg, kind, init, *, is_encoder=False):
    """A decoder block, or with ``is_encoder`` an encoder block: no
    cross-attention and a dense feed-forward even in an MoE model."""
    D = cfg.d_model
    p = {"ln1": init.zeros((D,))}
    if kind == "hymba":
        p["mixer"] = {"attn": _attn_params(cfg, init),
                      "ssm": _ssm_params(cfg, init)}
    else:
        p["mixer"] = _MIXERS[kind](cfg, init)
    if cfg.cross_attn and not is_encoder:
        p["ln_x"] = init.zeros((D,))
        p["cross"] = _attn_params(cfg, init, cross=True)
    if cfg.d_ff > 0 or cfg.is_moe:
        p["ln2"] = init.zeros((D,))
        p["ffn"] = _moe_params(cfg, init) if cfg.is_moe and not is_encoder \
            else _mlp_params(cfg, init)
    return p


def layer_kind(cfg, i: int) -> str:
    return cfg.block_pattern[i % cfg.period]


def make_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, max_seq: int = 0) -> Params:
    """Random parameters from ``generator`` on ``device`` (the card unless
    the caller asks for the CPU; the generator must live there too).
    Learned positions (``pos="learned"``) take ``max_seq`` rows of
    ``dec_pos``, so they need ``max_seq > 0``; an encoder-decoder gets
    ``enc`` = {"layers": enc_layers blocks, "final_norm"}."""
    check_supported(cfg)
    if cfg.pos == "learned" and max_seq <= 0:
        raise ValueError(f"{cfg.name}: learned positions need max_seq > 0 "
                         f"at init, got {max_seq}")
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"parameters go to {dev}")
    init = _Init(cfg, generator, dev)
    tree = {"embed": init.normal((cfg.vocab, cfg.d_model), 0.02).to(
        pdtype(cfg))}
    tree["layers"] = [_block_params(cfg, layer_kind(cfg, i), init)
                      for i in range(cfg.n_layers)]
    tree["final_norm"] = init.zeros((cfg.d_model,))
    if not cfg.tie_embeddings:
        tree["lm_head"] = init.dense(cfg.d_model, (cfg.d_model, cfg.vocab))
    if cfg.pos == "learned":
        tree["dec_pos"] = init.normal((max_seq, cfg.d_model), 0.02).to(
            pdtype(cfg))
    if cfg.is_enc_dec:
        tree["enc"] = {
            "layers": [_block_params(cfg, "enc", init, is_encoder=True)
                       for _ in range(cfg.enc_layers)],
            "final_norm": init.zeros((cfg.d_model,))}
    return Params(tree)


# ==========================================================================
# caches
# ==========================================================================

def cache_len_for(cfg, kind, S):
    if kind in ("swa", "hymba") and cfg.sliding_window:
        return min(cfg.sliding_window, S)
    return S


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=None, device=None):
    """Decoder state for the serve step: one dict per layer, by its kind
    (ring caches of rotated keys for swa/hymba, full caches for attn; the
    SSM state for hymba/mamba; the float32 recurrent states C/n/m for
    mlstm and h/c/n/m for slstm, whose size does not depend on S); with
    ``cross_attn``, every layer also holds the encoder's projected keys
    and values, ``cross_k``/``cross_v`` (B, enc_seq, n_heads, head_dim),
    which the prefill writes."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or cdtype(cfg)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    caches = []
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        c = {}
        if kind in ("attn", "swa", "hymba"):
            W = cache_len_for(cfg, kind, S)
            c = {"k": torch.zeros((B, W, kv, hd), dtype=dt, device=dev),
                 "v": torch.zeros((B, W, kv, hd), dtype=dt, device=dev),
                 "pos_ids": torch.full((B, W), -1, dtype=torch.int32,
                                       device=dev)}
        if kind in ("hymba", "mamba"):
            c["ssm"] = ssm.ssm_init_state(cfg, B, dt, dev)
        if kind == "mlstm":
            c.update(ssm.mlstm_init_state(cfg, B, dt, dev))
        if kind == "slstm":
            c.update(ssm.slstm_init_state(cfg, B, dt, dev))
        if cfg.cross_attn:
            shape = (B, cfg.enc_seq, cfg.n_heads, hd)
            c["cross_k"] = torch.zeros(shape, dtype=dt, device=dev)
            c["cross_v"] = torch.zeros(shape, dtype=dt, device=dev)
        caches.append(c)
    return caches


# ==========================================================================
# forward pass
# ==========================================================================

def _apply_block(cfg, kind, p, x, *, mode, cache, pos, enc_out=None):
    """One layer: (x, new_cache, aux), aux the MoE loss (None without
    one, so a dense layer launches nothing for it).  A decoder block of an
    encoder-decoder attends to ``enc_out`` after its mixer (prefill and
    train), or to the cache's ``cross_k``/``cross_v`` (decode)."""
    aux = None
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    new_cache = {}
    if kind in ("attn", "swa", "enc"):
        mix, kv_cache = layers.attention_block(
            p["mixer"], h, cfg, kind=kind, mode=mode, cache=cache, pos=pos)
        if kv_cache:
            new_cache.update(kv_cache)
    elif kind == "hymba":
        a_cache = {k: cache[k] for k in ("k", "v", "pos_ids")} \
            if cache else None
        mix_a, kv_cache = layers.attention_block(
            p["mixer"]["attn"], h, cfg, kind="hymba", mode=mode,
            cache=a_cache, pos=pos)
        mix_s, s_state = ssm.mamba_mixer(
            p["mixer"]["ssm"], h, cfg, mode=mode,
            state=cache.get("ssm") if cache else None)
        mix = 0.5 * (mix_a + mix_s)
        if kv_cache:
            new_cache.update(kv_cache)
        if s_state:
            new_cache["ssm"] = s_state
    elif kind == "mamba":
        mix, s_state = ssm.mamba_mixer(
            p["mixer"], h, cfg, mode=mode,
            state=cache.get("ssm") if cache else None)
        if s_state:
            new_cache["ssm"] = s_state
    elif kind in ("mlstm", "slstm"):
        mixer = ssm.mlstm_mixer if kind == "mlstm" else ssm.slstm_mixer
        mix, st = mixer(p["mixer"], h, cfg, mode=mode, state=cache)
        if st:
            new_cache.update(st)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    x = x + mix
    if cfg.cross_attn and kind != "enc":
        hx = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
        if mode == "decode":
            ek, ev = cache["cross_k"], cache["cross_v"]
        else:
            B, Se, _ = enc_out.shape
            shape = (B, Se, cfg.n_heads, cfg.head_dim)
            ek = (enc_out @ p["cross"]["wk"]).reshape(shape)
            ev = (enc_out @ p["cross"]["wv"]).reshape(shape)
        x = x + layers.cross_attention(p["cross"], hx, ek, ev, cfg)
        if mode != "train":
            new_cache["cross_k"], new_cache["cross_v"] = ek, ev
    if "ffn" in p:
        h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.is_moe and kind != "enc":
            f, aux, _ = moe.moe_block(p["ffn"], h2, cfg)
        else:
            f = layers.mlp(p["ffn"], h2, cfg.act)
        x = x + f
    return x, new_cache, aux


def head(cfg, params, x):
    """Final logits of hidden states x (B, S, D)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return layers.softcap(x @ w.to(x.dtype), cfg.final_softcap)


# the products the "dots" policy saves: 2-D ones, no batch dimension (a
# (B, S, D) @ (D, F) product reaches the dispatcher as one aten.mm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return _ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _run_period(cfg, kinds, ps, x, aux, enc_out):
    """Train-mode blocks of one period: (x, aux), aux summed in the
    forward's order."""
    for kind, p in zip(kinds, ps):
        x, _, a = _apply_block(cfg, kind, p, x, mode="train", cache=None,
                               pos=0, enc_out=enc_out)
        if a is not None:
            aux = aux + a
    return x, aux


def _remat(cfg):
    """The period runner for ``cfg.remat``: the plain call where nothing is
    recomputed (or no gradient is wanted), else it under a non-reentrant
    checkpoint, selective for "dots"."""
    if cfg.remat == "nothing" or not torch.is_grad_enabled():
        return _run_period
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(_ckpt.checkpoint, _run_period,
                             use_reentrant=False, **kw)


def encode(cfg: ModelConfig, params, frames):
    """Whisper's encoder over stubbed frame embeddings (B, enc_seq, D):
    the frames in the compute dtype plus the sinusoidal table rounded to
    it, the bidirectional ``enc`` blocks (each one period for ``remat``,
    as the reference's encoder scan), then ``enc.final_norm``."""
    x = frames.to(cdtype(cfg))
    x = x + layers.sinusoidal_pos(x.shape[1], cfg.d_model, x.dtype,
                                  x.device)[None]
    run = _remat(cfg)
    for p in params["enc"]["layers"]:
        x, _ = run(cfg, ("enc",), (p,), x, None, None)
    return layers.rms_norm(x, params["enc"]["final_norm"], cfg.norm_eps)


def _learned_pos(cfg, params, S, mode, pos):
    """Rows of ``dec_pos`` for the tokens: [:S], or row ``pos`` in
    decode.  Where the reference would clamp (decode) or fail to
    broadcast (a longer prompt), this raises ValueError."""
    rows = params["dec_pos"].shape[0]
    if mode == "decode":
        if not 0 <= pos < rows:
            raise ValueError(f"{cfg.name}: decode position {pos} outside "
                             f"the {rows} learned positions (max_seq)")
        return params["dec_pos"][pos:pos + 1]
    if S > rows:
        raise ValueError(f"{cfg.name}: {S} tokens exceed the {rows} "
                         f"learned positions (max_seq)")
    return params["dec_pos"][:S]


def forward(cfg: ModelConfig, params, tokens, *, mode="train", cache=None,
            pos=0, frames=None, skip_head=False):
    """tokens (B, S) integer; ``frames`` (B, enc_seq, D) the encoder's
    input for an encoder-decoder in train and prefill modes (decode reads
    the cache's cross keys and values instead).  Returns (logits,
    new_cache, aux) as the reference does (aux, the layers' MoE losses
    summed in float32; 0 without MoE); with skip_head=True returns the
    final hidden states instead of logits."""
    check_supported(cfg)
    dt = cdtype(cfg)
    x = params["embed"][tokens.long()].to(dt)
    if cfg.family == "audio" or cfg.name.startswith("gemma"):
        # a 0-d tensor of x's dtype: the scale rounds to it first, as the
        # reference's weakly typed Python float does
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dt,
                           device=x.device)
    if cfg.pos == "learned":
        x = x + _learned_pos(cfg, params, tokens.shape[1], mode,
                             pos)[None].to(dt)
    enc_out = None
    if cfg.is_enc_dec and mode != "decode":
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs frames "
                             f"in {mode} mode")
        enc_out = encode(cfg, params, frames)
    new_caches = [] if cache is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train" and cache is None:
        # period by period, each under cfg.remat's checkpoint
        run, P = _remat(cfg), cfg.period
        blocks = params["layers"]
        for i0 in range(0, len(blocks), P):
            ps = tuple(blocks[i0:i0 + P])
            kinds = tuple(layer_kind(cfg, i0 + j) for j in range(len(ps)))
            x, aux = run(cfg, kinds, ps, x, aux, enc_out)
    else:
        for i, p in enumerate(params["layers"]):
            c = cache[i] if cache is not None else None
            x, nc, a = _apply_block(cfg, layer_kind(cfg, i), p, x,
                                    mode=mode, cache=c, pos=pos,
                                    enc_out=enc_out)
            if a is not None:
                aux = aux + a
            if cache is not None:
                new_caches.append(nc if nc else c)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if skip_head:
        return x, new_caches, aux
    return head(cfg, params, x), new_caches, aux


# ==========================================================================
# losses
# ==========================================================================

def _xent_parts(lg, labels):
    """(lse, gold, mask) float32 of logits lg (..., V) against labels
    (labels < 0 are padding): the row max in lg's dtype, then exp, sum and
    log in float32, and the gold logit read at max(label, 0) (the
    reference's one-hot masked sum picks the same single value)."""
    m = lg.amax(dim=-1).float()
    lf = lg.float()
    lse = torch.log(torch.exp(lf - m[..., None]).sum(dim=-1)) + m
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    return lse, gold, (labels >= 0).float()


def lm_loss(cfg, logits, labels, aux, aux_coef=0.01, z_coef=1e-4):
    """Masked token cross-entropy (port of the reference's ``lm_loss``):
    (nll + z_coef * mean((lse * mask)^2) + aux_coef * aux, {"nll", "aux"}),
    the means over the unpadded tokens (at least 1)."""
    lse, gold, mask = _xent_parts(logits, labels)
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = ((lse - gold) * mask).sum() / denom
    zloss = z_coef * ((lse * mask) ** 2).sum() / denom
    return loss + zloss + aux_coef * aux, {"nll": loss, "aux": aux}


def lm_loss_chunked(cfg, x, head, labels, aux, aux_coef=0.01, z_coef=1e-4,
                    final_softcap=0.0):
    """The same loss from the final hidden states x (B, S, D) and the head
    (D, V), the sequence cut into ``cfg.xent_chunk`` chunks (a Python
    loop, as the reference's): each chunk's logits are made, softcapped and
    reduced to its sums before the next, so the whole (B, S, V) logits are
    never one tensor."""
    S = x.shape[1]
    n = max(1, cfg.xent_chunk)
    c = -(-S // n)
    nll_sum = z_sum = None
    for i in range(n):
        xs = x[:, i * c:(i + 1) * c]
        if xs.shape[1] == 0:                # the reference's empty chunk
            continue                        # adds zeros
        lg = layers.softcap(xs @ head, final_softcap)
        lse, gold, msk = _xent_parts(lg, labels[:, i * c:i * c + xs.shape[1]])
        nll = ((lse - gold) * msk).sum()
        z = ((lse * msk) ** 2).sum()
        nll_sum = nll if nll_sum is None else nll_sum + nll
        z_sum = z if z_sum is None else z_sum + z
    denom = torch.clamp_min((labels >= 0).sum().float(), 1.0)
    loss = nll_sum / denom
    zloss = z_coef * z_sum / denom
    return loss + zloss + aux_coef * aux, {"nll": loss, "aux": aux}
