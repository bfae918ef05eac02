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
the train step (``train/step.py``).  Mesh sharding lives in the steps
(``train/step.py``, ``sharding/spmd.py``): the forward runs on a rank's
rows; with a sharded step's context (``ctx``) it gathers a period's
parameters at a time (``ctx.gather``, the next period's in flight) and
computes each tensor-parallel region on the rank's heads, ff columns,
SSM channels or vocab rows (``tp_layout``, ``_apply_block``), the MoE
layers expert-parallel, the losses' means global.  ``scan_layers``,
``fsdp_embed`` and ``use_flash`` have no counterpart on one card, and
``attn_bf16_scores`` tunes the reference's jnp attention, which the flash
kernel replaces: they are carried in the config and not read.
``attn_chunk`` is read by the mLSTM's parallel form only.
``skip_attention`` (a roofline probe) is read by ``layers.attention_block``.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..core.types import resolve_device
from ..sharding import partition, spmd
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
    know either."""
    unknown = sorted(set(cfg.block_pattern) - set(KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}")


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
    ``enc`` = {"layers": enc_layers blocks, "final_norm"}.  On
    ``device="meta"`` (generator None) the leaves have their shapes and
    dtypes and no storage."""
    check_supported(cfg)
    if cfg.pos == "learned" and max_seq <= 0:
        raise ValueError(f"{cfg.name}: learned positions need max_seq > 0 "
                         f"at init, got {max_seq}")
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    if not meta and torch.device(generator.device).type != dev.type:
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
# logical specs
# ==========================================================================
# The reference's logical axis names a dim of every parameter and cache
# leaf (``repro.models.transformer.make_params``/``init_cache``), without
# its leading stacked-period axis: the port keeps one tensor a layer.

def _attn_specs(cfg, cross=False):
    s = {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
         "wv": ("embed", "kv"), "wo": ("heads", "embed")}
    if cross:
        return s | {"wk": ("embed", "heads"), "wv": ("embed", "heads")}
    if cfg.attn_bias:
        s |= {"bq": ("heads",), "bk": ("kv",), "bv": ("kv",)}
    if cfg.qk_norm:
        s |= {"q_norm": (None,), "k_norm": (None,)}
    return s


def _mlp_specs(cfg):
    s = {"wu": ("embed", "ff"), "wd": ("ff", "embed")}
    if cfg.act in ("silu", "geglu"):
        s["wg"] = ("embed", "ff")
    return s


def _moe_specs(cfg):
    s = {"router": ("embed", None),
         "wg": ("expert", "embed", "e_ff"),
         "wu": ("expert", "embed", "e_ff"),
         "wd": ("expert", "e_ff", "embed")}
    if cfg.n_shared_experts:
        s["shared"] = _mlp_specs(cfg)
    return s


def _ssm_specs(cfg):
    return {"in_proj": ("embed", "ssm"), "conv_w": (None, "ssm"),
            "conv_b": ("ssm",), "dt_w": ("ssm",), "dt_b": ("ssm",),
            "w_B": ("ssm", None), "w_C": ("ssm", None),
            "A_log": ("ssm", None), "d_skip": ("ssm",),
            "out_proj": ("ssm", "embed")}


def _mlstm_specs(cfg):
    return {"wq": ("embed", "heads"), "wk": ("embed", "heads"),
            "wv": ("embed", "heads"), "wi": ("embed", None),
            "wf": ("embed", None), "wo_gate": ("embed", "heads"),
            "out_proj": ("heads", "embed")}


def _slstm_specs(cfg):
    return {"W": ("embed", None), "b": (None,), "R": (None, None, None),
            "out_proj": (None, "embed")}


_MIXER_SPECS = {"attn": _attn_specs, "swa": _attn_specs, "enc": _attn_specs,
                "mamba": _ssm_specs, "mlstm": _mlstm_specs,
                "slstm": _slstm_specs}


def _block_specs(cfg, kind, *, is_encoder=False):
    s = {"ln1": (None,)}
    if kind == "hymba":
        s["mixer"] = {"attn": _attn_specs(cfg), "ssm": _ssm_specs(cfg)}
    else:
        s["mixer"] = _MIXER_SPECS[kind](cfg)
    if cfg.cross_attn and not is_encoder:
        s["ln_x"] = (None,)
        s["cross"] = _attn_specs(cfg, cross=True)
    if cfg.d_ff > 0 or cfg.is_moe:
        s["ln2"] = (None,)
        s["ffn"] = _moe_specs(cfg) if cfg.is_moe and not is_encoder \
            else _mlp_specs(cfg)
    return s


def _flatten(tree, prefix=""):
    """{dotted path: leaf} of nested dicts and lists, named and ordered as
    ``Params(tree).named_parameters()``: a node's own leaves first, then
    its subtrees."""
    items = list(tree.items() if isinstance(tree, dict)
                 else enumerate(tree))
    sub = lambda v: isinstance(v, (dict, list))
    out = {f"{prefix}{k}": v for k, v in items if not sub(v)}
    for k, v in items:
        if sub(v):
            out.update(_flatten(v, f"{prefix}{k}."))
    return out


def param_specs(cfg: ModelConfig, max_seq: int = 0) -> dict:
    """{name: logical spec} of every parameter ``make_params(cfg, ...,
    max_seq=max_seq)`` makes, keyed as its ``named_parameters()`` (and in
    that order): the reference's spec of the leaf without the stacked
    layer axis."""
    check_supported(cfg)
    tree = {"embed": ("vocab", "embed"),
            "layers": [_block_specs(cfg, layer_kind(cfg, i))
                       for i in range(cfg.n_layers)],
            "final_norm": (None,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("embed", "vocab")
    if cfg.pos == "learned":
        tree["dec_pos"] = (None, "embed")
    if cfg.is_enc_dec:
        tree["enc"] = {"layers": [_block_specs(cfg, "enc", is_encoder=True)
                                  for _ in range(cfg.enc_layers)],
                       "final_norm": (None,)}
    return _flatten(tree)


def cache_specs(cfg: ModelConfig, B: int, S: int) -> list:
    """The logical specs of ``init_cache(cfg, B, S)``, in its layout (one
    dict a layer): the reference's without the stacked layer axis."""
    check_supported(cfg)
    out = []
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        sp = {}
        if kind in ("attn", "swa", "hymba"):
            seq_ax = "kv_seq" if kind == "attn" else None
            sp["k"] = ("batch", seq_ax, "kv_heads", None)
            sp["v"] = ("batch", seq_ax, "kv_heads", None)
            sp["pos_ids"] = ("batch", seq_ax)
        if kind in ("hymba", "mamba"):
            sp["ssm"] = {"conv": ("batch", None, "ssm"),
                         "h": ("batch", "ssm", None)}
        if kind == "mlstm":
            sp |= {"C": ("batch", None, None, None), "n": ("batch", None, None),
                   "m": ("batch", None)}
        if kind == "slstm":
            sp |= {k: ("batch", None) for k in ("h", "c", "n", "m")}
        if cfg.cross_attn:
            sp["cross_k"] = ("batch", None, None, None)
            sp["cross_v"] = ("batch", None, None, None)
        out.append(sp)
    return out


def params_from_named(named: dict) -> Params:
    """A ``Params`` holding the given tensors (not copied), from {dotted
    name: tensor} as ``named_parameters()`` names them; a numeric path
    component is a list index."""
    return Params(nested(named))


def nested(named: dict) -> dict:
    """{dotted name: tensor} as nested dicts and lists, read like a
    ``Params`` (``p["mixer"]["wq"]``, ``"ffn" in p``) but making no new
    leaves: a sharded step's compute forms keep their autograd history."""
    root: dict = {}
    for name, t in named.items():
        node, parts = root, name.split(".")
        for a in parts[:-1]:
            node = node.setdefault(a, {})
        node[parts[-1]] = t

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [build(node[str(i)]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}
    return build(root)


def _on_model(spec: tuple, d: int) -> bool:
    """Whether "model" splits dim ``d`` under a resolved spec."""
    e = spec[d] if d < len(spec) else None
    return e is not None and "model" in ((e,) if isinstance(e, str) else e)


def tp_layout(cfg: ModelConfig, specs: dict, n: int, r: int) -> dict:
    """{name: (dims kept as blocks, take, partial)}: how model rank ``r``
    of ``n`` computes on each parameter (``specs`` {name: resolved spec};
    the fields of ``sharding.spmd.LeafPlan`` but the spec), the
    reference's tensor parallelism over "model":

      * attention and whisper's cross-attention: ``wq`` (and the cross
        ``wk``/``wv``) column-parallel over the heads, ``wo`` row-parallel,
        where "model" splits ``wq`` and every rank gets a head; the
        self-attention's ``wk``, ``wv``, ``bk``, ``bv`` and QK-norm scales
        stay whole on every rank, their gradients shares (``partial``);
      * the dense MLP and the shared experts: ``wg``, ``wu`` over "ff",
        ``wd`` row-parallel;
      * the mamba mixer over its channels where "model" splits them
        (``conv_b``): ``in_proj`` [x | z] taken as the rank's x and z
        columns, the rest of its "ssm" dims kept;
      * the mLSTM over its heads as the attention (``wi``, ``wf`` whole,
        ``partial``);
      * ``embed`` over the vocab's rows and ``lm_head`` over its columns
        (vocab-parallel).

    A block that cuts a head (``H % n != 0``: hymba's 25 heads over 2,
    qwen1.5's 20 over 16) is gathered over "model" and the rank's heads
    taken, 13 and 12 of 25 (``spmd.split_range``).  A leaf the rules
    replicate over "model", or a group with fewer heads than ranks, runs
    whole on every rank, as in the reference; so does the sLSTM, which has
    no "model" dim.  The routed experts keep their own split (the step's
    expert dims)."""
    out = {name: ((), None, False) for name in specs}
    if n == 1:
        return out
    groups: dict = {}
    for name in specs:
        prefix, _, leaf = name.rpartition(".")
        groups.setdefault(prefix, set()).add(leaf)

    def key(prefix, leaf):
        return f"{prefix}.{leaf}" if prefix else leaf

    def heads(prefix, leaves, cols, partial, count, unit):
        if not _on_model(specs[key(prefix, "wq")], 1) or count < n:
            return
        lo, hi = spmd.split_range(count, n, r)
        for leaf, dim in cols.items():
            if leaf not in leaves:
                continue
            if count % n == 0:
                out[key(prefix, leaf)] = ((dim,), None, False)
            else:
                out[key(prefix, leaf)] = (
                    (), (dim, [(lo * unit, hi * unit)], count * unit), False)
        for leaf in partial & leaves:
            out[key(prefix, leaf)] = ((), None, True)

    H, hd = cfg.n_heads, cfg.head_dim
    for prefix, leaves in groups.items():
        if "router" in leaves or "R" in leaves:         # routed experts,
            continue                                    # the sLSTM
        if "in_proj" in leaves:                         # mamba
            Dss = cfg.d_ssm
            if not _on_model(specs[key(prefix, "conv_b")], 0):
                continue
            lo, hi = spmd.split_range(Dss, n, r)
            for leaf, dim in (("conv_w", 1), ("conv_b", 0), ("dt_w", 0),
                              ("dt_b", 0), ("w_B", 0), ("w_C", 0),
                              ("A_log", 0), ("d_skip", 0), ("out_proj", 0)):
                out[key(prefix, leaf)] = ((dim,), None, False)
            out[key(prefix, "in_proj")] = (
                (), (1, [(lo, hi), (Dss + lo, Dss + hi)], 2 * Dss), False)
        elif "wi" in leaves:                            # mLSTM
            heads(prefix, leaves, {"wq": 1, "wk": 1, "wv": 1, "wo_gate": 1,
                                   "out_proj": 0}, {"wi", "wf"}, H, hd)
        elif "wq" in leaves:                            # attention
            cols = {"wq": 1, "bq": 0, "wo": 0}
            partial = {"wk", "wv", "bk", "bv", "q_norm", "k_norm"}
            if prefix.endswith("cross"):
                cols |= {"wk": 1, "wv": 1}
                partial = set()
            heads(prefix, leaves, cols, partial, H, hd)
        elif "wu" in leaves:                            # dense MLP
            if _on_model(specs[key(prefix, "wu")], 1):
                for leaf, dim in (("wg", 1), ("wu", 1), ("wd", 0)):
                    if leaf in leaves:
                        out[key(prefix, leaf)] = ((dim,), None, False)
    for name, dim in (("embed", 0), ("lm_head", 1)):
        if name in specs and _on_model(specs[name], dim):
            out[name] = ((dim,), None, False)
    return out


# ==========================================================================
# caches
# ==========================================================================

def cache_len_for(cfg, kind, S):
    if kind in ("swa", "hymba") and cfg.sliding_window:
        return min(cfg.sliding_window, S)
    return S


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=None, device=None,
               ctx=None):
    """Decoder state for the serve step: one dict per layer, by its kind
    (ring caches of rotated keys for swa/hymba, full caches for attn; the
    SSM state for hymba/mamba; the float32 recurrent states C/n/m for
    mlstm and h/c/n/m for slstm, whose size does not depend on S); with
    ``cross_attn``, every layer also holds the encoder's projected keys
    and values, ``cross_k``/``cross_v`` (B, enc_seq, n_heads, head_dim),
    which the prefill writes.  On ``device="meta"`` the leaves have their
    shapes and dtypes and no storage.

    With ``ctx`` (a mesh, or a sharded step's ``spmd.Ctx``), ``B`` is the
    global batch and the cache is this rank's blocks of it under
    ``cache_specs`` resolved with the mesh's default rules (the
    reference's layout): its rows over the batch axes, an attn layer's
    slots ("kv_seq") and the SSM's channels ("ssm") over "model", each
    whole where the mesh does not divide it, the rest replicated.  An
    attn layer whose slots are split also holds ``slots``, the int32
    global ids of the rank's W / n_model slots, which its prefill and
    decode read (``layers.attention_block``)."""
    check_supported(cfg)
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    dt = dtype or cdtype(cfg)
    if ctx is not None:
        return _rank_cache(cfg, B, S, dt, dev, ctx)
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


def _rank_cache(cfg, B, S, dt, dev, ctx):
    """``init_cache``'s blocks of one rank (see there)."""
    if not isinstance(ctx, spmd.Ctx):
        ctx = spmd.Ctx.of(ctx)
    whole = init_cache(cfg, B, S, dt, "meta")
    specs = partition.tree_pspecs(cache_specs(cfg, B, S), whole, ctx)

    def blocks(c, sp):
        if isinstance(c, dict):
            return {k: blocks(c[k], sp[k]) for k in c}
        shape = spmd.block(c, sp, ctx).shape
        return torch.full(shape, -1 if c.dtype == torch.int32 else 0,
                          dtype=c.dtype, device=dev)
    out = []
    for c, sp in zip(whole, specs):
        b = blocks(c, sp)
        if "k" in sp and _on_model(sp["k"], 1):
            Wr = b["k"].shape[1]
            b["slots"] = torch.arange(Wr * ctx.model_index,
                                      Wr * (ctx.model_index + 1),
                                      dtype=torch.int32, device=dev)
        out.append(b)
    return out


# ==========================================================================
# forward pass
# ==========================================================================

def _apply_block(cfg, kind, p, x, *, mode, cache, pos, enc_out=None,
                 ctx=None):
    """One layer: (x, new_cache, aux), aux the MoE loss (None without
    one, so a dense layer launches nothing for it).  A decoder block of an
    encoder-decoder attends to ``enc_out`` after its mixer (prefill and
    train), or to the cache's ``cross_k``/``cross_v`` (decode).

    A part whose compute form is a model rank's (``spmd.is_part``) is a
    tensor-parallel region: its input enters through ``spmd.model_copy``
    and its partial output leaves through ``spmd.model_sum`` (hymba's
    attention and SSM heads share one of each), so ``x`` stays whole on
    every model rank between the parts, the reference's layout."""
    aux = None
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    new_cache = {}
    pm = p["mixer"]
    if kind in ("attn", "swa", "enc"):
        tp = spmd.is_part(pm["wq"], cfg.q_dim, ctx)
        mix, kv_cache = layers.attention_block(
            pm, spmd.model_copy(h, ctx) if tp else h, cfg, kind=kind,
            mode=mode, cache=cache, pos=pos, ctx=ctx)
        if tp:
            mix = spmd.model_sum(mix, ctx)
        if kv_cache:
            new_cache.update(kv_cache)
    elif kind == "hymba":
        ta = spmd.is_part(pm["attn"]["wq"], cfg.q_dim, ctx)
        ts = spmd.is_part(pm["ssm"]["conv_b"], cfg.d_ssm, ctx)
        hc = spmd.model_copy(h, ctx) if ta or ts else h
        a_cache = {k: cache[k] for k in ("k", "v", "pos_ids")} \
            if cache else None
        mix_a, kv_cache = layers.attention_block(
            pm["attn"], hc if ta else h, cfg, kind="hymba", mode=mode,
            cache=a_cache, pos=pos, ctx=ctx)
        mix_s, s_state = ssm.mamba_mixer(
            pm["ssm"], hc if ts else h, cfg, mode=mode,
            state=cache.get("ssm") if cache else None, ctx=ctx)
        if ta and ts:
            mix = spmd.model_sum(0.5 * (mix_a + mix_s), ctx)
        else:
            if ta:
                mix_a = spmd.model_sum(mix_a, ctx)
            if ts:
                mix_s = spmd.model_sum(mix_s, ctx)
            mix = 0.5 * (mix_a + mix_s)
        if kv_cache:
            new_cache.update(kv_cache)
        if s_state:
            new_cache["ssm"] = s_state
    elif kind == "mamba":
        tp = spmd.is_part(pm["conv_b"], cfg.d_ssm, ctx)
        mix, s_state = ssm.mamba_mixer(
            pm, spmd.model_copy(h, ctx) if tp else h, cfg, mode=mode,
            state=cache.get("ssm") if cache else None, ctx=ctx)
        if tp:
            mix = spmd.model_sum(mix, ctx)
        if s_state:
            new_cache["ssm"] = s_state
    elif kind == "mlstm":
        tp = spmd.is_part(pm["wq"], cfg.q_dim, ctx)
        mix, st = ssm.mlstm_mixer(pm, spmd.model_copy(h, ctx) if tp else h,
                                  cfg, mode=mode, state=cache, ctx=ctx)
        if tp:
            mix = spmd.model_sum(mix, ctx)
        if st:
            new_cache.update(st)
    elif kind == "slstm":
        mix, st = ssm.slstm_mixer(pm, h, cfg, mode=mode, state=cache)
        if st:
            new_cache.update(st)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    x = x + mix
    if cfg.cross_attn and kind != "enc":
        pc = p["cross"]
        tc = spmd.is_part(pc["wq"], cfg.q_dim, ctx)
        hx = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
        if mode == "decode":
            ek, ev = cache["cross_k"], cache["cross_v"]
            new_cache["cross_k"], new_cache["cross_v"] = ek, ev
            if tc:
                lo, hi = ctx.part(cfg.n_heads)
                ek, ev = ek[:, :, lo:hi], ev[:, :, lo:hi]
        else:
            eo = spmd.model_copy(enc_out, ctx) if tc else enc_out
            B, Se, _ = enc_out.shape
            shape = (B, Se, -1, cfg.head_dim)
            ek = (eo @ pc["wk"]).reshape(shape)
            ev = (eo @ pc["wv"]).reshape(shape)
            if mode != "train":
                new_cache["cross_k"], new_cache["cross_v"] = (
                    spmd.model_gather(t, 2, ctx, cfg.n_heads) if tc else t
                    for t in (ek, ev))
        c = layers.cross_attention(pc, spmd.model_copy(hx, ctx) if tc
                                   else hx, ek, ev, cfg)
        x = x + (spmd.model_sum(c, ctx) if tc else c)
    if "ffn" in p:
        h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.is_moe and kind != "enc":
            f, aux, _ = moe.moe_block(p["ffn"], h2, cfg, ctx)
        else:
            tf = spmd.is_part(p["ffn"]["wu"], cfg.d_ff, ctx)
            f = layers.mlp(p["ffn"], spmd.model_copy(h2, ctx) if tf else h2,
                           cfg.act)
            if tf:
                f = spmd.model_sum(f, ctx)
        x = x + f
    return x, new_cache, aux


def _leaf(params, name: str, ctx):
    """The compute form of a parameter outside the periods (``embed``,
    ``lm_head``, ``final_norm``, ``dec_pos``, the encoder's
    ``final_norm``), gathered at its use in a sharded step whose context
    gathers (``ctx.gather``), else the tensor itself."""
    t = params
    for part in name.split("."):
        t = t[part]
    if ctx is None or ctx.gather is None:
        return t
    return ctx.gather(name, [(name, t)])[0]


def head_weight(cfg, params, ctx=None):
    """The head's (D, V) weight (``embed`` transposed when tied, else
    ``lm_head``): a model rank's block of the vocab's columns when the
    head runs vocab-parallel."""
    if cfg.tie_embeddings:
        return _leaf(params, "embed", ctx).T
    return _leaf(params, "lm_head", ctx)


def head(cfg, params, x, ctx=None):
    """Final logits of hidden states x (B, S, D); vocab-parallel (this
    model rank's block of the vocab, ``x`` entering through
    ``spmd.model_copy``) when the head's compute form is a block
    (``full_logits`` gathers them)."""
    w = head_weight(cfg, params, ctx)
    if spmd.is_part(w, cfg.vocab, ctx):
        x = spmd.model_copy(x, ctx)
    return layers.softcap(x @ w.to(x.dtype), cfg.final_softcap)


def full_logits(cfg, logits, ctx=None):
    """Every column of vocab-parallel logits, gathered over "model"
    (the logits themselves when they are whole)."""
    if not spmd.is_part(logits, cfg.vocab, ctx):
        return logits
    return spmd.all_gather(logits, logits.dim() - 1, ctx.group("model"),
                           ctx.n_model)


# the products the "dots" policy saves: 2-D ones, no batch dimension (a
# (B, S, D) @ (D, F) product reaches the dispatcher as one aten.mm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return _ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _period_named(key, ps) -> list:
    """[(name, block)] of a period's layers ``ps``, ``key`` their name
    prefixes (``"layers.3."``)."""
    return [(pre + n, t) for pre, m in zip(key, ps)
            for n, t in m.named_parameters()]


def _period_params(ctx, key, ps):
    """A period's layers as their compute forms, gathered by the sharded
    step's ``ctx.gather`` (nested dicts), or ``ps`` as they are."""
    if ctx is None or ctx.gather is None:
        return ps
    named = _period_named(key, ps)
    flat = dict(zip((n for n, _ in named), ctx.gather(key, named)))
    return [nested({n[len(pre):]: t for n, t in flat.items()
                    if n.startswith(pre)}) for pre in key]


def _periods(ctx, blocks, prefix: str, P: int):
    """Yields (layer indices, key) of each period of ``blocks`` in order.
    In a sharded step whose context gathers, the period's gathers were
    started one period ahead: its handles are waited on before it is
    yielded (before its checkpoint), then the next period's gathers are
    started, so they run while it computes."""
    g = ctx.gather if ctx is not None else None
    spans = [tuple(range(i, min(i + P, len(blocks))))
             for i in range(0, len(blocks), P)]
    keys = [tuple(f"{prefix}{i}." for i in sp) for sp in spans]

    def start(j):
        g.prefetch(keys[j], _period_named(keys[j],
                                          [blocks[i] for i in spans[j]]))
    if g is not None and spans:
        start(0)
    for j, sp in enumerate(spans):
        if g is not None:
            g.wait(keys[j])
            if j + 1 < len(spans):
                start(j + 1)
        yield sp, keys[j]


def _run_period(cfg, kinds, ps, x, aux, enc_out, ctx=None, key=None):
    """Train-mode blocks of one period: (x, aux), aux summed in the
    forward's order.  In a sharded step the period's parameters are
    gathered here, under the period's checkpoint, so a recompute gathers
    them again."""
    ps = _period_params(ctx, key, ps)
    for kind, p in zip(kinds, ps):
        x, _, a = _apply_block(cfg, kind, p, x, mode="train", cache=None,
                               pos=0, enc_out=enc_out, ctx=ctx)
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


def encode(cfg: ModelConfig, params, frames, ctx=None):
    """Whisper's encoder over stubbed frame embeddings (B, enc_seq, D):
    the frames in the compute dtype plus the sinusoidal table rounded to
    it, the bidirectional ``enc`` blocks (each one period for ``remat``,
    as the reference's encoder scan), then ``enc.final_norm``."""
    x = frames.to(cdtype(cfg))
    x = x + layers.sinusoidal_pos(x.shape[1], cfg.d_model, x.dtype,
                                  x.device)[None]
    run = _remat(cfg)
    blocks = params["enc"]["layers"]
    for (i,), key in _periods(ctx, blocks, "enc.layers.", 1):
        x, _ = run(cfg, ("enc",), (blocks[i],), x, None, None, ctx, key)
    return layers.rms_norm(x, _leaf(params, "enc.final_norm", ctx),
                           cfg.norm_eps)


def _learned_pos(cfg, table, S, mode, pos):
    """Rows of the ``dec_pos`` table for the tokens: [:S], or row ``pos``
    in decode.  Where the reference would clamp (decode) or fail to
    broadcast (a longer prompt), this raises ValueError."""
    rows = table.shape[0]
    if mode == "decode":
        if not 0 <= pos < rows:
            raise ValueError(f"{cfg.name}: decode position {pos} outside "
                             f"the {rows} learned positions (max_seq)")
        return table[pos:pos + 1]
    if S > rows:
        raise ValueError(f"{cfg.name}: {S} tokens exceed the {rows} "
                         f"learned positions (max_seq)")
    return table[:S]


def _embed(cfg, params, tokens, ctx):
    """The tokens' rows of ``embed`` in the compute dtype.  Vocab-parallel
    (the compute form a model rank's block of rows): each rank gathers
    the tokens its block holds and zeros for the others, and the sum over
    "model" is exact (one rank adds its row to zeros)."""
    dt = cdtype(cfg)
    emb = _leaf(params, "embed", ctx)
    if not spmd.is_part(emb, cfg.vocab, ctx, dim=0):
        return emb[tokens.long()].to(dt)
    V = emb.shape[0]
    local = tokens.long() - ctx.model_index * V
    own = (local >= 0) & (local < V)
    rows = torch.where(own[..., None], emb[local.clamp(0, V - 1)], 0)
    return spmd.model_sum(rows.to(dt), ctx)


def forward(cfg: ModelConfig, params, tokens, *, mode="train", cache=None,
            pos=0, frames=None, skip_head=False, ctx=None):
    """tokens (B, S) integer; ``frames`` (B, enc_seq, D) the encoder's
    input for an encoder-decoder in train and prefill modes (decode reads
    the cache's cross keys and values instead).  Returns (logits,
    new_cache, aux) as the reference does (aux, the layers' MoE losses
    summed in float32; 0 without MoE); with skip_head=True returns the
    final hidden states instead of logits.  ``ctx`` (a
    ``sharding.spmd.Ctx``) is a sharded step's view of the mesh, which
    only the MoE layers read (``models/moe.py``): the rest of the forward
    runs on this rank's rows as on one device."""
    check_supported(cfg)
    dt = cdtype(cfg)
    x = _embed(cfg, params, tokens, ctx)
    if cfg.family == "audio" or cfg.name.startswith("gemma"):
        # a 0-d tensor of x's dtype: the scale rounds to it first, as the
        # reference's weakly typed Python float does
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dt,
                           device=x.device)
    if cfg.pos == "learned":
        x = x + _learned_pos(cfg, _leaf(params, "dec_pos", ctx),
                             tokens.shape[1], mode, pos)[None].to(dt)
    enc_out = None
    if cfg.is_enc_dec and mode != "decode":
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs frames "
                             f"in {mode} mode")
        enc_out = encode(cfg, params, frames, ctx)
    new_caches = [] if cache is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["layers"]
    if mode == "train" and cache is None:
        # period by period, each under cfg.remat's checkpoint
        run = _remat(cfg)
        for span, key in _periods(ctx, blocks, "layers.", cfg.period):
            ps = tuple(blocks[i] for i in span)
            kinds = tuple(layer_kind(cfg, i) for i in span)
            x, aux = run(cfg, kinds, ps, x, aux, enc_out, ctx, key)
    else:
        for span, key in _periods(ctx, blocks, "layers.", cfg.period):
            ps = _period_params(ctx, key, [blocks[i] for i in span])
            for i, p in zip(span, ps):
                c = cache[i] if cache is not None else None
                x, nc, a = _apply_block(cfg, layer_kind(cfg, i), p, x,
                                        mode=mode, cache=c, pos=pos,
                                        enc_out=enc_out, ctx=ctx)
                if a is not None:
                    aux = aux + a
                if cache is not None:
                    new_caches.append(nc if nc else c)
            del ps
    x = layers.rms_norm(x, _leaf(params, "final_norm", ctx), cfg.norm_eps)
    if skip_head:
        return x, new_caches, aux
    return head(cfg, params, x, ctx), new_caches, aux


# ==========================================================================
# losses
# ==========================================================================

def _xent_parts(lg, labels, cfg=None, ctx=None):
    """(lse, gold, mask) float32 of logits lg (..., V) against labels
    (labels < 0 are padding): the row max in lg's dtype, then exp, sum and
    log in float32, and the gold logit read at max(label, 0) (the
    reference's one-hot masked sum picks the same single value).
    Vocab-parallel logits (a model rank's block of ``cfg.vocab``) take
    ``spmd.vocab_xent``'s same steps over "model"."""
    if spmd.is_part(lg, cfg.vocab, ctx):
        lse, gold = spmd.vocab_xent(lg, labels, ctx)
        return lse, gold, (labels >= 0).float()
    m = lg.amax(dim=-1).float()
    lf = lg.float()
    lse = torch.log(torch.exp(lf - m[..., None]).sum(dim=-1)) + m
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    return lse, gold, (labels >= 0).float()


def _denom(count, ctx):
    """The loss's divisor: the unpadded tokens of the whole batch (summed
    over the batch ranks when it is split; a microbatch's global count in
    its segment, ``ctx.share``), at least 1."""
    if ctx is not None and ctx.share is not None:
        count = ctx.share.count
    elif ctx is not None:
        count = ctx.batch_sum(count)
    return torch.clamp_min(count, 1.0)


# the MoE loss's weight in the train loss
AUX_COEF = 0.01


def lm_loss(cfg, logits, labels, aux, aux_coef=AUX_COEF, z_coef=1e-4,
            ctx=None):
    """Masked token cross-entropy (port of the reference's ``lm_loss``):
    (nll + z_coef * mean((lse * mask)^2) + aux_coef * aux, {"nll", "aux"}),
    the means over the unpadded tokens (at least 1).  With a split batch
    (``ctx.split``) the means are this rank's sums over the global count:
    its share of the global loss, the shares adding up to it."""
    lse, gold, mask = _xent_parts(logits, labels, cfg, ctx)
    denom = _denom(mask.sum(), ctx)
    loss = ((lse - gold) * mask).sum() / denom
    zloss = z_coef * ((lse * mask) ** 2).sum() / denom
    return loss + zloss + aux_coef * aux, {"nll": loss, "aux": aux}


def lm_loss_chunked(cfg, x, head, labels, aux, aux_coef=AUX_COEF,
                    z_coef=1e-4, final_softcap=0.0, ctx=None):
    """The same loss from the final hidden states x (B, S, D) and the head
    (D, V), the sequence cut into ``cfg.xent_chunk`` chunks (a Python
    loop, as the reference's): each chunk's logits are made, softcapped and
    reduced to its sums before the next, so the whole (B, S, V) logits are
    never one tensor.  ``ctx`` as ``lm_loss``'s."""
    S = x.shape[1]
    n = max(1, cfg.xent_chunk)
    c = -(-S // n)
    if spmd.is_part(head, cfg.vocab, ctx):     # vocab-parallel
        x = spmd.model_copy(x, ctx)
    nll_sum = z_sum = None
    for i in range(n):
        xs = x[:, i * c:(i + 1) * c]
        if xs.shape[1] == 0:                # the reference's empty chunk
            continue                        # adds zeros
        lg = layers.softcap(xs @ head, final_softcap)
        lse, gold, msk = _xent_parts(
            lg, labels[:, i * c:i * c + xs.shape[1]], cfg, ctx)
        nll = ((lse - gold) * msk).sum()
        z = ((lse * msk) ** 2).sum()
        nll_sum = nll if nll_sum is None else nll_sum + nll
        z_sum = z if z_sum is None else z_sum + z
    denom = _denom((labels >= 0).sum().float(), ctx)
    loss = nll_sum / denom
    zloss = z_coef * z_sum / denom
    return loss + zloss + aux_coef * aux, {"nll": loss, "aux": aux}
