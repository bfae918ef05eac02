"""Layer primitives of the LM substrate in PyTorch (port of
``repro.models.layers``: norms, activations, rotary and sinusoidal
positions, the dense MLP, self-attention and whisper's cross-attention).

Every function takes parameters as a mapping (``p["wq"]``, ``"q_norm" in
p``) and tensors in the reference's layouts: activations (B, S, D),
queries and keys (B, S, heads, head_dim).  Prefill and train
self-attention (causal in a decoder, bidirectional in an encoder) and
cross-attention in every mode go through ``kernels.ops.flash_attention``
(the CUDA kernel on the card, its plain version on the CPU); decode
self-attention over the ring cache, which needs key positions and a query
offset the kernel does not take, is plain tensor code here (``attend``),
as it is jnp outside any Pallas kernel in the reference.

Tensor parallelism over "model" (a sharded step's ``ctx``,
``sharding/spmd.py``): when ``wq`` holds a model rank's heads only (its
compute form, ``train/step.py``'s plan), ``attention_block`` and
``cross_attention`` run those heads and return the rank's partial output
of ``wo``, which the caller sums over "model"; the keys and values of
self-attention are computed whole, and each query head reads its own kv
head of them (``kv_heads``).

A full (``attn``) decode cache made for a mesh (``transformer.init_cache``
with a context) holds a model rank's block of the slots, the reference's
"kv_seq" over "model", and its ``slots`` leaf names them.  Decode then
takes the reference's flash-decode form: every model rank attends with
every query head over its own slots (``attend_partial``), the ranks'
float32 statistics are combined over "model" (``spmd.decode_combine``),
and each rank takes its own heads into ``wo``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..core.types import resolve_device
from ..kernels import ops
from ..sharding import spmd

NEG_INF = -1e30


# --------------------------------------------------------------------------
# norms / activations / positional encodings
# --------------------------------------------------------------------------

def rms_norm(x, weight, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def act_fn(name):
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh")}[name]


def softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


@functools.lru_cache(maxsize=32)
def _inv_freq(head_dim: int, theta: float, device: torch.device):
    """1 / theta^(i / half), float32, computed once on the CPU and moved to
    ``device`` once, so the card and the CPU rotate by the same angles."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32) / half))
    return inv.to(device)


def rope_freqs(positions, head_dim, theta):
    """positions (...,) int -> (..., head_dim/2) angles."""
    inv = _inv_freq(head_dim, float(theta), positions.device)
    return positions[..., None].float() * inv


def apply_rope(x, positions, theta):
    """x (..., S, H, hd), positions (..., S)."""
    ang = rope_freqs(positions, x.shape[-1], theta)      # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=8)
def _sinusoid_table(seq: int, dim: int, device: torch.device):
    """The reference's float32 table (seq, dim), built once on the CPU and
    moved to ``device`` once, so the card and the CPU add the same table.
    Its products and the division round as the reference's float32 steps
    do; exp, sin and cos are taken in float64 and rounded once (XLA:CPU's
    float32 ones are not correctly rounded: the reference's own eager and
    jitted tables differ by up to 1.2e-4 at 1,500 positions)."""
    half = dim // 2
    e = (torch.tensor(-math.log(10000.0), dtype=torch.float32) *
         torch.arange(half, dtype=torch.float32)) / max(half - 1, 1)
    freq = torch.exp(e.double()).float()
    ang = (torch.arange(seq, dtype=torch.float32)[:, None] * freq).double()
    table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()
    return table.to(device)


def sinusoidal_pos(seq, dim, dtype=torch.float32, device=None):
    """(seq, dim) sinusoidal positions (sines, then cosines) in ``dtype``,
    on the card unless ``device`` says otherwise (``meta``: no storage)."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    return _sinusoid_table(seq, dim, dev).to(dtype)


def clear_tables() -> None:
    """Drop the cached rotary frequencies and sinusoidal tables, each made
    once a process: the next call makes them again (a dry run's traces
    each count them)."""
    _inv_freq.cache_clear()
    _sinusoid_table.cache_clear()


# --------------------------------------------------------------------------
# dense MLP (gated SiLU, gated GELU or plain GELU)
# --------------------------------------------------------------------------

def mlp(p, x, act="silu"):
    if act == "silu":                                    # gated SiLU
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    elif act == "geglu":                                 # gated GELU (gemma)
        h = act_fn("gelu")(x @ p["wg"]) * (x @ p["wu"])
    else:                                                # plain GELU
        h = act_fn(act)(x @ p["wu"])
    return h @ p["wd"]


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _qk_norm(q, k, p, eps):
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    return q, k


def part_of(ctx, w, full: int, n: int):
    """[lo, hi): the heads or channels of ``n`` that this model rank
    computes when the compute form ``w`` holds a part of its ``full`` last
    dim (a tensor-parallel region), else None."""
    return ctx.part(n) if spmd.is_part(w, full, ctx) else None


def kv_heads(lo: int, hi: int, n_heads: int, n_kv: int):
    """The kv heads that query heads [lo, hi) read: a ``slice`` of them
    when local head j reads kv head j // G' of it (G' = its heads a kv
    head, the kernel's mapping), else the kv head of each query head in
    turn (a rank that starts or ends mid-group, G' = 1)."""
    G = n_heads // n_kv
    kv = [h // G for h in range(lo, hi)]
    a, n, m = kv[0], hi - lo, kv[-1] + 1 - kv[0]
    if n % m == 0 and all(kv[j] - a == j // (n // m) for j in range(n)):
        return slice(a, a + m)
    return kv


def _kv_of(t, sel):
    """The kv heads ``sel`` (``kv_heads``) of keys or values (B, S, KV,
    hd)."""
    if sel is None:
        return t
    if isinstance(sel, slice):
        return t[:, :, sel]
    return t.index_select(2, torch.tensor(sel, device=t.device))


def qkv_proj(p, x, cfg, n_heads=None):
    """Queries of ``n_heads`` heads (all of them by default; a model
    rank's with a tensor-parallel ``wq``), keys and values of every kv
    head."""
    B, S, D = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, n_heads or cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q, k = _qk_norm(q, k, p, cfg.norm_eps)
    return q, k, v


def _masked_scores(q, k, *, causal, q_offset, window, attn_softcap,
                   kv_positions):
    """The float32 scores of q (B, Sq, H, hd) over k (B, Skv, KV, hd),
    (B, KV, G, Sq, Skv) with G = H // KV, scaled and softcapped, and the
    mask of the keys each query sees: a written slot (``kv_positions``
    >= 0), causal and within ``window`` where asked.  Scores in float32
    (the reference's ``preferred_element_type``: bf16 products are exact
    in float32, so casting first is the same contraction)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=q.device)[None].expand(B, Skv)
    kv_pos = kv_positions[:, None, None, None, :]            # (B,1,1,1,Skv)
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if attn_softcap:
        s = softcap(s, attn_softcap)
    qpos = (q_offset
            + torch.arange(Sq, device=q.device))[None, None, None, :, None]
    m = kv_pos >= 0
    if causal:
        m = m & (kv_pos <= qpos)
    if window:
        m = m & (kv_pos > qpos - window)
    return s, m


def attend(q, k, v, *, causal, q_offset=0, window=0, attn_softcap=0.0,
           kv_positions=None):
    """GQA attention in plain tensor code (the decode path).

    q (B, Sq, H, hd); k/v (B, Skv, KV, hd) with H % KV == 0.  Scores as
    ``_masked_scores``'; the probabilities are cast to v's dtype before
    the value product, as in the reference.  ``q_offset`` is the absolute
    position of q[:, 0]; ``kv_positions`` (B, Skv) gives each key's
    absolute position (ring caches, -1 = empty slot).  The reference's
    query chunking bounds its memory at long Sq and does not change the
    result; decode has Sq = 1."""
    B, Sq, H, hd = q.shape
    s, m = _masked_scores(q, k, causal=causal, q_offset=q_offset,
                          window=window, attn_softcap=attn_softcap,
                          kv_positions=kv_positions)
    p = torch.softmax(torch.where(m, s, NEG_INF), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def attend_partial(q, k, v, *, q_offset, kv_positions, window=0,
                   attn_softcap=0.0):
    """Causal decode attention over a part of the keys (a model rank's
    slots of a sequence-sharded cache), as float32 statistics to combine
    with the other parts' (``spmd.decode_combine``):
    (m, l, o), m the max score over the part's valid keys (``NEG_INF``
    where it has none) and l the sum of exp(s - m) over them, (B, Sq, H);
    o (B, Sq, H, hd) the values weighed by those exponentials, each cast
    to v's dtype first as ``attend`` casts its probabilities.  Scores and
    mask as ``attend``'s; a part with no valid key gives l = 0 and
    o = 0."""
    B, Sq, H, hd = q.shape
    s, valid = _masked_scores(q, k, causal=True, q_offset=q_offset,
                              window=window, attn_softcap=attn_softcap,
                              kv_positions=kv_positions)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())

    def heads(t):                                       # (B, KV, G, Sq)
        return t.permute(0, 3, 1, 2).reshape(B, Sq, H)
    return heads(m[..., 0]), heads(p.sum(dim=-1)), o.reshape(B, Sq, H, hd)


def _slot_block(t, S, W, lo, hi, fill=0):
    """Slots [lo, hi) of ``t`` (B, S, ...) laid into a W-slot cache: the
    last W right-padded with ``fill`` (W > S) or ring-aligned so that
    slot == pos % W (W <= S); only the block is made ([0, W) is the
    whole cache)."""
    if W <= S:
        t = t[:, -W:]
        if S % W:
            t = torch.roll(t, S % W, dims=1)
        return t[:, lo:hi]
    keep = t[:, lo:min(hi, S)]
    pad = [0, 0] * (t.dim() - 2) + [0, hi - lo - keep.shape[1]]
    return F.pad(keep, pad, value=fill)


def attention_block(p, x, cfg, *, kind, mode, cache=None, pos=0,
                    ctx=None):
    """Self-attention mixer.  kind in {attn, swa, hymba, enc}; mode in
    {train, prefill, decode}.  Returns (out, new_cache).  ``enc`` (the
    encoder's blocks) is bidirectional; queries and keys are rotated only
    when ``cfg.pos == "rope"``.  ``cfg.skip_attention`` (a roofline probe)
    drops the attention itself outside decode and returns no cache.  With
    a tensor-parallel ``wq`` (``part_of``) ``out`` is this model rank's
    partial sum.

    Caches hold *rotated* keys of every kv head plus the absolute
    position of each slot (``pos_ids``; -1 = empty).  Sliding-window
    caches are rings of size W written at ``pos % W``; full caches are
    written at ``pos``.  A cache with ``slots`` (the global slot ids of
    the block a model rank holds, ``transformer.init_cache`` for a mesh)
    is that rank's block of the slots: the prefill keeps its slots of the
    whole cache, and a decode step writes the new key only where a slot
    id is ``pos`` (a ``where``, on the rank that owns it) and attends in
    the flash-decode form (see the module's note)."""
    B, S, D = x.shape
    window = cfg.sliding_window if kind in ("swa", "hymba") else 0
    part = part_of(ctx, p["wq"], cfg.q_dim, cfg.n_heads)
    H = cfg.n_heads if part is None else part[1] - part[0]
    kv_sel = None if part is None else kv_heads(*part, cfg.n_heads,
                                                cfg.n_kv_heads)
    q, k, v = qkv_proj(p, x, cfg, H)

    if cfg.skip_attention and mode != "decode":
        # the roofline probe: the projections kept, the S x S scores,
        # softmax and values dropped (their share is measured by
        # difference); v repeated over each kv head's query group, no RoPE
        # and no cache, as the reference's
        v = _kv_of(v, kv_sel)
        KV = v.shape[2]
        out = v[:, :, :, None].expand(B, S, KV, H // KV, cfg.head_dim)
        out = out.to(q.dtype).reshape(B, S, H * cfg.head_dim)
        return out @ p["wo"], None

    rope = cfg.pos == "rope"
    slots = cache.get("slots") if cache is not None else None
    if mode == "decode":
        if rope:
            positions = torch.full((B, S), pos, device=x.device)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        cache_k, cache_v, slot_pos = cache["k"], cache["v"], cache["pos_ids"]
        W = cache_k.shape[1]
        slot = pos % W if window else pos
        ids = torch.arange(W, device=x.device) if slots is None else slots
        sel = (ids == slot)[None, :, None, None]
        cache_k = torch.where(sel, k.to(cache_k.dtype), cache_k)
        cache_v = torch.where(sel, v.to(cache_v.dtype), cache_v)
        slot_pos = torch.where(sel[..., 0, 0], pos, slot_pos)
        new_cache = {"k": cache_k, "v": cache_v, "pos_ids": slot_pos}
        if slots is None:
            out = attend(q, _kv_of(cache_k, kv_sel), _kv_of(cache_v, kv_sel),
                         causal=True, q_offset=pos, window=window,
                         attn_softcap=cfg.attn_softcap,
                         kv_positions=slot_pos)
        else:
            # flash-decode: every query head over this rank's slots, the
            # statistics combined over "model", then the rank's own heads
            qa = q if part is None else \
                spmd.model_gather(q, 2, ctx, cfg.n_heads)
            out = spmd.decode_combine(*attend_partial(
                qa, cache_k, cache_v, q_offset=pos, kv_positions=slot_pos,
                window=window, attn_softcap=cfg.attn_softcap), ctx)
            if part is not None:
                out = out[:, :, part[0]:part[1]]
            out = out.to(q.dtype)
            new_cache["slots"] = slots
    else:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        out = _flash(q, _kv_of(k, kv_sel), _kv_of(v, kv_sel),
                     causal=kind != "enc", window=window,
                     softcap=cfg.attn_softcap)
        new_cache = None
        if mode == "prefill" and cache is not None:
            # the whole cache's slots, or this rank's block of them
            Wr = cache["k"].shape[1]
            W, lo = (Wr, 0) if slots is None else \
                (Wr * ctx.n_model, Wr * ctx.model_index)
            dt = cache["k"].dtype
            new_cache = {
                "k": _slot_block(k, S, W, lo, lo + Wr).to(dt),
                "v": _slot_block(v, S, W, lo, lo + Wr).to(dt),
                "pos_ids": _slot_block(positions, S, W, lo, lo + Wr,
                                       -1).to(torch.int32)}
            if slots is not None:
                new_cache["slots"] = slots

    out = out.reshape(B, S, H * cfg.head_dim)
    return out @ p["wo"], new_cache


def _flash(q, k, v, **kw):
    """The kernel's (B, H, S, hd) interface over the model's (B, S, H, hd)
    tensors: strided views, no copies."""
    return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), **kw).transpose(1, 2)


def cross_attention(p, x, enc_k, enc_v, cfg):
    """Decoder -> encoder cross-attention (whisper).  enc_k/v are already
    projected per layer: (B, Senc, H, hd), H the heads of ``wq`` (a model
    rank's with a tensor-parallel ``wq``, whose ``wo`` then gives its
    partial sum).  q from ``wq`` (no bias, no QK-norm), attention over
    every encoder position (no mask, no key positions), then ``wo``; the
    flash kernel in every mode, decode's single query too."""
    B, S, D = x.shape
    q = (x @ p["wq"]).reshape(B, S, -1, cfg.head_dim)
    out = _flash(q, enc_k, enc_v, causal=False)
    return out.reshape(B, S, -1) @ p["wo"]
