"""State-space and recurrent mixers in PyTorch (port of
``repro.models.ssm``): the Mamba-style selective SSM (hymba's SSM heads
and the ``mamba`` block kind) and the two xLSTM blocks, mLSTM (matrix
memory) and sLSTM (scalar memory).

Training/prefill forms:
  * mamba  -- the recurrence runs through ``kernels.ops.ssm_scan`` (the
    CUDA kernel on the card, its plain version on the CPU), which takes
    the place of the reference's ``lax.scan``.
  * mlstm  -- the stabilized parallel (quadratic) form, chunked over
    queries, in float32 tensor code as in the reference (no kernel).
  * slstm  -- the true recurrence: one step of tensor code per position in
    a Python loop over the sequence, as the reference's ``lax.scan``.

Decode forms are single O(1)-state steps.  Every recurrent state is
float32 whatever the compute dtype is, and no step reads the host.  The
train forms write no tensor in place, so autograd differentiates them (the
scan's gradient is the ``ssm_scan_backward`` kernel's).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import div_const
from .layers import NEG_INF


def ssm_init_state(cfg, B, dtype, device):
    Dss, N, K = cfg.d_ssm, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((B, K - 1, Dss), dtype=dtype, device=device),
            "h": torch.zeros((B, Dss, N), dtype=torch.float32,
                             device=device)}


def _softplus(x):
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _log_sigmoid(x):
    """jax.nn.log_sigmoid: -softplus(-x)."""
    return -_softplus(-x)


def _ssm_proj(p, x, cfg):
    xz = x @ p["in_proj"]
    return xz.chunk(2, dim=-1)                          # x_in, z


def _causal_conv(x, w, prev=None):
    """Depthwise causal conv.  x (B, S, Dss), w (K, Dss); prev (B, K-1, Dss)
    left context for decode."""
    K = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return out, xp[:, -(K - 1):]


def _ssm_coeffs(p, xc, cfg):
    dt = _softplus(xc * p["dt_w"] + p["dt_b"]).float()
    Bm = (xc @ p["w_B"]).float()                        # (..., N)
    Cm = (xc @ p["w_C"]).float()
    A = -torch.exp(p["A_log"].float())                  # (Dss, N)
    return dt, Bm, Cm, A


def mamba_mixer(p, x, cfg, mode="train", state=None):
    """x (B, S, D) -> (out, new_state)."""
    x_in, z = _ssm_proj(p, x, cfg)
    prev = state["conv"] if mode == "decode" else None
    xc, conv_tail = _causal_conv(x_in, p["conv_w"], prev)
    xc = F.silu(xc + p["conv_b"])
    dt, Bm, Cm, A = _ssm_coeffs(p, xc, cfg)
    xf = xc.float()

    if mode == "decode":                                # S == 1 single step
        h = state["h"]
        da = torch.exp(dt[:, 0, :, None] * A[None])     # (B, Dss, N)
        h = da * h + (dt[:, 0] * xf[:, 0])[..., None] * Bm[:, 0][:, None, :]
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
        new_state = {"conv": conv_tail, "h": h}
    else:
        y, h = ops.ssm_scan(dt, Bm, Cm, xf, A)
        new_state = {"conv": conv_tail, "h": h} if mode == "prefill" else None

    y = y + xf * p["d_skip"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p["out_proj"], new_state


# --------------------------------------------------------------------------
# mLSTM -- matrix memory with exponential gating (xLSTM)
# --------------------------------------------------------------------------

def mlstm_init_state(cfg, B, dtype, device):
    H, hd = cfg.n_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, H, hd, hd), **f32),
            "n": torch.zeros((B, H, hd), **f32),
            "m": torch.zeros((B, H), **f32)}


def _mlstm_qkvg(p, x, cfg):
    """The projections; the gates' weights are float32, so x is cast up
    for them (exact), as the reference's promotion does."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = div_const((x @ p["wk"]).reshape(B, S, H, hd), math.sqrt(hd))
    v = (x @ p["wv"]).reshape(B, S, H, hd)
    xf = x.float()
    i_t = xf @ p["wi"].float()                           # (B, S, H)
    f_t = xf @ p["wf"].float()
    o_t = torch.sigmoid(x @ p["wo_gate"]).reshape(B, S, H, hd)
    return q, k, v, i_t, f_t, o_t


def mlstm_mixer(p, x, cfg, mode="train", state=None, chunk=None):
    """x (B, S, D) -> (out, new_state); new_state the final (C, n, m) in
    prefill and decode, None in train."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    if chunk is None:
        chunk = cfg.attn_chunk or S
    q, k, v, i_t, f_t, o_t = _mlstm_qkvg(p, x, cfg)
    logf = _log_sigmoid(f_t)                             # (B, S, H)

    if mode == "decode":
        C, n, m = state["C"], state["n"], state["m"]
        lf, it = logf[:, 0], i_t[:, 0]                   # (B, H)
        lfm = lf + m
        m_new = torch.maximum(lfm, it)
        fp = torch.exp(lfm - m_new)[..., None]           # (B, H, 1)
        ip = torch.exp(it - m_new)[..., None]
        k0 = k[:, 0].float()                             # (B, H, hd)
        v0 = v[:, 0].float()
        C = fp[..., None] * C + ip[..., None] * (v0[..., :, None]
                                                 * k0[..., None, :])
        n = fp * n + ip * k0
        qh = q[:, 0].float()                             # (B, H, hd)
        num = (C @ qh[..., None])[..., 0]                # (B, H, hd)
        # the stabilized state C~ = e^-m C: the |n.q| >= 1 floor becomes
        # e^-m, as in the parallel form
        den = torch.maximum((n * qh).sum(-1).abs(),
                            torch.exp(-m_new))[..., None]
        h = (num / den).reshape(B, 1, H, hd)
        out = (h * o_t.float()).reshape(B, 1, H * hd).to(x.dtype)
        return out @ p["out_proj"], {"C": C, "n": n, "m": m_new}

    # the parallel (quadratic) stabilized form, chunked over queries.  The
    # running sum of the log forget gates is taken in float64 and rounded
    # once: the card and the CPU then agree on it whatever order each
    # one's scan adds in
    cum = torch.cumsum(logf.double(), dim=1).float()     # (B, S, H)
    qf = q.float().transpose(1, 2)                       # (B, H, S, hd)
    kf = k.float()
    vf = v.float()
    kh, vh = kf.transpose(1, 2), vf.transpose(1, 2)      # (B, H, S, hd)
    cum_keys = cum.transpose(1, 2)[:, :, None, :]        # (B, H, 1, S)
    i_keys = i_t.transpose(1, 2)[:, :, None, :]
    cum_q = cum.transpose(1, 2)                          # (B, H, S)
    t_idx = torch.arange(S, device=x.device)
    outs = []                            # the chunks' outputs, in order
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)          # the last chunk's padded queries
        # D~[t, s] = cum_f[t] - cum_f[s] + i~[s]   for s <= t
        dmat = cum_q[:, :, c0:c1, None] - cum_keys + i_keys
        mask = t_idx[None, :] <= t_idx[c0:c1, None]      # (chunk, S)
        dmat = torch.where(mask, dmat, NEG_INF)
        mrow = torch.clamp_min(dmat.amax(-1), 0.0)      # stabilizer
        w = torch.exp(dmat - mrow[..., None])
        s = (qf[:, :, c0:c1] @ kh.transpose(-1, -2)) * w
        den = torch.maximum(s.sum(-1).abs(), torch.exp(-mrow))[..., None]
        outs.append((s @ vh) / den)
    out = torch.cat(outs, dim=2)                         # (B, H, S, hd)
    out = (out.transpose(1, 2) * o_t.float()).reshape(B, S, H * hd)
    new_state = None
    if mode == "prefill":                                # the final state
        new_state = _mlstm_state_from_seq(kf, vf, i_t, logf, cum, B, H, hd)
    return out.to(x.dtype) @ p["out_proj"], new_state


def _mlstm_state_from_seq(kf, vf, i_t, logf, cum, B, H, hd):
    """Final (C, n, m) after consuming the whole sequence: O(S) products.
    kf, vf (B, S, H, hd); i_t, logf, cum (B, S, H)."""
    tot = cum[:, -1]                                     # (B, H)
    w_log = tot[:, None, :] - cum + i_t                  # (B, S, H)
    m = torch.clamp_min(w_log.amax(1), 0.0)              # (B, H)
    w = torch.exp(w_log - m[:, None, :])                 # (B, S, H)
    wv = (w[..., None] * vf).permute(0, 2, 3, 1)         # (B, H, hd, S)
    C = wv @ kf.transpose(1, 2)                          # (B, H, hd, hd)
    n = (w[..., None] * kf).sum(1)                       # (B, H, hd)
    return {"C": C, "n": n, "m": m}


# --------------------------------------------------------------------------
# sLSTM -- scalar memory, true recurrence
# --------------------------------------------------------------------------

def slstm_init_state(cfg, B, dtype, device):
    D = cfg.d_model
    return {k: torch.zeros((B, D), dtype=torch.float32, device=device)
            for k in ("h", "c", "n", "m")}


def _slstm_step(carry, xw_t, R, B, H, dh):
    """One recurrence step; carry (h, c, n, m), each (B, D) float32."""
    h, c, n, m = carry
    # block-diagonal recurrent product: head j of h times R[j]
    rec = torch.bmm(h.view(B, H, dh).transpose(0, 1), R)   # (H, B, 4 dh)
    g = xw_t + rec.transpose(0, 1).reshape(B, 4 * H * dh)
    zt, it, ft, ot = g.chunk(4, dim=-1)
    zt = torch.tanh(zt)
    fm = ft + m
    m_new = torch.maximum(fm, it)                        # exp gating
    ip = torch.exp(it - m_new)
    fp = torch.exp(fm - m_new)
    c = fp * c + ip * zt
    n = fp * n + ip
    h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1.0)
    return h, c, n, m_new


def slstm_mixer(p, x, cfg, mode="train", state=None):
    """Block-diagonal recurrent sLSTM.  x (B, S, D) -> (out, new_state).
    The input product runs once for all positions; train and prefill then
    run the step over them in order, decode runs one step."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    xw = (x @ p["W"]).float() + p["b"].float()           # (B, S, 4D)
    R = p["R"].float()                                   # (H, dh, 4 dh)
    if mode == "decode":
        carry = (state["h"], state["c"], state["n"], state["m"])
    else:
        carry = tuple(x.new_zeros((B, D), dtype=torch.float32)
                      for _ in range(4))
    hs = []
    for t in range(S):
        carry = _slstm_step(carry, xw[:, t], R, B, H, dh)
        hs.append(carry[0])
    hs = torch.stack(hs, dim=1)                          # (B, S, D)
    new_state = dict(zip(("h", "c", "n", "m"), carry)) \
        if mode != "train" else None
    return hs.to(x.dtype) @ p["out_proj"], new_state
