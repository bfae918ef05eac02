"""The Mamba-style selective SSM mixer of hymba in PyTorch (port of the
Mamba part of ``repro.models.ssm``).

Prefill and train run the recurrence through ``kernels.ops.ssm_scan``
(the CUDA kernel on the card, its plain version on the CPU), which takes
the place of the reference's ``lax.scan``; the single decode step is
tensor code.  The xLSTM mixers (``mlstm``, ``slstm``) are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops


def ssm_init_state(cfg, B, dtype, device):
    Dss, N, K = cfg.d_ssm, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((B, K - 1, Dss), dtype=dtype, device=device),
            "h": torch.zeros((B, Dss, N), dtype=torch.float32,
                             device=device)}


def _softplus(x):
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


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
