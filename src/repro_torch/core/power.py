"""ACPI-hierarchy server power accounting (paper §III-F), port of
``repro.core.power`` (server part; switches arrive with the network slice).

Energy is accrued exactly between events: state is piecewise constant in a
DES, so ``E += P(state) * dt`` integrates the power curve with no
discretization error.
"""
from __future__ import annotations

import torch

from ..kernels.ref import _const
from .types import INF, ServerFarm, SimConfig, SrvState, replace

__all__ = ["server_power", "accrue_server_energy", "state_onehot"]


def server_power(farm: ServerFarm, cfg: SimConfig, throttled=None):
    """Instantaneous per-server power draw (N,) f32 and busy-core count
    (N,) f32.  ``throttled`` (N,) bool scales active-core power by
    ``cfg.thermal.throttle_power_scale``."""
    sp = cfg.server_power
    f32 = torch.float32
    busy = (farm.core_busy_until < INF).sum(dim=1, dtype=torch.int32).to(f32)
    p_act = _const(sp.p_core_active, busy)
    if throttled is not None:
        p_act = torch.where(
            throttled,
            _const(sp.p_core_active * cfg.thermal.throttle_power_scale, busy),
            p_act)
    p_on = _const(sp.p_base, busy) + busy * p_act \
        + (_const(float(cfg.n_cores), busy) - busy) * _const(sp.p_core_idle,
                                                              busy)
    st = farm.srv_state
    # ACTIVE/IDLE share the S0 formula; OFF and unknown states draw 0
    p = torch.where(st == SrvState.WAKING, sp.p_wake, torch.zeros_like(busy))
    p = torch.where(st == SrvState.S3, sp.p_s3, p)
    p = torch.where(st == SrvState.PKG_C6, sp.p_pkg_c6, p)
    p = torch.where((st == SrvState.ACTIVE) | (st == SrvState.IDLE), p_on, p)
    return p, busy


def state_onehot(farm: ServerFarm) -> torch.Tensor:
    """(N, SrvState.NUM) f32 one-hot of each server's state."""
    states = torch.arange(SrvState.NUM, device=farm.srv_state.device)
    return (farm.srv_state[:, None] == states[None, :]).to(torch.float32)


def accrue_server_energy(farm: ServerFarm, cfg: SimConfig, dt,
                         p_busy=None, onehot=None) -> ServerFarm:
    """Exact interval accrual of energy, residency and busy core-seconds.
    ``p_busy`` optionally supplies a precomputed (power, busy) pair and
    ``onehot`` a precomputed state one-hot."""
    p, busy = server_power(farm, cfg) if p_busy is None else p_busy
    dtf = dt.to(torch.float32)
    if onehot is None:
        onehot = state_onehot(farm)
    return replace(farm, energy=farm.energy + p * dtf,
                   residency=farm.residency + onehot * dtf,
                   busy_core_seconds=farm.busy_core_seconds + busy * dtf)
