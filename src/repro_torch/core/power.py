"""ACPI-hierarchy power accounting (paper §III-F), port of
``repro.core.power``: servers, and switches in network mode.

Energy is accrued exactly between events: state is piecewise constant in a
DES, so ``E += P(state) * dt`` integrates the power curve with no
discretization error.  Switch power follows chassis + line card + port
(LPI-capable) structure calibrated to the paper's Cisco WS-C2960 profile.
States may carry a leading replica batch shape; sums run along the
trailing axes.
"""
from __future__ import annotations

import torch

from ..kernels.ref import _const
from .types import (INF, LinecardState, NetState, PortState, ServerFarm,
                    SimConfig, SrvState, lift, replace)

__all__ = ["server_power", "accrue_server_energy", "state_onehot",
           "switch_power", "total_power", "accrue_switch_energy"]


def server_power(farm: ServerFarm, cfg: SimConfig, throttled=None):
    """Instantaneous per-server power draw (*B, N) f32 and busy-core count
    (*B, N) f32.  ``throttled`` (*B, N) bool scales active-core power by
    ``cfg.thermal.throttle_power_scale``."""
    sp = cfg.server_power
    f32 = torch.float32
    busy = (farm.core_busy_until < INF).sum(dim=-1, dtype=torch.int32).to(f32)
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
    """(*B, N, SrvState.NUM) f32 one-hot of each server's state."""
    states = torch.arange(SrvState.NUM, device=farm.srv_state.device)
    return (farm.srv_state[..., None] == states).to(torch.float32)


def accrue_server_energy(farm: ServerFarm, cfg: SimConfig, dt,
                         p_busy=None, onehot=None) -> ServerFarm:
    """Exact interval accrual of energy, residency and busy core-seconds.
    ``p_busy`` optionally supplies a precomputed (power, busy) pair and
    ``onehot`` a precomputed state one-hot."""
    p, busy = server_power(farm, cfg) if p_busy is None else p_busy
    dtf = lift(dt.to(torch.float32))
    if onehot is None:
        onehot = state_onehot(farm)
    return replace(farm, energy=farm.energy + p * dtf,
                   residency=farm.residency + onehot * lift(dtf),
                   busy_core_seconds=farm.busy_core_seconds + busy * dtf)


def switch_power(net: NetState, cfg: SimConfig) -> torch.Tensor:
    """Instantaneous per-switch power (*B, W) f32: chassis (a dozing switch
    draws 10%), ports by state (any other state draws 0) and line cards."""
    swp = cfg.switch_power
    f32 = torch.float32
    dev = net.sw_awake.device
    chassis = torch.where(
        net.sw_awake, torch.full((), swp.p_chassis, dtype=f32, device=dev),
        torch.full((), 0.1 * swp.p_chassis, dtype=f32, device=dev))
    ps = net.port_state
    port_p = torch.where(ps == PortState.OFF, swp.p_port_off,
                         torch.zeros(ps.shape, dtype=f32, device=dev))
    port_p = torch.where(ps == PortState.LPI, swp.p_port_lpi, port_p)
    port_p = torch.where(ps == PortState.ACTIVE, swp.p_port_active, port_p)
    lc_p = torch.where(
        net.lc_state == LinecardState.ACTIVE,
        torch.full((), swp.p_linecard_active, dtype=f32, device=dev),
        torch.full((), swp.p_linecard_sleep, dtype=f32, device=dev))
    return chassis + port_p.sum(dim=-1) + lc_p.sum(dim=-1)


def total_power(farm: ServerFarm, net: NetState, cfg: SimConfig,
                throttled=None):
    """Instantaneous fleet-wide (server total, switch total) watts, both
    batch-shaped f32."""
    p_srv = server_power(farm, cfg, throttled)[0].sum(dim=-1)
    if cfg.has_network:
        p_sw = switch_power(net, cfg).sum(dim=-1)
    else:
        p_sw = torch.zeros_like(p_srv)
    return p_srv, p_sw


def accrue_switch_energy(net: NetState, dt, p) -> NetState:
    """Exact interval accrual of switch energy and port-state residency;
    ``p`` is ``switch_power(net, cfg)``, which the caller has at hand."""
    dtf = lift(dt.to(torch.float32))
    states = torch.arange(PortState.NUM, device=net.port_state.device)
    onehot = (net.port_state[..., None] == states).to(torch.float32)
    return replace(net, sw_energy=net.sw_energy + p * dtf,
                   port_residency=net.port_residency + onehot * lift(dtf, 2))
