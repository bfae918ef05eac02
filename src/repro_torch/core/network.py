"""Flow/packet communication model and switch state dynamics (paper
§III-B), port of ``repro.core.network``.

Flow model: a flow's instantaneous rate is the min over its route links of
``cap(l) / n_active_flows(l)`` (equal-share fluid approximation).  Rates
are recomputed at every full step, so completions are exact under
piecewise-constant sharing.

Packet model (``cfg.comm_model == 1``): adds store-and-forward
serialization, a fixed extra latency of ``hops * hop_latency + (hops-1) *
mtu/cap`` consumed before bytes drain.

Switch dynamics: ports enter LPI when their link has no flows (802.3az);
line cards sleep when all their ports are idle; a switch that carries
traffic is awake.  Waking an LPI port or a sleeping switch adds its wake
latency to the flow's ``extra`` budget.

Every function is dense tensor work with no host read, so the engine's
macro-step stays free of synchronisations.  The flow table and the switch
state may carry a leading replica batch shape; the topology's arrays
(``TopoConsts``) are shared by every replica.  ``spawn_flow`` is the seed
scalar path's spawn (``SimConfig(use_vectorized_hot_loop=False)``): one
flow a replica, under a mask in place of the reference's ``lax.cond``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.ref import _const, _fma, _fms
from .types import (INF, FlowTable, LinecardState, NetState, PortState,
                    SimConfig, lift, replace, set_drop, take)

__all__ = ["TopoConsts", "topo_consts", "route_wake_cost", "flow_routes",
           "spawn_flow", "spawn_flows_many", "recompute_rates",
           "advance_flows", "complete_flows", "update_switch_states"]

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64


@dataclasses.dataclass
class TopoConsts:
    """A topology's dense arrays on the device, built once per run by
    :func:`topo_consts`."""

    routes: torch.Tensor        # (N, N, H) int32 link ids (-1 padded)
    route_len: torch.Tensor     # (N, N) int32
    route_sw: torch.Tensor      # (N, N, H) int32 switch ids (-1 padded)
    link_cap: torch.Tensor      # (L,) f32 bytes/s
    link_sw: torch.Tensor       # (L, 2) int32 endpoint switch (-1 server)
    link_port: torch.Tensor     # (L, 2) int32 endpoint port (-1 server)
    port_of_side: torch.Tensor  # (2L,) int64 flat (switch, port) of each
                                # link end, side 0 then side 1 (0 for a
                                # server end, whose value is masked)
    side_is_sw: torch.Tensor    # (2L,) bool: that end is a switch
    lc_of_port: torch.Tensor    # (P,) int64 line card of each port
    n_links: int


def topo_consts(topo, device) -> TopoConsts:
    """The device arrays of a ``core.topology.Topology``."""
    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dtype)

    ls = np.where(topo.links >= topo.n_servers, topo.links - topo.n_servers,
                  -1)
    W = max(topo.n_switches, 1)
    P = max(topo.n_ports, 1)
    LC = max(topo.n_linecards, 1)
    sides = np.concatenate([ls[:, 0], ls[:, 1]])
    ports = np.concatenate([topo.link_port[:, 0], topo.link_port[:, 1]])
    flat = np.clip(sides, 0, None) * P + np.clip(ports, 0, None)
    assert flat.max(initial=0) < W * P
    return TopoConsts(
        routes=dev(topo.routes, I32),
        route_len=dev(topo.route_len, I32),
        route_sw=dev(topo.route_sw, I32),
        link_cap=dev(topo.link_cap, F32),
        link_sw=dev(ls, I32),
        link_port=dev(topo.link_port, I32),
        port_of_side=dev(flat, I64),
        side_is_sw=dev(sides >= 0, torch.bool),
        lc_of_port=dev(np.clip(np.arange(P) // topo.ports_per_linecard, 0,
                               LC - 1), I64),
        n_links=topo.n_links)


def route_wake_cost(tc: TopoConsts, net: NetState, src, dst):
    """Case study D's metric: the number of sleeping switches on the route
    src -> dst (int32; ``src``/``dst`` broadcast, so one source against
    every destination gives the NETWORK_AWARE score's network term; with
    a replica batch, (*B, ...) by the switch state's batch shape)."""
    sws = tc.route_sw[src, dst]                           # (..., H)
    sws = sws.expand(net.sw_awake.shape[:-1] + sws.shape)
    asleep = ~take(net.sw_awake, sws.clamp(min=0))
    return ((sws >= 0) & asleep).sum(dim=-1, dtype=I32)


@dataclasses.dataclass
class FlowRoutes:
    """What a spawn reads of its route, for edges of any shape (*S,):
    the switches at the ends of its links (``ends`` (*S, 2H), -1 for a
    server end or a padding link), its switches as a mask (``sw_hit``
    (*S, W)), and its ``extra`` latency budget with no switch to wake
    (``extra0``) and with one (``extra1``), float32.  Spawns change only
    ``sw_awake``, so a loop of spawns reads the routes (and the ports'
    LPI states) once, before its first spawn."""

    ends: torch.Tensor
    sw_hit: torch.Tensor
    extra0: torch.Tensor
    extra1: torch.Tensor

    def at(self, i: int, nb: int) -> "FlowRoutes":
        """Edge ``i`` of routes whose edge axis is axis ``nb`` (a view)."""
        return FlowRoutes(*(getattr(self, f.name).select(nb, i)
                            for f in dataclasses.fields(self)))


def flow_routes(tc: TopoConsts, net: NetState, cfg: SimConfig, src, dst):
    """The routes src -> dst (int32 of one shape (*S,), with the switch
    state's batch shape leading) as ``spawn_flow`` reads them."""
    W = net.sw_awake.shape[-1]
    P = net.port_state.shape[-1]
    swp = cfg.switch_power
    srcc = src.clamp(min=0).to(I64)
    dstc = dst.clamp(min=0).to(I64)
    links = tc.routes[srcc, dstc]                             # (*S, H)
    lmask = links >= 0
    lc = links.clamp(min=0).to(I64)
    sw_a, sw_b = tc.link_sw[lc, 0], tc.link_sw[lc, 1]
    pt_a = tc.link_port[lc, 0].clamp(min=0).to(I64)
    port_lpi = (take(net.port_state.flatten(-2),
                     sw_a.clamp(min=0).to(I64) * P + pt_a)
                == PortState.LPI) & (sw_a >= 0)
    n_lpi = (lmask & port_lpi).sum(dim=-1, dtype=I32)
    ends = torch.cat([torch.where(lmask & (sw_a >= 0), sw_a, -1),
                      torch.where(lmask & (sw_b >= 0), sw_b, -1)], dim=-1)
    sws = tc.route_sw[srcc, dstc]                             # (*S, H)
    sw_hit = set_drop(torch.zeros(sws.shape[:-1] + (W,), dtype=torch.bool,
                                  device=sws.device),
                      torch.where(sws >= 0, sws, W), True)
    hops = tc.route_len[srcc, dstc].to(F32)
    # the multiply-adds round once, as in spawn_flows_many
    extras = []
    for woke in (0.0, 1.0):
        extra = _fma(n_lpi, _const(swp.t_lpi_wake, hops),
                     torch.full_like(hops, woke)
                     * _const(swp.t_switch_wake, hops), F32)
        if cfg.comm_model == 1:  # packet store-and-forward serialization
            cap0 = tc.link_cap[links[..., 0].clamp(min=0).to(I64)]
            extra = _fma(hops, _const(cfg.hop_latency, hops), extra, F32) \
                + torch.clamp(hops - 1.0, min=0.0) \
                * _const(cfg.flow_mtu, hops) / cap0
        extras.append(extra)
    return FlowRoutes(ends=ends.to(I64), sw_hit=sw_hit, extra0=extras[0],
                      extra1=extras[1])


def spawn_flow(flows: FlowTable, net: NetState, tc: TopoConsts,
               cfg: SimConfig, src, dst, nbytes, child, now, mask=None,
               route: FlowRoutes | None = None):
    """Allocate the first free slot (lowest index) for one flow src -> dst
    a replica: ``src``/``dst``/``child`` (*B,) int32, ``nbytes`` (*B,),
    ``mask`` (*B,) bool or None (all true).  Its ``extra`` budget pays each
    LPI port on the route and, once, a sleeping switch; every switch on
    the route wakes, also when the table is full, which counts in
    ``flows_dropped``.  ``route`` is ``flow_routes`` of this edge, read
    before a loop of spawns.  Returns (flows, net, ok): ``ok`` is "a slot
    was free" (and ``mask``)."""
    if route is None:
        route = flow_routes(tc, net, cfg, src, dst)
    F = flows.active.shape[-1]
    if mask is None:
        mask = torch.ones(src.shape, dtype=torch.bool, device=src.device)
    free = ~flows.active
    ok = free.any(dim=-1) & mask
    slot = torch.argmax(free.to(I32), dim=-1)                 # first free
    asleep = (route.ends >= 0) \
        & ~take(net.sw_awake, route.ends.clamp(min=0))
    extra = torch.where(asleep.any(dim=-1), route.extra1, route.extra0)
    hit = (torch.arange(F, device=slot.device) == lift(slot)) & lift(ok)

    def put(arr, val):
        return torch.where(hit, lift(val) if torch.is_tensor(val) else val,
                           arr)

    flows = replace(
        flows,
        src=put(flows.src, src.to(I32)),
        dst=put(flows.dst, dst.to(I32)),
        rem=put(flows.rem, nbytes.to(F32)),
        rate=put(flows.rate, 0.0),
        extra=put(flows.extra, extra.to(flows.extra.dtype)),
        done_at=put(flows.done_at, INF),
        child=put(flows.child, child.to(I32)),
        active=flows.active | hit,
        flows_dropped=flows.flows_dropped + (mask & ~ok).to(I32))
    return flows, replace(net, sw_awake=net.sw_awake
                          | (route.sw_hit & lift(mask))), ok


def spawn_flows_many(flows: FlowTable, net: NetState, tc: TopoConsts,
                     cfg: SimConfig, need, src, dst, nbytes, child, now):
    """Spawn a flow for every edge with ``need[e]`` in one batched update.

    Slot allocation is a prefix sum over free flow slots: the edge of rank
    k among the needed ones takes the k-th free slot, and edges past the
    free count fail, as sequential first-free allocation would.  A sleeping
    switch's wake latency is paid only by the first needed edge (in rank
    order) whose route touches it; later edges of the batch see it awake.

    need/src/dst/nbytes/child (*B, E).  Returns (flows, net, ok (*B, E)
    bool).
    """
    E = need.shape[-1]
    B = need.shape[:-1]
    F = flows.active.shape[-1]
    W = net.sw_awake.shape[-1]
    P = net.port_state.shape[-1]
    swp = cfg.switch_power
    dev = need.device
    order = torch.cumsum(need, -1, dtype=I32) - 1     # rank among needed
    srcc = src.clamp(min=0).to(I64)
    dstc = dst.clamp(min=0).to(I64)

    # the first needed edge (in rank order) whose route touches each switch
    sws = tc.route_sw[srcc, dstc]                             # (*B, E, H)
    touch = (sws >= 0) & need[..., None]
    rank_e = torch.where(need, order, E)
    first = torch.full(B + (W + 1,), E, dtype=I32, device=dev).scatter_reduce(
        -1, torch.where(touch, sws, W).reshape(B + (-1,)).to(I64),
        rank_e[..., None].expand(sws.shape).reshape(B + (-1,)), "amin",
        include_self=True)[..., :W]

    links = tc.routes[srcc, dstc]                             # (*B, E, H)
    lmask = links >= 0
    lc = links.clamp(min=0).to(I64)
    sw_a, sw_b = tc.link_sw[lc, 0], tc.link_sw[lc, 1]         # (*B, E, H)
    pt_a = tc.link_port[lc, 0].clamp(min=0).to(I64)
    port_lpi = (take(net.port_state.flatten(-2),
                     sw_a.clamp(min=0).to(I64) * P + pt_a)
                == PortState.LPI) & (sw_a >= 0)
    sleeping0 = ~net.sw_awake

    def asleep_at_turn(sw):
        # sleeping when this edge spawns = initially sleeping and not yet
        # woken by an earlier edge of the batch
        swc = sw.clamp(min=0).to(I64)
        return (sw >= 0) & take(sleeping0, swc) \
            & (take(first, swc) >= order[..., None])

    asleep = asleep_at_turn(sw_a) | asleep_at_turn(sw_b)
    n_sleep_sw = (lmask & asleep).sum(dim=-1, dtype=I32)
    n_lpi = (lmask & port_lpi).sum(dim=-1, dtype=I32)
    hops = tc.route_len[srcc, dstc].to(F32)
    # the multiply-adds round once, as in the reference's compiled step
    extra = _fma(n_lpi, _const(swp.t_lpi_wake, hops),
                 torch.clamp(n_sleep_sw, max=1).to(F32)
                 * _const(swp.t_switch_wake, hops), F32)
    if cfg.comm_model == 1:  # packet store-and-forward serialization
        cap0 = tc.link_cap[links[..., 0].clamp(min=0).to(I64)]
        extra = _fma(hops, _const(cfg.hop_latency, hops), extra, F32) \
            + torch.clamp(hops - 1.0, min=0.0) \
            * _const(cfg.flow_mtu, hops) / cap0

    # prefix-sum slot allocator over the free flow slots
    free = ~flows.active
    free_rank = torch.cumsum(free, -1, dtype=I32) - 1
    slot_by_rank = set_drop(
        torch.full(B + (F,), F, dtype=I32, device=dev),
        torch.where(free, free_rank, F), torch.arange(F, dtype=I32,
                                                      device=dev))
    ok = need & (order < free.sum(dim=-1, dtype=I32)[..., None])
    slot = torch.where(ok, take(slot_by_rank, order.clamp(0, F - 1)), F)

    def put(arr, vals):
        # arr.at[slot].set(vals, mode="drop"): slot F is the sentinel
        return set_drop(arr, slot, vals)

    flows = replace(
        flows,
        src=put(flows.src, src),
        dst=put(flows.dst, dst),
        rem=put(flows.rem, nbytes.to(F32)),
        rate=put(flows.rate, 0.0),
        extra=put(flows.extra, extra),
        done_at=put(flows.done_at, INF),
        child=put(flows.child, child),
        active=put(flows.active, True),
        flows_dropped=flows.flows_dropped + (need & ~ok).sum(dim=-1,
                                                              dtype=I32),
    )
    # wake every switch on every needed route (slot-exhausted spawns too,
    # as the sequential path wakes before it checks for a slot)
    sw_awake = set_drop(net.sw_awake,
                        torch.where(touch, sws, W).reshape(B + (-1,)), True)
    return flows, replace(net, sw_awake=sw_awake), ok


def recompute_rates(flows: FlowTable, tc: TopoConsts, now):
    """Equal-share fluid rates and projected completion times,
    ``done_at = now + extra + rem/rate``.  Returns (flows, link_flows)."""
    links = tc.routes[flows.src.clamp(min=0).to(I64),
                      flows.dst.clamp(min=0).to(I64)]           # (*B, F, H)
    B = links.shape[:-2]
    lmask = (links >= 0) & flows.active[..., None]
    lidx = links.clamp(min=0).to(I64)
    link_flows = torch.zeros(B + (tc.n_links,), dtype=I32,
                             device=links.device).scatter_add(
        -1, lidx.reshape(B + (-1,)), lmask.reshape(B + (-1,)).to(I32))
    share = tc.link_cap[lidx] / torch.clamp(take(link_flows, lidx), min=1)
    share = torch.where(lmask, share, torch.inf)
    rate = torch.where(flows.active, share.amin(dim=-1), 0.0)
    rate = torch.where(torch.isfinite(rate), rate, 0.0).to(F32)
    q = flows.rem / torch.clamp(rate, min=1e-30)
    done = torch.where(flows.active & (rate > 0),
                       lift(now) + flows.extra + q.to(flows.extra.dtype),
                       INF)
    return replace(flows, rate=rate,
                   done_at=done.to(flows.done_at.dtype)), link_flows


def advance_flows(flows: FlowTable, dt):
    """Drain ``dt`` seconds: the fixed latency budget is consumed first,
    then bytes at the current rate."""
    dt = lift(dt)
    lat_used = torch.minimum(flows.extra, dt)
    drain_t = dt - lat_used
    rem = torch.where(
        flows.active,
        torch.clamp(_fms(flows.rem, flows.rate, drain_t, F32), min=0.0),
        flows.rem)
    extra = torch.where(flows.active, flows.extra - lat_used, flows.extra)
    return replace(flows, rem=rem, extra=extra)


def complete_flows(flows: FlowTable, now, eps: float = 1e-9):
    """Deactivate flows whose done_at <= now (+ eps in the clock's dtype);
    returns (flows, done mask)."""
    fin = flows.active & (flows.done_at <= lift(now + _const(eps, now)))
    flows = replace(
        flows,
        active=flows.active & ~fin,
        done_at=torch.where(fin, INF, flows.done_at),
        rem=torch.where(fin, 0.0, flows.rem),
        rate=torch.where(fin, 0.0, flows.rate),
        extra=torch.where(fin, 0.0, flows.extra),
    )
    return flows, fin


def update_switch_states(net: NetState, link_flows, tc: TopoConsts,
                         cfg: SimConfig, now):
    """Port LPI entry/exit from link activity; line cards sleep when none
    of their ports is active; a switch carrying traffic is awake."""
    swp = cfg.switch_power
    W, P = net.port_state.shape[-2:]
    B = net.port_state.shape[:-2]
    # busy.at[sw, pt].max(...) over both ends of every link, repeated
    # (switch, port) pairs included: a count of busy link ends, then > 0
    lb = link_flows > 0
    lbusy = torch.cat([lb, lb], dim=-1) & tc.side_is_sw
    busy = torch.zeros(B + (W * P,), dtype=I32, device=lbusy.device)\
        .index_add(-1, tc.port_of_side, lbusy.to(I32))\
        .unflatten(-1, (W, P)) > 0
    was_active = net.port_state == PortState.ACTIVE
    now = lift(now, 2)
    idle_since = torch.where(was_active & ~busy, now, net.port_idle_since)
    lpi_ready = ~busy & (now - idle_since
                         >= _const(swp.t_port_lpi_enter, idle_since))
    port_state = torch.where(
        busy, PortState.ACTIVE,
        torch.where(lpi_ready, PortState.LPI, net.port_state)).to(I32)

    # line cards sleep when no port on them is active
    LC = net.lc_state.shape[-1]
    port_act = (port_state == PortState.ACTIVE).to(I32)
    lc_busy = torch.zeros(B + (W, LC), dtype=I32,
                          device=busy.device).index_add(
        -1, tc.lc_of_port, port_act)
    lc_state = torch.where(lc_busy > 0, LinecardState.ACTIVE,
                           LinecardState.SLEEP).to(I32)

    sw_awake = busy.any(dim=-1) | net.sw_awake
    return replace(net, port_state=port_state, port_idle_since=idle_since,
                   lc_state=lc_state, sw_awake=sw_awake,
                   link_flows=link_flows)
