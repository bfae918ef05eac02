"""Data center network topologies (paper §III-B): a copy of
``repro.core.topology``, kept numpy-only so the port never imports the JAX
package (tests pin every topology's arrays equal to the original's).

Supported, mirroring the paper's list:
  * fat-tree (switch-only)            — Al-Fares et al. [8]
  * flattened butterfly (switch-only) — Kim et al. [34] (k-ary 2-flat)
  * BCube (hybrid, servers forward)   — Guo et al. [26] (level-1)
  * CamCube (server-only 3D torus)    — Abu-Libdeh et al. [6]
  * star (single switch)              — used for the paper's §V-B validation

Topology construction and all-pairs routing run on the host in numpy once
at configuration time; the engine (``core/network.py``) consumes only dense
arrays, copied to the device once:

  links      (L, 2)  node endpoints (servers are 0..N-1, switches N..N+W-1)
  link_cap   (L,)    bytes/s
  routes     (N, N, H) link-id paths between server pairs (-1 padded)
  route_len  (N, N)
  link_port  (L, 2)  port index within the endpoint switch (-1 for servers)
  route_sw   (N, N, H) switch ids along the path (-1 padded), for case D
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

__all__ = ["Topology", "fat_tree", "flattened_butterfly", "bcube", "camcube",
           "star", "rack_of_servers"]


@dataclasses.dataclass
class Topology:
    name: str
    n_servers: int
    n_switches: int
    n_ports: int                 # max ports per switch
    ports_per_linecard: int
    links: np.ndarray            # (L, 2) int32
    link_cap: np.ndarray         # (L,) float32
    link_port: np.ndarray        # (L, 2) int32
    routes: np.ndarray           # (N, N, H) int32 link ids
    route_len: np.ndarray        # (N, N) int32
    route_sw: np.ndarray         # (N, N, Hs) int32 switch ids on path

    @property
    def n_links(self) -> int:
        return len(self.links)

    @property
    def max_hops(self) -> int:
        return self.routes.shape[2]

    def linecard_of_port(self, p):
        return p // self.ports_per_linecard

    @property
    def n_linecards(self) -> int:
        return -(-self.n_ports // self.ports_per_linecard)


def _build(name, n_servers, n_switches, edges, link_cap, ports_per_lc=8):
    """edges: list of (node_a, node_b). Computes ports, BFS all-pairs routes."""
    links = np.asarray(edges, np.int32).reshape(-1, 2)
    L = len(links)
    n_nodes = n_servers + n_switches

    # assign switch-local port indices in link order
    port_ctr = np.zeros(n_nodes, np.int32)
    link_port = np.full((L, 2), -1, np.int32)
    for li, (a, b) in enumerate(links):
        for side, node in enumerate((a, b)):
            if node >= n_servers:                      # switch side
                link_port[li, side] = port_ctr[node]
            port_ctr[node] += 1
    n_ports = int(port_ctr[n_servers:].max()) if n_switches else 1

    # adjacency: node -> [(neighbor, link_id)]
    adj = [[] for _ in range(n_nodes)]
    for li, (a, b) in enumerate(links):
        adj[a].append((b, li))
        adj[b].append((a, li))

    # BFS from every server -> parent pointers -> link paths to other servers
    H = 0
    paths = {}
    for s in range(n_servers):
        par = np.full(n_nodes, -1, np.int64)
        plink = np.full(n_nodes, -1, np.int64)
        par[s] = s
        dq = deque([s])
        while dq:
            u = dq.popleft()
            for (v, li) in adj[u]:
                if par[v] < 0:
                    par[v] = u
                    plink[v] = li
                    dq.append(v)
        for d in range(n_servers):
            if d == s or par[d] < 0:
                continue
            p, sw = [], []
            u = d
            while u != s:
                p.append(int(plink[u]))
                if u >= n_servers:
                    sw.append(int(u - n_servers))
                u = int(par[u])
            p.reverse()
            sw.reverse()
            paths[(s, d)] = (p, sw)
            H = max(H, len(p))

    H = max(H, 1)
    Hs = max(H, 1)
    routes = np.full((n_servers, n_servers, H), -1, np.int32)
    route_len = np.zeros((n_servers, n_servers), np.int32)
    route_sw = np.full((n_servers, n_servers, Hs), -1, np.int32)
    for (s, d), (p, sw) in paths.items():
        routes[s, d, :len(p)] = p
        route_len[s, d] = len(p)
        route_sw[s, d, :len(sw)] = sw

    return Topology(
        name=name, n_servers=n_servers, n_switches=n_switches,
        n_ports=n_ports, ports_per_linecard=ports_per_lc,
        links=links, link_cap=np.full((L,), link_cap, np.float32),
        link_port=link_port, routes=routes, route_len=route_len,
        route_sw=route_sw)


def rack_of_servers(topo: Topology, rack_size: int = 8) -> np.ndarray:
    """(N,) rack grouping for the thermal recirculation model (the
    reference's core/thermal.py): servers sharing a first-hop switch share
    a rack — the natural top-of-rack reading of every switch-based topology
    here (fat-tree edge switches, butterfly routers, BCube level-0, the
    star's single rack).  Switchless topologies (CamCube) fall back to
    ``i // rack_size`` chunks.

    Ids are raw first-switch indices; ``thermal.init_thermal`` densifies
    them, so gaps are fine.
    """
    n = topo.n_servers
    if topo.n_switches == 0:
        return np.arange(n) // max(rack_size, 1)
    first_sw = np.full(n, -1, np.int64)
    for a, b in topo.links:
        a, b = int(a), int(b)
        if a < n <= b and first_sw[a] < 0:
            first_sw[a] = b - n
        elif b < n <= a and first_sw[b] < 0:
            first_sw[b] = a - n
    # isolated servers (none in the topologies above) get their own rack
    lone = first_sw < 0
    first_sw[lone] = topo.n_switches + np.arange(n)[lone]
    return first_sw


def star(n_servers: int, link_cap: float = 125e6, ports_per_lc: int = 24):
    """All servers on one switch — the paper's §V-B validation setup
    (24 servers, one Cisco WS-C2960-24-S)."""
    sw = n_servers
    edges = [(s, sw) for s in range(n_servers)]
    return _build("star", n_servers, 1, edges, link_cap, ports_per_lc)


def fat_tree(k: int, link_cap: float = 125e6, ports_per_lc: int = 8):
    """Standard k-ary fat-tree: k pods, (k/2)^2 servers/pod, full bisection.
    Servers: k^3/4.  Switches: edge k^2/2 + agg k^2/2 + core (k/2)^2."""
    assert k % 2 == 0
    half = k // 2
    n_servers = k * half * half
    n_edge = k * half
    n_agg = k * half
    n_core = half * half
    base = n_servers
    def edge_id(pod, e):
        return base + pod * half + e

    def agg_id(pod, a):
        return base + n_edge + pod * half + a

    def core_id(i, j):
        return base + n_edge + n_agg + i * half + j

    edges = []
    for pod in range(k):
        for e in range(half):
            for h in range(half):
                srv = pod * half * half + e * half + h
                edges.append((srv, edge_id(pod, e)))
            for a in range(half):
                edges.append((edge_id(pod, e), agg_id(pod, a)))
        for a in range(half):
            for j in range(half):
                edges.append((agg_id(pod, a), core_id(a, j)))
    return _build(f"fat_tree_k{k}", n_servers, n_edge + n_agg + n_core,
                  edges, link_cap, ports_per_lc)


def flattened_butterfly(k: int, link_cap: float = 125e6,
                        ports_per_lc: int = 8):
    """k-ary 2-flat: k routers, each attached to k servers, routers fully
    connected (one inter-router hop max)."""
    n_servers = k * k
    base = n_servers
    edges = []
    for r in range(k):
        for h in range(k):
            edges.append((r * k + h, base + r))
    for r in range(k):
        for r2 in range(r + 1, k):
            edges.append((base + r, base + r2))
    return _build(f"flat_bfly_k{k}", n_servers, k, edges, link_cap,
                  ports_per_lc)


def bcube(n: int, link_cap: float = 125e6, ports_per_lc: int = 8):
    """BCube(n,1): n^2 servers, 2n switches of n ports; hybrid — servers have
    two NICs and participate in forwarding (via BFS paths through servers)."""
    n_servers = n * n
    base = n_servers
    def lvl0(g):                       # level-0 switch of group g
        return base + g

    def lvl1(i):                       # level-1 switch i
        return base + n + i
    edges = []
    for g in range(n):
        for s in range(n):
            srv = g * n + s
            edges.append((srv, lvl0(g)))
            edges.append((srv, lvl1(s)))
    return _build(f"bcube_n{n}", n_servers, 2 * n, edges, link_cap,
                  ports_per_lc)


def camcube(dx: int, dy: int, dz: int, link_cap: float = 125e6):
    """CamCube: server-only 3D torus; servers forward (symbiotic routing)."""
    n_servers = dx * dy * dz
    def idx(x, y, z):
        return (x % dx) * dy * dz + (y % dy) * dz + (z % dz)
    edges = set()
    for x in range(dx):
        for y in range(dy):
            for z in range(dz):
                a = idx(x, y, z)
                for b in (idx(x + 1, y, z), idx(x, y + 1, z),
                          idx(x, y, z + 1)):
                    if a != b:
                        edges.add((min(a, b), max(a, b)))
    return _build(f"camcube_{dx}x{dy}x{dz}", n_servers, 0, sorted(edges),
                  link_cap, 8)
