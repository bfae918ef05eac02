"""Configuration and state containers of the PyTorch engine.

Static configuration mirrors ``repro.core.types`` field for field (names,
order and defaults), so one scenario digests identically in both packages
(``farm.config_digest``).  Dynamic state is a set of plain dataclasses whose
fields are tensors on one device; the engine builds new states out of place
(``replace``), so a masked step can select between an old and a new state
leaf by leaf (``tree_where``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch

# A "practically infinite" simulation time: finite, so min-reductions stay
# well defined in f32 and subtraction never produces NaN.
INF = 1.0e30

# --------------------------------------------------------------------------
# enums (plain ints so they can live inside integer tensors)
# --------------------------------------------------------------------------


class SrvState:
    """Hierarchical ACPI-style server power states."""

    ACTIVE = 0        # S0, at least one core in C0
    IDLE = 1          # S0, all cores idle (C1)
    PKG_C6 = 2        # package C6: cores+uncore power-gated, fast wake
    S3 = 3            # suspend-to-RAM, slow wake
    OFF = 4           # G2 soft-off
    WAKING = 5        # transitioning to ACTIVE
    NUM = 6


class TaskStatus:
    BLOCKED = 0       # waiting on DAG parents
    READY = 1         # deps satisfied, not yet enqueued at its server
    QUEUED = 2        # sitting in its server's queue
    RUNNING = 3       # on a core
    COMM = 4          # finished compute, results in flight to children
    DONE = 5
    INVALID = 6       # padding
    NUM = 7


class PortState:
    ACTIVE = 0
    LPI = 1           # IEEE 802.3az Low Power Idle
    OFF = 2
    NUM = 3


class LinecardState:
    ACTIVE = 0
    SLEEP = 1
    OFF = 2
    NUM = 3


class SchedPolicy:
    ROUND_ROBIN = 0
    LOAD_BALANCE = 1
    NETWORK_AWARE = 2
    PROVISIONED = 3
    WASP_POOLS = 4
    THERMAL_AWARE = 5
    CARBON_AWARE = 6


class SleepPolicy:
    ALWAYS_ON = 0
    SINGLE_TIMER = 1
    DUAL_TIMER = 2
    WASP = 3


class TraceKind:
    """Event kinds of the flight recorder (``core/trace.py``).  The values
    are the reference's: they appear in exported traces and in the heapq
    oracle's mirror (tests/oracle.py)."""

    ARRIVAL = 0            # job's arrival processed (tid = job id)
    ADMIT = 1              # job placed (tid = job id, server = its first
                           # task's server, aux = queue depth there)
    RELEASE = 2            # carbon-deferred job released (aux = seconds held)
    START = 3              # task started on a core (aux = stretched duration)
    FINISH = 4             # task finished compute
    JOB_FINISH = 5         # last task of a job done (tid = job id,
                           # aux = job latency)
    WAKEUP = 6             # server wake transition completed
    SLEEP = 7              # server entered a sleep state (aux = SrvState)
    DROP = 8               # task dropped on a full queue
    FLOW_SPAWN = 9         # network flow spawned (server = src,
                           # tid = child task, aux = bytes)
    FLOW_FINISH = 10       # network flow delivered (server = dst,
                           # tid = child task)
    THROTTLE_CROSSING = 11  # thermal throttle engaged/released
                            # (aux = temperature C)
    CTRL_TICK = 12         # CRAC setpoint controller tick
    NUM = 13

    NAMES = ("arrival", "admit", "release", "start", "finish", "job_finish",
             "wakeup", "sleep", "drop", "flow_spawn", "flow_finish",
             "throttle_crossing", "ctrl_tick")


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


# --------------------------------------------------------------------------
# static configuration
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ServerPowerProfile:
    """Per-server power (Watts) by state and wake latencies (seconds)."""

    p_core_active: float = 13.0
    p_core_idle: float = 2.0
    p_core_c6: float = 0.3
    p_base: float = 65.0
    p_pkg_c6: float = 15.0
    p_s3: float = 9.0
    p_off: float = 0.0
    p_wake: float = 145.0
    t_wake_pkg_c6: float = 1.0e-3
    t_wake_s3: float = 1.0
    t_wake_off: float = 30.0
    t_core_c6_wake: float = 5.0e-5


@dataclass(frozen=True)
class SwitchPowerProfile:
    """Cisco WS-C2960-24-S calibration from the paper's §V-B: measured base
    14.7 W plus 0.23 W per active port."""

    p_chassis: float = 14.7
    p_port_active: float = 0.23
    p_port_lpi: float = 0.023
    p_port_off: float = 0.0
    p_linecard_active: float = 0.0
    p_linecard_sleep: float = 0.0
    t_lpi_wake: float = 5.0e-6
    t_port_lpi_enter: float = 1.0e-3
    t_switch_wake: float = 0.5


@dataclass(frozen=True)
class ThermalConfig:
    """Thermal / cooling / carbon knobs (``core/thermal.py``): the per-server
    RC model, rack recirculation, the CRAC's quadratic COP, per-rack
    setpoints and their controller, the diurnal ambient, carbon and price
    series, temperature-coupled throttling and CARBON_AWARE deferral.
    ``enabled=False`` adds nothing to the step; ``t_throttle=INF`` keeps
    throttling off while temperatures are tracked."""

    enabled: bool = False
    r_th: float = 0.25
    tau_th: float = 60.0
    t_inlet: float = 22.0
    t_setpoint: object = None
    ambient_swing: float = 0.0
    ambient_period: float = 86400.0
    ambient_phase: float = 0.0
    ctrl_period: float = 0.0
    ctrl_target: float = 55.0
    ctrl_band: float = 2.0
    ctrl_step: float = 1.0
    ctrl_min: float = 12.0
    ctrl_max: float = 27.0
    defer_threshold: float = INF
    defer_signal: str = "carbon"
    recirc: float = 0.2
    rack_size: int = 8
    t_throttle: float = INF
    t_release: float = INF
    throttle_freq: float = 0.5
    throttle_power_scale: float = 0.5
    crossing_guard: float = 8.0
    cop_a: float = 0.0068
    cop_b: float = 0.0008
    cop_c: float = 0.458
    carbon_base: float = 350.0
    carbon_swing: float = 0.4
    carbon_period: float = 86400.0
    carbon_phase: float = 0.0
    price_base: float = 0.12
    price_swing: float = 0.5
    price_period: float = 86400.0
    price_phase: float = 0.0
    sched_temp_weight: float = 100.0

    @property
    def cop(self) -> float:
        t = self.t_inlet
        return self.cop_a * t * t + self.cop_b * t + self.cop_c

    @property
    def throttling(self) -> bool:
        return self.enabled and self.t_throttle < INF / 2

    @property
    def has_ctrl(self) -> bool:
        """Setpoint controller armed (its ticks are events)."""
        return self.enabled and self.ctrl_period > 0.0

    @property
    def per_rack(self) -> bool:
        """Setpoints live in ``ThermalState.t_set`` (per-rack COP) instead
        of folding to the static ``t_inlet`` constant."""
        return self.enabled and (self.t_setpoint is not None
                                 or self.has_ctrl)

    @property
    def ambient_on(self) -> bool:
        return self.enabled and self.ambient_swing != 0.0

    @property
    def deferral(self) -> bool:
        """CARBON_AWARE deferral armed (a finite signal threshold)."""
        return self.enabled and self.defer_threshold < INF / 2


@dataclass(frozen=True)
class TelemetryConfig:
    """Telemetry knobs.  ``use_kernel`` and ``compact`` choose between
    accumulation paths that the reference pins equal; the port always bins
    through ``kernels.ops.telemetry_accum`` (the CUDA kernel on the card,
    its plain version on the CPU), so both only carry over for the digest."""

    enabled: bool = True
    n_bins: int = 64
    lat_lo: float = 1.0e-5
    lat_hi: float = 1.0e3
    n_windows: int = 256
    window_dt: float = 0.1
    tail_thresh: float = 1.0
    use_kernel: bool = False
    compact: int = 32


@dataclass(frozen=True)
class TraceConfig:
    enabled: bool = False
    capacity: int = 65536


@dataclass(frozen=True)
class PartitionConfig:
    n_shards: int = 1
    axis: str = "racks"

    @property
    def sharded(self) -> bool:
        return self.n_shards > 1


@dataclass(frozen=True)
class SimConfig:
    """Static shape/topology/policy configuration.  ``use_kernel`` carries
    over for the digest: the port always advances through
    ``kernels.ops.dcsim_advance``, which the reference pins bit-equal to
    its plain path."""

    n_servers: int = 50
    n_cores: int = 4
    local_q: int = 64
    global_q: int = 256
    max_jobs: int = 2048
    tasks_per_job: int = 1
    max_children: int = 4
    max_flows: int = 256
    max_events: int = 50_000
    ready_per_step: int = 8
    arrivals_per_step: int = 8
    events_per_step: int = 8
    use_vectorized_hot_loop: bool = True
    use_kernel: bool = False
    sched_policy: int = SchedPolicy.LOAD_BALANCE
    sleep_policy: int = SleepPolicy.ALWAYS_ON
    sleep_state: int = SrvState.S3
    use_global_queue: bool = False
    prov_lo: float = 0.3
    prov_hi: float = 0.9
    wasp_t_wakeup: float = 1.5
    wasp_t_sleep: float = 0.5
    core_freq: float = 1.0
    has_network: bool = False
    flow_mtu: float = 1500.0
    comm_model: int = 0
    hop_latency: float = 5.0e-6
    server_power: ServerPowerProfile = field(default_factory=ServerPowerProfile)
    switch_power: SwitchPowerProfile = field(default_factory=SwitchPowerProfile)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    thermal: ThermalConfig = field(default_factory=ThermalConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    partition: PartitionConfig = field(default_factory=PartitionConfig)
    n_present: int = 0
    time_dtype: Any = torch.float32

    @property
    def n_tasks(self) -> int:
        return self.max_jobs * self.tasks_per_job

    @property
    def present(self) -> int:
        """Number of real (schedulable) servers; <= n_servers."""
        return self.n_present if self.n_present else self.n_servers

    @property
    def has_padding(self) -> bool:
        return 0 < self.n_present < self.n_servers


# --------------------------------------------------------------------------
# dynamic state: dataclasses of tensors.  Shapes are one run's; a replica
# batch (``core/montecarlo.py``) adds a leading R to every leaf.
# --------------------------------------------------------------------------

@dataclass
class ServerFarm:
    core_busy_until: torch.Tensor   # (N, C) completion time, INF when idle
    srv_state: torch.Tensor         # (N,) int32 SrvState
    srv_wake_at: torch.Tensor       # (N,) wake completion time (INF otherwise)
    srv_idle_since: torch.Tensor    # (N,) time the server last went idle
    srv_tau: torch.Tensor           # (N,) delay-timer value (INF = never)
    srv_pool: torch.Tensor          # (N,) int32 pool (0 active / 1 sleep)
    srv_enabled: torch.Tensor       # (N,) bool: receives new work
    q_len: torch.Tensor             # (N,) int32 queued-task count
    q_seq: torch.Tensor             # () int32 global FIFO enqueue counter
    energy: torch.Tensor            # (N,) f32 joules
    residency: torch.Tensor         # (N, SrvState.NUM) f32 seconds
    busy_core_seconds: torch.Tensor  # (N,) f32
    wake_count: torch.Tensor        # (N,) int32
    dropped: torch.Tensor           # () int32 tasks dropped on full queues


@dataclass
class JobTable:
    arrival: torch.Tensor           # (J,) arrival times (INF padded)
    arr_ptr: torch.Tensor           # () int32 next arrival index
    service: torch.Tensor           # (J*T,) f32 service time at freq 1.0
    valid: torch.Tensor             # (J*T,) bool
    dep_count: torch.Tensor         # (J*T,) int32 unfinished parents
    children: torch.Tensor          # (J*T, Dmax) int32 flat child ids (-1)
    edge_bytes: torch.Tensor        # (J*T, Dmax) f32
    status: torch.Tensor            # (J*T,) int32 TaskStatus
    edge_sent: torch.Tensor         # (J*T, Dmax) bool
    server: torch.Tensor            # (J*T,) int32 assigned server (-1)
    enqueue_seq: torch.Tensor       # (J*T,) int32 FIFO stamp
    task_end: torch.Tensor          # (J*T,) busy_until stamped at start
    start_at: torch.Tensor          # (J*T,) start time (INF until started)
    finish: torch.Tensor            # (J*T,) task finish time
    job_finish: torch.Tensor        # (J,) completion time (INF if not done)
    tasks_done: torch.Tensor        # (J,) int32
    sla: torch.Tensor               # (J,) f32 latency deadline (INF = none)
    deferrable: torch.Tensor        # (J,) bool
    deadline: torch.Tensor          # (J,) latest admit time (INF = none)
    admit_at: torch.Tensor          # (J,) release time of a deferred job


@dataclass
class FlowTable:
    src: torch.Tensor               # (F,) int32 source server
    dst: torch.Tensor               # (F,) int32 destination server
    rem: torch.Tensor               # (F,) f32 remaining bytes
    rate: torch.Tensor              # (F,) f32 current share (bytes/s)
    extra: torch.Tensor             # (F,) fixed latency budget left (s)
    done_at: torch.Tensor           # (F,) projected completion (INF idle)
    child: torch.Tensor             # (F,) int32 task whose deps decrement
    active: torch.Tensor            # (F,) bool
    flows_dropped: torch.Tensor     # () int32 spawns refused by a full
                                    # table (the edge drop-resolves)


@dataclass
class NetState:
    port_state: torch.Tensor        # (W, P) int32 PortState
    port_idle_since: torch.Tensor   # (W, P)
    lc_state: torch.Tensor          # (W, LC) int32 LinecardState
    sw_awake: torch.Tensor          # (W,) bool
    link_flows: torch.Tensor        # (L,) int32 active flows per link
    sw_energy: torch.Tensor         # (W,) f32 joules
    port_residency: torch.Tensor    # (W, P, PortState.NUM) f32 seconds


@dataclass
class SchedState:
    rr_ptr: torch.Tensor            # () int32 round-robin pointer
    n_enabled: torch.Tensor         # () int32 provisioning active-set size
    gq_tasks: torch.Tensor          # (GQ,) int32
    gq_head: torch.Tensor           # () int32
    gq_len: torch.Tensor            # () int32


@dataclass
class Telemetry:
    job_hist: torch.Tensor          # (B,) f32 job-latency histogram
    task_hist: torch.Tensor         # (B,) f32 task-latency histogram
    win: torch.Tensor               # (W, K) f32 windowed time-weighted series
    sla_miss: torch.Tensor          # () int32
    sla_total: torch.Tensor         # () int32
    tail_viol: torch.Tensor         # () int32
    win_overflow: torch.Tensor      # () f32 seconds past the window horizon


@dataclass
class ThermalState:
    """Thermal, carbon and cost state (``core/thermal.py``); 1-sized
    placeholders when the subsystem is off.  ``rack_onehot`` is never the
    reference's (R, N) membership matrix: an empty (0, 0) marker when
    racks are contiguous equal blocks (the reshape path, as in the
    reference), else an (R, K) int32 table of each rack's servers,
    ascending, -1 padded."""

    t_srv: torch.Tensor             # (N,) f32 server temperature (C)
    throttled: torch.Tensor         # (N,) bool hysteresis latch
    rack_id: torch.Tensor           # (N,) int32 dense rack id (constant)
    rack_onehot: torch.Tensor       # (0, 0) marker or (R, K) table (constant)
    rack_inv: torch.Tensor          # (R,) f32 1 / servers per rack
    t_set: torch.Tensor             # (R,) f32 CRAC supply setpoint
    ctrl_next: torch.Tensor         # () next controller tick (INF = off)
    t_peak: torch.Tensor            # (N,) f32 running max temperature
    throttle_seconds: torch.Tensor  # (N,) f32 time spent throttled
    cool_energy: torch.Tensor       # () f32 CRAC joules
    carbon_g: torch.Tensor          # () f32 grams CO2 (IT + cooling)
    cost: torch.Tensor              # () f32 electricity cost ($)
    defer_seconds: torch.Tensor     # () f32 summed deferral time
    defer_count: torch.Tensor       # () int32 jobs released after deferral
    grams_avoided: torch.Tensor     # () f32 first-order CO2 estimate


@dataclass
class TraceState:
    """The flight recorder's ring (``core/trace.py``): one (cap, 5) float
    buffer of records [kind, time, server (-1 = farm-level), tid (-1 =
    n/a), aux] in ``promote(time_dtype, float32)``, a (1, 5) placeholder
    when the recorder is off.  ``ptr`` counts every record ever written
    (slot = ptr % cap); ``dropped`` counts those overwritten by
    wrap-around.  The engine writes the ring in place: ``buf`` is the
    first ``cap`` rows of a (cap + 1, 5) tensor whose last row takes the
    writes of unset lanes (``trace.flush``)."""

    buf: torch.Tensor               # (cap, 5)
    ptr: torch.Tensor               # () int32 monotonic write pointer
    dropped: torch.Tensor           # () int32 records lost to wrap-around


@dataclass
class SimState:
    """Engine state, the reference's SimState leaf for leaf.
    ``flows``/``net``, ``thermal`` and ``trace`` are 1-sized placeholders
    when the configuration has no network, no thermal subsystem or no
    flight recorder."""

    t: torch.Tensor                 # () current simulation time
    farm: ServerFarm
    jobs: JobTable
    flows: FlowTable
    net: NetState
    sched: SchedState
    telem: Telemetry
    thermal: ThermalState
    trace: TraceState
    events: torch.Tensor            # () int32 processed event count
    steps: torch.Tensor             # () int32 sim_step invocations
    done: torch.Tensor              # () bool all jobs finished


def tree_where(mask, new, old):
    """Leaf-wise ``torch.where(mask, new, old)`` over two states of the
    same dataclass layout.  ``mask`` has the states' batch shape (``()``
    for one run, ``(R,)`` for R replicas) and broadcasts over each leaf's
    trailing axes.  A leaf that is the same tensor on both sides (a
    subtree the pass did not touch, or the flight recorder's ring, which
    is written in place) is returned as it is: no state tensor is ever
    copied or written in place here."""
    if new is old:
        return new
    if dataclasses.is_dataclass(new):
        return type(new)(**{f.name: tree_where(mask, getattr(new, f.name),
                                               getattr(old, f.name))
                            for f in dataclasses.fields(new)})
    return torch.where(lift(mask, new.dim() - mask.dim()), new, old)


def tree_map(fn, obj, *rest):
    """A dataclass tree of ``obj``'s layout whose leaves are ``fn`` of
    ``obj``'s leaves and the matching leaves of ``rest`` (trees of the
    same layout), visited in field order, as ``tree_leaves`` lists
    them."""
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{
            f.name: tree_map(fn, getattr(obj, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(obj)})
    return fn(obj, *rest)


def tree_leaves(obj, prefix: str = ""):
    """[(dotted path, tensor)] of every leaf, in field order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        path = f"{prefix}.{f.name}" if prefix else f.name
        if dataclasses.is_dataclass(v):
            out.extend(tree_leaves(v, path))
        else:
            out.append((path, v))
    return out


# --------------------------------------------------------------------------
# the replica axis: every state leaf has a leading batch shape, () for one
# run and (R,) for R replicas (``core/montecarlo.py``); module functions
# work along the trailing (server, core, job) axes with these helpers
# --------------------------------------------------------------------------

def lift(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """``x`` with ``n`` trailing singleton axes (a view): a per-replica
    value broadcast against per-server or per-task tensors."""
    return x.reshape(x.shape + (1,) * n) if n > 0 else x


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` replica by replica: x (*B, n), idx (*B, *I) integer
    indices in [0, n) -> (*B, *I), one gather along the last axis."""
    nb = x.dim() - 1
    flat = idx.reshape(idx.shape[:nb] + (-1,))
    return torch.gather(x, -1, flat.to(torch.int64)).view(idx.shape)


def set_drop(base: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``base.at[..., idx].set(vals, mode="drop")`` replica by replica:
    base (*B, n), idx (*B, K) in [0, n], where ``n`` is the drop sentinel
    (a column one past the end, sliced off), vals a number or a tensor
    broadcastable to idx.  Indices other than the sentinel must be
    distinct within a replica."""
    n = base.shape[-1]
    buf = torch.cat([base, base[..., :1]], dim=-1)
    if not torch.is_tensor(vals):
        vals = torch.full(idx.shape, vals, dtype=base.dtype,
                          device=base.device)
    buf = buf.scatter(-1, idx.to(torch.int64),
                      vals.to(base.dtype).expand(idx.shape))
    return buf[..., :n]


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device a run uses: CUDA unless the caller asks for the CPU.
    Without a card and without ``device="cpu"`` this raises; it never
    moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def init_farm(cfg: SimConfig, device) -> ServerFarm:
    N, C = cfg.n_servers, cfg.n_cores
    tdt = cfg.time_dtype
    i32, f32 = torch.int32, torch.float32
    # padded filler rows (index >= cfg.present) boot OFF and disabled
    real = torch.arange(N, device=device) < cfg.present
    return ServerFarm(
        core_busy_until=torch.full((N, C), INF, dtype=tdt, device=device),
        srv_state=torch.where(
            real, SrvState.IDLE, SrvState.OFF).to(i32),
        srv_wake_at=torch.full((N,), INF, dtype=tdt, device=device),
        srv_idle_since=torch.zeros((N,), dtype=tdt, device=device),
        srv_tau=torch.full((N,), INF, dtype=tdt, device=device),
        srv_pool=torch.zeros((N,), dtype=i32, device=device),
        srv_enabled=real,
        q_len=torch.zeros((N,), dtype=i32, device=device),
        q_seq=torch.zeros((), dtype=i32, device=device),
        energy=torch.zeros((N,), dtype=f32, device=device),
        residency=torch.zeros((N, SrvState.NUM), dtype=f32, device=device),
        busy_core_seconds=torch.zeros((N,), dtype=f32, device=device),
        wake_count=torch.zeros((N,), dtype=i32, device=device),
        dropped=torch.zeros((), dtype=i32, device=device),
    )


def init_flows(cfg: SimConfig, device) -> FlowTable:
    """An empty flow table of ``cfg.max_flows`` slots.  ``rem`` and ``rate``
    are f32 and ``extra``/``done_at`` follow the clock, under every
    clock."""
    F, tdt = cfg.max_flows, cfg.time_dtype
    i32, f32 = torch.int32, torch.float32
    return FlowTable(
        src=torch.full((F,), -1, dtype=i32, device=device),
        dst=torch.full((F,), -1, dtype=i32, device=device),
        rem=torch.zeros((F,), dtype=f32, device=device),
        rate=torch.zeros((F,), dtype=f32, device=device),
        extra=torch.zeros((F,), dtype=tdt, device=device),
        done_at=torch.full((F,), INF, dtype=tdt, device=device),
        child=torch.full((F,), -1, dtype=i32, device=device),
        active=torch.zeros((F,), dtype=torch.bool, device=device),
        flows_dropped=torch.zeros((), dtype=i32, device=device),
    )


def init_net(n_switches: int, n_ports: int, n_links: int,
             n_linecards: int, cfg: SimConfig, device) -> NetState:
    """Switch state: every port in LPI, every line card active, every
    switch awake (1-sized when there is no topology)."""
    W, P, L = max(n_switches, 1), max(n_ports, 1), max(n_links, 1)
    LC = max(n_linecards, 1)
    tdt = cfg.time_dtype
    i32, f32 = torch.int32, torch.float32
    return NetState(
        port_state=torch.full((W, P), PortState.LPI, dtype=i32,
                              device=device),
        port_idle_since=torch.zeros((W, P), dtype=tdt, device=device),
        lc_state=torch.full((W, LC), LinecardState.ACTIVE, dtype=i32,
                            device=device),
        sw_awake=torch.ones((W,), dtype=torch.bool, device=device),
        link_flows=torch.zeros((L,), dtype=i32, device=device),
        sw_energy=torch.zeros((W,), dtype=f32, device=device),
        port_residency=torch.zeros((W, P, PortState.NUM), dtype=f32,
                                   device=device),
    )


def init_sched(cfg: SimConfig, device) -> SchedState:
    i32 = torch.int32
    return SchedState(
        rr_ptr=torch.zeros((), dtype=i32, device=device),
        n_enabled=torch.tensor(cfg.present, dtype=i32, device=device),
        gq_tasks=torch.full((cfg.global_q,), -1, dtype=i32, device=device),
        gq_head=torch.zeros((), dtype=i32, device=device),
        gq_len=torch.zeros((), dtype=i32, device=device),
    )
