"""Job / task DAG modeling (paper §III-C), port of ``repro.core.jobs``.

Each job is a DAG of tasks with service times and edge transfer sizes; the
whole job table is stored as dense padded tensors (J*T flat task ids) so the
engine resolves dependencies with vector ops.  Templates: ``single``,
``chain``, ``fanout`` and ``random``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import INF, JobTable, SimConfig, TaskStatus, resolve_device

__all__ = ["build_jobs", "dag_single", "dag_chain", "dag_fanout", "dag_random",
           "JobSpec"]


@dataclasses.dataclass
class JobSpec:
    """Host-side job description before padding into a JobTable."""

    service: np.ndarray          # (T,) per-task service times
    edges: list                  # list of (parent, child, bytes)
    sla: float = INF             # latency deadline (sec); INF = no SLA
    deferrable: bool = False
    defer_slack: float = INF


def dag_single(service: float, sla: float = INF, deferrable: bool = False,
               defer_slack: float = INF) -> JobSpec:
    return JobSpec(service=np.asarray([service]), edges=[], sla=sla,
                   deferrable=deferrable, defer_slack=defer_slack)


def dag_chain(services, edge_bytes: float = 0.0) -> JobSpec:
    sv = np.asarray(services, dtype=np.float64)
    edges = [(i, i + 1, edge_bytes) for i in range(len(sv) - 1)]
    return JobSpec(service=sv, edges=edges)


def dag_fanout(root: float, leaves, join: float,
               edge_bytes: float = 0.0) -> JobSpec:
    lv = np.asarray(leaves, dtype=np.float64)
    k = len(lv)
    sv = np.concatenate([[root], lv, [join]])
    edges = [(0, 1 + i, edge_bytes) for i in range(k)]
    edges += [(1 + i, 1 + k, edge_bytes) for i in range(k)]
    return JobSpec(service=sv, edges=edges)


def dag_random(n_tasks: int, mean_service: float, edge_prob: float,
               edge_bytes: float, rng: np.random.Generator) -> JobSpec:
    sv = rng.exponential(mean_service, size=n_tasks)
    edges = []
    for child in range(1, n_tasks):
        # guarantee connectivity: at least one parent among predecessors
        parents = [p for p in range(child) if rng.random() < edge_prob]
        if not parents:
            parents = [int(rng.integers(0, child))]
        for p in parents:
            edges.append((p, child, edge_bytes))
    return JobSpec(service=sv, edges=edges)


def build_jobs(cfg: SimConfig, arrivals: np.ndarray, specs: list,
               device=None) -> JobTable:
    """Pad a list of JobSpecs (one per arrival) into a dense JobTable on
    ``device``: the default CUDA device, or the CPU when asked
    (``device="cpu"``).  The engine runs on the job table's device."""
    device = resolve_device(device)
    J, T, D = cfg.max_jobs, cfg.tasks_per_job, cfg.max_children
    if cfg.n_tasks >= np.iinfo(np.int32).max:
        # int32 task ids / FIFO stamps: a task enqueues at most once, so a
        # table below 2^31 rows keeps every stamp comparison wrap-free
        raise ValueError(
            f"max_jobs*tasks_per_job = {cfg.n_tasks} overflows int32 task "
            f"ids / FIFO stamps (limit {np.iinfo(np.int32).max})")
    n = min(len(arrivals), J, len(specs))

    arr = np.full((J,), INF)
    service = np.zeros((J, T))
    valid = np.zeros((J, T), bool)
    dep_count = np.zeros((J, T), np.int32)
    children = np.full((J, T, D), -1, np.int32)
    edge_bytes = np.zeros((J, T, D))
    sla = np.full((J,), INF)
    deferrable = np.zeros((J,), bool)
    deadline = np.full((J,), INF)

    for j in range(n):
        spec = specs[j]
        t = len(spec.service)
        if t > T:
            raise ValueError(f"job {j}: {t} tasks > tasks_per_job={T}")
        arr[j] = arrivals[j]
        sla[j] = getattr(spec, "sla", INF)
        deferrable[j] = getattr(spec, "deferrable", False)
        slack = getattr(spec, "defer_slack", INF)
        deadline[j] = arr[j] + slack if slack < INF / 2 else INF
        service[j, :t] = spec.service
        valid[j, :t] = True
        slot = np.zeros(T, np.int32)
        for (p, c, b) in spec.edges:
            dep_count[j, c] += 1
            k = slot[p]
            if k >= D:
                raise ValueError(f"job {j}: task {p} fanout > max_children={D}")
            children[j, p, k] = j * T + c      # flat child id
            edge_bytes[j, p, k] = b
            slot[p] += 1

    status = np.where(valid, TaskStatus.BLOCKED, TaskStatus.INVALID)
    tdt, f32, i32 = cfg.time_dtype, torch.float32, torch.int32

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                           dtype=dtype)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return JobTable(
        arrival=dev(arr, tdt),
        arr_ptr=torch.zeros((), dtype=i32, device=device),
        service=dev(service.reshape(-1), f32),
        valid=dev(valid.reshape(-1), torch.bool),
        dep_count=dev(dep_count.reshape(-1), i32),
        children=dev(children.reshape(J * T, D), i32),
        edge_bytes=dev(edge_bytes.reshape(J * T, D), f32),
        status=dev(status.reshape(-1), i32),
        edge_sent=dev(children.reshape(J * T, D) < 0, torch.bool),
        server=full((J * T,), -1, i32),
        enqueue_seq=full((J * T,), 0, i32),
        task_end=full((J * T,), INF, tdt),
        start_at=full((J * T,), INF, tdt),
        finish=full((J * T,), INF, tdt),
        job_finish=full((J,), INF, tdt),
        tasks_done=full((J,), 0, i32),
        sla=dev(sla, f32),
        deferrable=dev(deferrable, torch.bool),
        deadline=dev(deadline, tdt),
        admit_at=full((J,), INF, tdt),
    )
