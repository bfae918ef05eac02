"""Analytic validation through the port (tests/test_validation.py on
``repro_torch``): at low utilization a delay timer into PkgC6 saves
energy against Active-Idle, and one into S3 loses it.  The reference's
own sizes and tolerances; the port runs on the CPU."""
import numpy as np
import torch

from repro_torch.core import farm as farm_mod
from repro_torch.core import workload
from repro_torch.core.jobs import dag_single
from repro_torch.core.types import SimConfig, SleepPolicy, SrvState

# The port runs at oracle sizes here: PyTorch's intra-op threads would
# only spin beside the other test workers.
torch.set_num_threads(1)


def _simulate(cfg, arr, specs, **kw):
    return farm_mod.simulate(cfg, arr, specs, device="cpu", **kw)


def test_sleep_saves_energy_at_low_util():
    """At low utilization a delay timer into a shallow state (PkgC6, under
    1 ms to wake) saves energy against Active-Idle at some latency cost;
    a deep state whose wake latency exceeds the idle gaps loses."""
    kw = dict(n_servers=8, n_cores=2, max_jobs=2048, tasks_per_job=1,
              max_events=80_000)
    cfg_on = SimConfig(sleep_policy=SleepPolicy.ALWAYS_ON, **kw)
    cfg_tm = SimConfig(sleep_policy=SleepPolicy.SINGLE_TIMER,
                       sleep_state=SrvState.PKG_C6, **kw)
    rng = np.random.default_rng(9)
    svc = 0.005
    n_jobs = 2000
    lam = workload.utilization_to_rate(0.10, svc, 8, 2)
    arr = workload.poisson_arrivals(lam, n_jobs, seed=10)
    specs = [dag_single(rng.exponential(svc)) for _ in range(n_jobs)]
    on = _simulate(cfg_on, arr, specs)
    tm = _simulate(cfg_tm, arr, specs, tau=0.02)
    assert tm.server_energy < 0.75 * on.server_energy
    assert tm.p95_latency >= on.p95_latency - 1e-6
    cfg_s3 = SimConfig(sleep_policy=SleepPolicy.SINGLE_TIMER,
                       sleep_state=SrvState.S3, **kw)
    s3 = _simulate(cfg_s3, arr, specs, tau=0.02)
    assert s3.server_energy > on.server_energy
