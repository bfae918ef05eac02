"""Analytic validation through the port (tests/test_validation.py on
``repro_torch``): the simulated mean latency of one server with c cores
and a single queue against M/M/c's Erlang-C closed form at loads 0.3 and
0.6, and the MMPP(2) generator's burstiness.  M/M/c at 0.8, the energy
and residency laws, the invariant sweep and the policy ordering are in
tests/test_torch_validation_laws.py; sleep savings in
tests/test_torch_validation_sleep.py.

The reference's own sizes and tolerances; the port runs on the CPU."""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import farm as farm_mod
from repro_torch.core import workload
from repro_torch.core.jobs import dag_single
from repro_torch.core.types import SimConfig, SleepPolicy

# The port runs at oracle sizes here: PyTorch's intra-op threads would
# only spin beside the other test workers.
torch.set_num_threads(1)


def erlang_c_wait(c, lam, mu):
    """Mean sojourn time W = Wq + 1/mu for M/M/c."""
    a = lam / mu
    rho = a / c
    assert rho < 1
    p0 = 1.0 / (sum(a ** k / math.factorial(k) for k in range(c))
                + a ** c / (math.factorial(c) * (1 - rho)))
    erl = a ** c / (math.factorial(c) * (1 - rho)) * p0
    return erl / (c * mu - lam) + 1 / mu


def check_mmc(rho):
    """One server with c cores and a single queue is M/M/c exactly."""
    c, svc, n_jobs = 8, 0.01, 4000
    cfg = SimConfig(n_servers=1, n_cores=c, local_q=512, max_jobs=4096,
                    tasks_per_job=1, sleep_policy=SleepPolicy.ALWAYS_ON,
                    max_events=100_000)
    mu = 1.0 / svc
    lam = rho * mu * c
    rng = np.random.default_rng(42)
    arr = workload.poisson_arrivals(lam, n_jobs, seed=2)
    specs = [dag_single(rng.exponential(svc)) for _ in range(n_jobs)]
    res = farm_mod.simulate(cfg, arr, specs, device="cpu")
    w_theory = erlang_c_wait(c, lam, mu)
    assert res.n_finished == n_jobs
    assert res.mean_latency == pytest.approx(w_theory, rel=0.08)
    assert res.utilization == pytest.approx(rho, rel=0.08)


# rho = 0.8 runs in tests/test_torch_validation_laws.py, so that xdist's
# --dist loadfile spreads the three runs
@pytest.mark.parametrize("rho", [0.3, 0.6])
def test_mmc_mean_latency(rho):
    check_mmc(rho)


def test_mmpp_burstiness():
    """MMPP(2) with Ra >> 1 gives a burstier arrival process than Poisson
    at the same mean rate (a higher CV of the inter-arrivals)."""
    lam = 100.0
    pois = workload.poisson_arrivals(lam, 20_000, seed=1)
    mmpp = workload.mmpp2_arrivals(lam_h=4 * lam / 2.2, lam_l=0.4 * lam / 2.2,
                                   r_hl=1.0, r_lh=2.0, n_jobs=20_000, seed=1)

    def cv(a):
        return np.std(np.diff(a)) / np.mean(np.diff(a))
    assert cv(mmpp) > 1.3 * cv(pois)
    assert cv(pois) == pytest.approx(1.0, abs=0.05)
