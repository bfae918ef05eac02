"""Analytic validation through the port (tests/test_validation.py and
tests/test_system.py's policy ordering on ``repro_torch``): M/M/c against
Erlang-C at load 0.8; energy conservation of an Active-Idle farm and
residency summing to the simulated time, in both hot-loop modes (the
batched passes and the seed scalar loops); the invariant sweep
(hypothesis, with fixed examples without it); WASP <= timer <=
Active-Idle on energy.

The reference's own sizes and tolerances; the port runs on the CPU."""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                       # pragma: no cover
    HAVE_HYPOTHESIS = False

from repro_torch.core import farm as farm_mod
from repro_torch.core import workload
from repro_torch.core.jobs import dag_single
from repro_torch.core.types import (SchedPolicy, SimConfig, SleepPolicy,
                                    SrvState)

from test_torch_validation import check_mmc

# The port runs at oracle sizes here: PyTorch's intra-op threads would
# only spin beside the other test workers.
torch.set_num_threads(1)


def _simulate(cfg, arr, specs, **kw):
    return farm_mod.simulate(cfg, arr, specs, device="cpu", **kw)


def test_mmc_mean_latency_at_high_load():
    check_mmc(0.8)


@pytest.mark.parametrize("vectorized", [True, False])
def test_energy_conservation_always_on(vectorized):
    """Active-Idle farm: E = P_idle_farm * T + (P_busy - P_idle) *
    busy_core_s."""
    cfg = SimConfig(n_servers=4, n_cores=2, max_jobs=512, tasks_per_job=1,
                    sleep_policy=SleepPolicy.ALWAYS_ON, max_events=50_000,
                    use_vectorized_hot_loop=vectorized)
    sp = cfg.server_power
    rng = np.random.default_rng(3)
    arr = workload.poisson_arrivals(100.0, 400, seed=4)
    specs = [dag_single(rng.exponential(0.01)) for _ in range(400)]
    res = _simulate(cfg, arr, specs)
    base = (sp.p_base + cfg.n_cores * sp.p_core_idle) * cfg.n_servers \
        * res.sim_time
    expected = base + (sp.p_core_active - sp.p_core_idle) \
        * res.busy_core_seconds
    assert res.server_energy == pytest.approx(expected, rel=1e-3)


@pytest.mark.parametrize("vectorized", [True, False])
def test_residency_sums_to_sim_time(vectorized):
    cfg = SimConfig(n_servers=5, n_cores=2, max_jobs=256, tasks_per_job=1,
                    sleep_policy=SleepPolicy.SINGLE_TIMER,
                    sleep_state=SrvState.S3, max_events=50_000,
                    use_vectorized_hot_loop=vectorized)
    rng = np.random.default_rng(5)
    arr = workload.poisson_arrivals(50.0, 200, seed=6)
    specs = [dag_single(rng.exponential(0.02)) for _ in range(200)]
    res = _simulate(cfg, arr, specs, tau=0.1)
    np.testing.assert_allclose(res.residency.sum(axis=1),
                               res.sim_time, rtol=1e-4)


def _check_engine_invariants(n_servers, n_cores, n_jobs, policy, sched, tau,
                             seed):
    """Any small configuration terminates with every job finished, time
    and energy accounting consistent, and no NaN."""
    cfg = SimConfig(n_servers=n_servers, n_cores=n_cores, local_q=64,
                    max_jobs=64, tasks_per_job=1, sched_policy=sched,
                    sleep_policy=policy, sleep_state=SrvState.S3,
                    max_events=20_000)
    rng = np.random.default_rng(seed)
    arr = workload.poisson_arrivals(20.0 * n_servers, n_jobs, seed=seed)
    specs = [dag_single(rng.exponential(0.02)) for _ in range(n_jobs)]
    res = _simulate(cfg, arr, specs, tau=tau)
    assert res.n_finished == n_jobs
    assert res.events < cfg.max_events
    assert np.all(res.latencies > 0)
    assert np.isfinite(res.server_energy) and res.server_energy > 0
    np.testing.assert_allclose(res.residency.sum(axis=1), res.sim_time,
                               rtol=1e-3, atol=1e-5)
    # work conservation: busy core-seconds == the service requirements
    total_svc = sum(float(s.service[0]) for s in specs)
    assert res.busy_core_seconds == pytest.approx(total_svc, rel=1e-3)


if HAVE_HYPOTHESIS:
    @settings(max_examples=12, deadline=None)
    @given(
        n_servers=st.integers(1, 6),
        n_cores=st.integers(1, 3),
        n_jobs=st.integers(5, 40),
        policy=st.sampled_from([SleepPolicy.ALWAYS_ON,
                                SleepPolicy.SINGLE_TIMER]),
        sched=st.sampled_from([SchedPolicy.LOAD_BALANCE,
                               SchedPolicy.ROUND_ROBIN]),
        tau=st.floats(0.01, 1.0),
        seed=st.integers(0, 2**16),
    )
    def test_engine_invariants(n_servers, n_cores, n_jobs, policy, sched,
                               tau, seed):
        _check_engine_invariants(n_servers, n_cores, n_jobs, policy, sched,
                                 tau, seed)
else:                                                     # pragma: no cover
    @pytest.mark.parametrize(
        "n_servers,n_cores,n_jobs,policy,sched,tau,seed", [
            (1, 1, 5, SleepPolicy.ALWAYS_ON, SchedPolicy.LOAD_BALANCE, 0.1,
             0),
            (4, 2, 40, SleepPolicy.SINGLE_TIMER, SchedPolicy.ROUND_ROBIN,
             0.05, 7),
            (6, 3, 25, SleepPolicy.SINGLE_TIMER, SchedPolicy.LOAD_BALANCE,
             1.0, 42),
            (3, 1, 12, SleepPolicy.ALWAYS_ON, SchedPolicy.ROUND_ROBIN, 0.5,
             99)])
    def test_engine_invariants(n_servers, n_cores, n_jobs, policy, sched,
                               tau, seed):
        _check_engine_invariants(n_servers, n_cores, n_jobs, policy, sched,
                                 tau, seed)


def test_policy_ordering_energy():
    """At moderate utilization, WASP <= single timer (PkgC6) <=
    Active-Idle on energy for the same workload."""
    rng = np.random.default_rng(0)
    n_jobs = 1200
    specs = [dag_single(rng.exponential(0.005)) for _ in range(n_jobs)]

    def run(policy, sched=SchedPolicy.LOAD_BALANCE, tau=None, pools=None):
        cfg = SimConfig(n_servers=8, n_cores=4, max_jobs=2048,
                        tasks_per_job=1, sched_policy=sched,
                        sleep_policy=policy, sleep_state=SrvState.PKG_C6,
                        wasp_t_wakeup=2.0, wasp_t_sleep=0.3,
                        max_events=80_000)
        lam = workload.utilization_to_rate(0.25, 0.005, 8, 4)
        arr = workload.poisson_arrivals(lam, n_jobs, seed=5)
        return _simulate(cfg, arr, specs, tau=tau, pools=pools)

    ai = run(SleepPolicy.ALWAYS_ON)
    tm = run(SleepPolicy.SINGLE_TIMER, tau=0.05)
    wasp = run(SleepPolicy.WASP, SchedPolicy.WASP_POOLS, tau=0.5,
               pools=(np.arange(8) >= 2).astype(np.int32))
    # at this rate per-server idle gaps are below tau, so the plain timer
    # is about Active-Idle; WASP consolidates work and wins big
    assert tm.server_energy <= ai.server_energy + 1e-3
    assert wasp.server_energy < 0.75 * ai.server_energy
    for r in (ai, tm, wasp):
        assert r.n_finished == n_jobs
