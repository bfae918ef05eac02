"""The slice end to end: every ``tests/test_engine_oracle.py`` scenario
through three engines -- the JAX package's ``farm.simulate``, the port's
``farm.simulate`` on the CPU, and the heapq ``OracleSim``; the in-scope
policies the oracle does not model (provisioning, WASP pools, queue
overflow) against JAX alone; and a tiny run with the reference's Pallas
kernels on (interpret mode).

Against JAX: discrete state (task status, assigned server, queue lengths,
wake counts, drops, event and step counts), the latency histograms and the
config digest are exact.  Latencies, energies and the telemetry window
series are within rtol 1e-5: the window columns hold float reductions such
as the farm-wide power sum, taken in another order by XLA and PyTorch.
Against the oracle, the reference's own tolerances: latency rtol/atol
1e-4, energy rel 2e-3."""
import pytest

from repro.core import farm as jfarm
from repro.core import jobs as jjobs
from repro.core.types import TelemetryConfig
from repro_torch.core import jobs as tjobs

from torch_port_util import (JAX_ONLY_SCENARIOS, ORACLE_SCENARIOS,
                             assert_state_matches, compare_results, jax_run,
                             jax_tree, port_cfg, port_simulate, scenario,
                             three_way)


@pytest.mark.parametrize("name", list(ORACLE_SCENARIOS))
def test_slice_matches_jax_and_oracle(name):
    three_way(name, oracle=True)


@pytest.mark.parametrize("name", list(JAX_ONLY_SCENARIOS))
def test_slice_matches_jax_other_policies(name):
    three_way(name, oracle=False)


def test_slice_matches_jax_with_reference_kernels_on():
    """Both of the reference's kernel flags on (Pallas in interpret mode);
    the port carries the flags for the digest and always takes its own
    kernels' path."""
    jcfg, arr, jspecs, tau, _ = scenario(
        "single_timer_s3", jjobs, max_jobs=16, max_events=200,
        use_kernel=True, telemetry=TelemetryConfig(use_kernel=True))
    arr, jspecs = arr[:10], jspecs[:10]
    tspecs = scenario("single_timer_s3", tjobs)[2][:10]
    pcfg = port_cfg(jcfg)
    assert pcfg.use_kernel and pcfg.telemetry.use_kernel
    jres = jfarm.simulate(jcfg, arr, jspecs, tau=tau)
    tres, final = port_simulate(pcfg, arr, tspecs, tau=tau)
    assert tres.n_finished == 10
    compare_results(tres, jres)
    assert_state_matches(final, jax_tree(jax_run(jcfg, arr, jspecs, tau)),
                         "use_kernel")
