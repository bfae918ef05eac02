"""Network mode in the seed scalar hot loops
(``SimConfig(use_vectorized_hot_loop=False)``): the scenarios of
``tests/test_engine_vectorized.py`` and ``tests/test_network_flows.py``
that hold vectorized == scalar, through the reference's scalar engine, the
port's scalar engine and the port's vectorized engine, flow and packet
models, flow-slot exhaustion; and the star traced, its ring against JAX's
scalar ring and the port's vectorized stream (``traceio.diff_traces``).

Tolerances: port scalar against JAX scalar as the guardrails hold them
(``TOL_LEAVES`` at rtol 1e-5, everything else exact); scalar against
vectorized within the reference's ``_final_states_equal`` (rtol/atol
1e-6, every leaf)."""
import dataclasses

import pytest

from repro.core import jobs as jjobs
from repro.core import topology as jtopo
from repro.core import types as jtypes
from repro.core.types import SimConfig
from repro_torch.core import jobs as tjobs
from repro_torch.core import topology as ttopo
from repro_torch.core import traceio
from repro_torch.core.types import TraceKind

from torch_port_util import (SCALAR, SCALAR_NET_SCENARIOS,
                             assert_ring_matches, jax_run, jax_tree,
                             net_scenario, network_three_way, port_run,
                             scalar_three)


@pytest.mark.parametrize("name", list(SCALAR_NET_SCENARIOS))
def test_scalar_network_runs_match_jax_and_vectorized(name):
    kw, arr, jspecs, tau, jt = SCALAR_NET_SCENARIOS[name](jjobs, jtopo)
    _, _, tspecs, _, tt = SCALAR_NET_SCENARIOS[name](tjobs, ttopo)
    fin = scalar_three(SimConfig(**kw), arr, jspecs, tspecs, tau, jt, tt,
                       ctx=name)
    assert int(fin.jobs.tasks_done.sum()) == 2 * len(arr)
    if name == "star_exhaustion":
        assert int(fin.flows.flows_dropped) > 0
    if name == "fat_tree_round_robin":
        # ports leave LPI only while links carry flows
        assert float(fin.net.port_residency[..., 0].sum()) > 0


def test_scalar_traced_star_matches_jax_and_vectorized():
    """tests/test_network_flows.py's star with two flow slots, ROUND_ROBIN,
    traced, in scalar mode, so all three loops run: the results equal
    JAX's scalar run; the ring equals JAX's scalar ring record for record
    and decodes to the port's vectorized stream."""
    on = dict(trace=jtypes.TraceConfig(enabled=True))
    tres = network_three_way("star_exhaustion", False, **on, **SCALAR)
    assert tres.flows_dropped > 0
    pcfg, arr, specs, tau, _, topo = net_scenario("star_exhaustion", "port",
                                                  **on)
    sca = port_run(dataclasses.replace(pcfg, **SCALAR), arr, specs, tau,
                   topo=topo)
    vec = port_run(pcfg, arr, specs, tau, topo=topo)
    ev_s, _ = traceio.decode(sca.trace, pcfg)
    ev_v, _ = traceio.decode(vec.trace, pcfg)
    assert traceio.diff_traces(ev_s, ev_v, check_aux=True,
                               names=("scalar", "vectorized")) is None
    assert TraceKind.FLOW_SPAWN in set(ev_s["kind"].tolist())
    jcfg, jarr, jspecs, jtau, _, jt = net_scenario("star_exhaustion", "jax",
                                                   **on, **SCALAR)
    tree = jax_tree(jax_run(jcfg, jarr, jspecs, jtau, None, jt))
    assert_ring_matches(sca.trace.buf.numpy(), tree["trace.buf"], "ring")
