"""The full rule set of ``python -m repro_torch.analysis.simlint`` on every
single-process case of the port's audit matrix (``analysis/matrix.py``):
each engine configuration, the float64-clock twins, the replica batch
(``montecarlo_vmap``), recorded on the CPU, against the committed
baseline (``analysis/baseline.json``); the sharded steps are
tests/test_torch_analysis.py's.

The reference's own green test (``test_real_engine_config_passes_full_
rule_set``) cannot run on this JAX; its cases, configurations and rules
are the design these hold the port to.  Each case also keeps its budgets
real: the cheap core's scatters are counted, the kernels are one node a
launch, and a disabled subsystem runs no op.
"""
import pytest
import torch

from repro_torch.analysis import matrix, rules, simlint
from repro_torch.analysis.graph_audit import (COLLECTIVE_OPS, HOST_SYNC_OPS,
                                              KERNEL_OPS, SCATTER_OPS)

BASELINE = rules.load_baseline(simlint.DEFAULT_BASELINE)
@pytest.mark.parametrize("name", matrix.SINGLE_DEVICE)
def test_case_passes_full_rule_set(name):
    case = matrix.build_case(name, "cpu")
    entry = BASELINE["cases"][name]
    advisory = BASELINE["torch"] != torch.__version__
    violations, report, inv = simlint.audit_case(case, entry, advisory)
    hard = [v for v in violations
            if not (advisory and v.rule == "no-new-ops")]
    assert hard == [], "\n".join(v.render() for v in hard)
    s = report["summary"]
    # the budgets are real, not vacuous
    assert inv.count(SCATTER_OPS, "cheap_core") == \
        entry["scatter_cheap_core"] > 0
    assert s["host_syncs"] == 0
    # K = 8 advances and one binning a macro-step, a replica batch's
    # included (one launch for the batch)
    assert s["kernels"] == {"repro_torch.dcsim_advance": 8,
                            "repro_torch.telemetry_accum": 1}
    assert inv.count(COLLECTIVE_OPS) == 0
    # thermal and the recorder run ops exactly when they are on
    hist = inv.histogram()
    assert any("thermal" in r.split("/") for r in hist) == case.thermal_on
    assert any("trace" in r.split("/") for r in hist) == case.trace_on
    # every time leaf keeps the clock's dtype, none rebuilt from a
    # downcast
    clock = report["clock"]
    assert clock["degraded_leaves"] == []
    assert set(clock["out_census"].values()) == {clock["time_dtype"]}
    assert clock["time_dtype"] == str(case.time_dtype).removeprefix(
        "torch.")
    # the cost model charges each kernel its own inputs and outputs
    cost = report["cost"]
    assert cost["bytes"] > 0 and cost["ops"] > 0
    assert sum(r["nodes"] for r in cost["by_region"].values()) == s["ops"]


def test_kernel_nodes_fold_onto_the_plain_versions():
    """On the CPU each kernel op is recorded with its plain version's ops
    below it (``kernel_ref/<name>``); folding leaves one node a launch, so
    a CPU recording and a card recording compare."""
    case = matrix.build_case("policy_load_balance", "cpu")
    (_, folded, full, _, _), = simlint.record_case(case)
    inner = [s for s in full.sites if s.folded_away]
    names = set()
    for s in inner:
        comps = s.region.split("/")
        names.add(comps[comps.index("kernel_ref") + 1])
    assert names == {"dcsim_advance", "telemetry_accum"}
    assert folded.n_ops == full.n_ops - len(inner)
    assert folded.count(KERNEL_OPS) == full.count(KERNEL_OPS) == 9
    assert full.count(HOST_SYNC_OPS) == 0
