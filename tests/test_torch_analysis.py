"""The port's graph audit (``src/repro_torch/analysis/``) against the
reference's design (``src/repro/analysis/``, simlint).

Planted violations, one for each of tests/test_analysis.py's: a step that
breaks exactly one pinned contract (a scatter in a forbidden region, a
stray collective, a host sync, a degraded clock, a clock census, baseline
drift, an exact count) must trip exactly its rule, with a site in this
file.  The recorder's mechanics (region provenance through nested calls,
clock taint through a Python loop and an in-place ``index_put_``) and the
rebuild guard's plumbing follow; then the ``torch.library`` ops' fake
implementations and their CPU route, the state footprint against the
reference's ``footprint_of`` (which runs on this JAX; the reference's
jaxpr inventory does not, so its counts are no oracle), the sharded
macro-step's collective contract on 1 and 2 gloo ranks, and the CLI
against the committed baseline.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import (costmodel, graph_audit, matrix, recompile,
                                  rules)
from repro_torch.core import regions
from repro_torch.analysis.graph_audit import (ALL_GATHER_OPS,
                                              COLLECTIVE_OPS, HOST_SYNC_OPS,
                                              KERNEL_OPS, SCATTER_OPS,
                                              clock_audit, record)
from repro_torch.core.regions import region
from repro_torch.core import shard_sim
from repro_torch.kernels import ops, ref

THIS_FILE = "test_torch_analysis.py"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _one(violations, rule_name):
    """Exactly one violation, from the named rule, located in this file."""
    assert len(violations) == 1, violations
    v = violations[0]
    assert v.rule == rule_name
    located = [s for s in v.sites if THIS_FILE in s]
    assert located, (v.message, v.sites)
    return v


@pytest.fixture
def world1(tmp_path):
    """An in-process gloo group of one rank."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ==========================================================================
# planted violations
# ==========================================================================

def test_planted_scatter_in_forbidden_region():
    def step(x, idx):
        with region("cheap_core"):
            y = x.clone()
            y[idx] = 0.0
            return y

    inv = record(step, torch.zeros(8), torch.tensor([1]))
    rule = rules.ForbidOp(name="cheap-core-scatter-free", ops=SCATTER_OPS,
                          region="cheap_core")
    v = _one(rule.check("fixture", inv, None), "cheap-core-scatter-free")
    assert "index_put_" in v.message
    # the same scatter OUTSIDE the region does not fire
    inv2 = record(lambda x, i: x.index_fill(0, i, 0.0).scatter(
        0, i, torch.zeros(1)), torch.zeros(8), torch.tensor([1]))
    assert inv2.count(SCATTER_OPS) == 1
    assert rule.check("fixture", inv2, None) == []


def test_planted_stray_collective(world1):
    def step(x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    inv = record(step, torch.ones(4))
    rule = rules.ForbidOp(name="no-other-collectives",
                          ops=COLLECTIVE_OPS - ALL_GATHER_OPS)
    v = _one(rule.check("fixture", inv, None), "no-other-collectives")
    assert "c10d.allreduce_" in v.message
    # a gather is the one collective the sharded step may call
    inv2 = record(lambda x: shard_sim.all_gather(x, None, 1), torch.ones(4))
    assert inv2.count(ALL_GATHER_OPS) == 1
    assert rule.check("fixture", inv2, None) == []


@pytest.mark.parametrize("read", ["item", "bool"])
def test_planted_host_sync(read):
    def step(x):
        y = x * 2.0
        if read == "item":
            return y + y.sum().item()
        return y if bool((y > 0).any()) else -y

    inv = record(step, torch.ones(4))
    rule = rules.ForbidOp(name="no-host-sync-in-step", ops=HOST_SYNC_OPS)
    v = _one(rule.check("fixture", inv, None), "no-host-sync-in-step")
    assert "_local_scalar_dense" in v.message


@dataclasses.dataclass
class TinyState:
    t: torch.Tensor      # declared clock leaf (path suffix ".t")
    x: torch.Tensor


def _tiny(n=(), dtype=torch.float64):
    return TinyState(t=torch.full(n, 1.25, dtype=dtype),
                     x=torch.zeros(4, dtype=torch.float32))


def test_planted_degraded_clock():
    def step(s):
        # an f64 clock round-trips through f32: precision silently lost
        bad = s.t.to(torch.float32).to(torch.float64)
        return TinyState(t=bad + 1.0, x=s.x * 2.0)

    report = clock_audit(step, _tiny(), torch.float64)
    violations = rules.DtypePolicy().check_clock("fixture", report)
    v = _one(violations, "clock-dtype-policy")
    assert ".t" in v.message and "downcast" in v.message

    # the identical downcast inside a declared f32_domain region is an
    # intentional physics exit -- no violation
    def step_tagged(s):
        with region(regions.F32_DOMAIN):
            phys = s.t.to(torch.float32)
        return TinyState(t=s.t + 1.0, x=s.x + phys)

    report2 = clock_audit(step_tagged, _tiny(), torch.float64)
    assert rules.DtypePolicy().check_clock("fixture", report2) == []
    assert report2.degraded_leaves == []


def test_planted_clock_census_violation():
    def step(s):
        return TinyState(t=s.t.to(torch.float32), x=s.x)

    report = clock_audit(step, _tiny(), torch.float64)
    bad = rules.DtypePolicy().check_clock("fixture", report)
    # fires as BOTH a census violation and a detected downcast
    assert bad and any("has dtype float32" in v.message for v in bad)
    assert any(v.sites and THIS_FILE in v.sites[0] for v in bad)
    assert all(v.rule == "clock-dtype-policy" for v in bad)


def test_planted_baseline_drift():
    def v1(x):
        return x * 2.0

    def v2(x):
        return torch.exp(x) * 2.0      # structural drift: a new op

    inv1 = record(v1, torch.zeros(4))
    inv2 = record(v2, torch.zeros(4))
    entry = rules.baseline_entry_from(inv1)
    rule = rules.NoNewOps()
    assert rule.check("fixture", inv1, entry) == []
    v = _one(rule.check("fixture", inv2, entry), "no-new-ops")
    assert "aten.exp" in v.message
    # an explicit waiver silences exactly that drift
    entry["waivers"] = [{"config": "fixture", "op": "aten.exp",
                         "reason": "test waiver"}]
    assert rule.check("fixture", inv2, entry) == []
    # a missing baseline is itself a violation (forces --update)
    missing = rule.check("fixture", inv2, None)
    assert missing and "run --update" in missing[0].message
    assert json.dumps(entry)                    # the entry is JSON-clean


def test_exact_count_reports_mismatch_with_sites():
    def step(x, i):
        y = x.clone()
        y[i] = 1.0
        return y.index_add(0, i, torch.full((1,), 2.0))

    inv = record(step, torch.zeros(8), torch.tensor([1]))
    rule = rules.ExactCount(name="one-all-gather-per-sharded-leaf",
                            ops=SCATTER_OPS, expect=1)
    v = _one(rule.check("fixture", inv, None),
             "one-all-gather-per-sharded-leaf")
    assert "expected exactly 1" in v.message and len(v.sites) == 2


# ==========================================================================
# recorder mechanics
# ==========================================================================

def test_region_provenance_inherits_into_nested_calls():
    def hot(v):
        out = v.clone()
        out[torch.tensor([0])] = v[1:2] * 3.0
        return out

    def inner(v):
        with region("f32_domain"):
            return hot(v)

    def f(x):
        with region("cheap_core"):
            return inner(x)

    inv = record(f, torch.ones(4))
    hits = inv.sites_of(SCATTER_OPS, "cheap_core")
    assert hits, inv.histogram()
    assert inv.count(SCATTER_OPS, "cheap_core") == inv.count(SCATTER_OPS)
    assert {s.region for s in hits} == {"cheap_core/f32_domain"}
    assert all(f"{THIS_FILE}:" in s.src and "(hot)" in s.src for s in hits)


def test_clock_taint_through_loop_carry():
    def step(s):
        # degradation enters the carry on iteration 1 and must still be
        # seen at the output
        t = s.t
        for k in range(3):
            if k == 1:
                t = t.to(torch.float32).to(torch.float64)
            t = t + 0.5
        return TinyState(t=t, x=s.x)

    report = clock_audit(step, _tiny(), torch.float64)
    assert [leaf for leaf, _ in report.degraded_leaves] == [".t"]


def test_clock_taint_through_in_place_index_put():
    def step(s):
        t = s.t.clone()
        t[torch.tensor([1])] = s.t[1:2].to(torch.float32).to(torch.float64)
        return TinyState(t=t, x=s.x)

    report = clock_audit(step, _tiny((3,)), torch.float64)
    ((leaf, site),) = report.degraded_leaves
    assert leaf == ".t" and THIS_FILE in site

    def step_clean(s):
        t = s.t.clone()
        t[torch.tensor([1])] = s.t[2:3] + 1.0
        return TinyState(t=t, x=s.x)

    assert clock_audit(step_clean, _tiny((3,)),
                       torch.float64).degraded_leaves == []


# ==========================================================================
# rebuild sentinel plumbing
# ==========================================================================

def test_rebuild_guard_counts_only_inside_guard():
    from repro_torch.kernels import build
    build.MISSES["tag", ("outside",)] += 2        # before the guard: ignored
    with recompile.build_guard() as rebuilt:
        build.MISSES["build.load", ("k1",)] += 1
        build.MISSES["build.load", ("k1",)] += 1
        build.MISSES["build.load", ("k2",)] += 1
        build.MISSES["tag", ("outside",)] += 1    # its first miss inside
        hits = rebuilt()
        every = rebuilt(min_builds=1)
    assert len(hits) == 1 and hits[0]["builds"] == 2
    assert "k1" in hits[0]["key"]
    assert sorted(e["key"] for e in every) == [repr(("k1",)), repr(("k2",)),
                                                repr(("outside",))]
    # a new guard starts from the counts at its entry
    build.MISSES["tag", ("after",)] += 1
    with recompile.build_guard() as rebuilt:
        assert rebuilt() == [] and rebuilt(min_builds=1) == []


# ==========================================================================
# the kernels as torch.library ops
# ==========================================================================

def _kernel_inputs():
    """Each op's CPU inputs (small shapes; a replica batch for the
    advance), from a seed."""
    from torch_kernel_inputs import (dcsim_inputs_batched, flash_inputs,
                                     ssm_inputs, tb_inputs, torch_args)
    dc = torch_args(dcsim_inputs_batched(3, 5, 4, 0), "cpu")
    tb = torch_args(tb_inputs(30, 20, 64, 4, 3, 1), "cpu")
    fa = torch_args(flash_inputs(1, 4, 2, 7, 9, 16, seed=2))
    ss = torch_args(ssm_inputs(2, 5, 6, 4, seed=3))
    return {"dcsim_advance": (dc, ref.dcsim_advance_reference),
            "telemetry_accum": (tb, ref.telemetry_accum_reference),
            "flash_attention": (fa, ref.mha_reference),
            "ssm_scan": (ss, ref.ssm_scan_reference)}


@pytest.mark.parametrize("name", ["dcsim_advance", "telemetry_accum",
                                  "flash_attention", "ssm_scan"])
def test_ops_fake_shapes_and_cpu_route(name):
    """The fake implementation gives the wrapper's output shapes and
    dtypes without running it (fake tensors, and the meta device); a CPU
    tensor takes the plain version, bit for bit, with no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    args, plain = _kernel_inputs()[name]
    entry = getattr(ops, name)
    ops.reset_launch_counts()
    got = entry(*args)
    exp = plain(*args)
    got_t = got if isinstance(got, tuple) else (got,)
    exp_t = exp if isinstance(exp, tuple) else (exp,)
    assert all(torch.equal(g, e) for g, e in zip(got_t, exp_t, strict=True))
    assert ops.launch_counts()[name] == 0
    for mode in ("fake", "meta"):
        if mode == "fake":
            with FakeTensorMode() as fm:
                fa = [fm.from_tensor(a) if torch.is_tensor(a) else a
                      for a in args]
                out = entry(*fa)
        else:
            out = entry(*[a.to("meta") if torch.is_tensor(a) else a
                          for a in args])
        out = out if isinstance(out, tuple) else (out,)
        assert [(tuple(o.shape), o.dtype) for o in out] == \
            [(tuple(e.shape), e.dtype) for e in exp_t], mode
    # one node to a recording; on the CPU the plain version's ops sit in
    # its kernel_ref region, and folding drops them
    inv = record(entry, *args)
    assert inv.count(KERNEL_OPS) == 1
    assert inv.sites_of(KERNEL_OPS)[0].op == ops.OPS[name]
    inner = [s for s in inv.sites if s.folded_away]
    assert inner and all(s.region == f"kernel_ref/{name}" for s in inner)
    assert inv.folded().n_ops == 1
    b, n = costmodel.op_cost(inv.folded().sites[0])
    assert b == sum(graph_audit.distinct_bytes(t) for t in args
                    if torch.is_tensor(t)) + \
        sum(graph_audit.distinct_bytes(t) for t in exp_t) and n > 0


# ==========================================================================
# state footprint: parity with the reference's footprint_of
# ==========================================================================

@pytest.mark.parametrize("label", ["farm_8", "farm_1024", "farm_65536"])
def test_footprint_matches_the_reference(label):
    """The port's state layout against the JAX package's, field by field
    (``repro.analysis.matrix.footprint_of``, through jax.eval_shape).  No
    field differs by design: the flight recorder's sentinel row lies
    behind the (cap, 5) view the state holds, and a contiguous rack
    grouping is a (0, 0) marker on both sides.  farm_65536 is sized on
    fake tensors: no leaf has storage."""
    from repro.analysis import matrix as jmatrix
    jf = jmatrix.footprint_of(jmatrix.state_footprint_cases()[label])
    cfg = matrix.state_footprint_cases()[label]
    fp = matrix.footprint_of(cfg)
    assert fp == jf
    if label == "farm_65536":
        from torch._subclasses.fake_tensor import FakeTensor
        from repro_torch.core import engine, jobs
        built = []

        def init():
            jt = jobs.build_jobs(cfg, np.zeros(1), [jobs.dag_single(0.01)],
                                 device="cpu")
            built.append(engine.init_state(cfg, jt)[0])
            return built[-1]
        assert costmodel.state_footprint(init) == fp
        assert all(isinstance(x, FakeTensor)
                   for _, x in graph_audit.leaves(built[0]))
        assert fp["total_bytes"] == 13_152_130


# ==========================================================================
# the sharded macro-step: one all_gather per sharded leaf, nothing else
# ==========================================================================

def _case_rules(case, inv, clock):
    """Every rule simlint applies to ``case``, against a baseline entry
    pinned from ``inv`` itself."""
    from repro_torch.analysis import simlint
    entry = rules.baseline_entry_from(inv)
    vs = [v for rule in simlint.rules_for(case, entry, advisory=False)
          for v in rule.check(case.name, inv, entry)]
    return vs + rules.DtypePolicy().check_clock(case.name, clock)


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_step_graph_collective_rules(k):
    """sharded_d1 in this process and sharded_d2 on two spawned gloo
    ranks: on every rank one all_gather per sharded leaf (19, thermal on),
    no other collective, no host sync, the clock policy green."""
    case = matrix.build_case(f"sharded_d{k}", "cpu")
    assert case.n_sharded == 19 and len(case.ranks) == k
    for inv, clock in case.ranks:
        assert inv.count(ALL_GATHER_OPS) == 19
        assert inv.count(COLLECTIVE_OPS) == 19
        assert inv.count(HOST_SYNC_OPS) == 0
        assert inv.count(KERNEL_OPS) == 9        # 8 advances, 1 binning
        assert _case_rules(case, inv.folded(), clock) == []
    # every rank records the same ops
    assert all(inv.histogram() == case.ranks[0][0].histogram()
               for inv, _ in case.ranks)


# ==========================================================================
# the CLI against the committed baseline
# ==========================================================================

def test_simlint_cli_checks_against_committed_baseline(tmp_path):
    """``simlint --device cpu --check`` on a subset of cases (the rebuild
    sentinel included, in its spawned process) exits 0 against the
    committed baseline, and the baseline names this torch."""
    base = ROOT / "src" / "repro_torch" / "analysis" / "baseline.json"
    committed = rules.load_baseline(base)
    assert set(matrix.case_names()) <= set(committed["cases"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.simlint", "--device",
         "cpu", "--check", str(base), "--configs",
         "policy_round_robin,trace_on", "--out",
         str(tmp_path / "report.json")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    report = json.loads((tmp_path / "report.json").read_text())
    assert set(report["cases"]) == {"policy_round_robin", "trace_on"}
    assert report["rebuild"]["violations"] == []
    assert report["footprints"]["farm_65536"]["total_bytes"] == 13_152_130
    if committed["torch"] == torch.__version__:
        assert "advisory" not in out.stdout
