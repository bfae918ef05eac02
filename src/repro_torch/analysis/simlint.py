"""``python -m repro_torch.analysis.simlint`` -- record the audit matrix,
write a JSON report, and diff it against the committed baseline.

Usage::

    python -m repro_torch.analysis.simlint --device cpu \\
        --check src/repro_torch/analysis/baseline.json
    python -m repro_torch.analysis.simlint --device cpu \\
        --update src/repro_torch/analysis/baseline.json
    python -m repro_torch.analysis.simlint --configs trace_on,sharded_d1

``--check`` exits non-zero on any violation (rule name and source line
are printed); ``--update`` regenerates the pinned counts while keeping
hand-written waivers.  Without ``--device cpu`` the matrix is recorded on
the card.  ``sharded_d2`` spawns two gloo ranks on the CPU, and
``sharded_d8`` (eight) runs only when ``--configs`` names it.  The rebuild
sentinel runs in a spawned process of its own, so that its kernel loads
are that process's first; ``--no-rebuild`` skips it.

The baseline records the torch version it was made with; under another
version a histogram's drift (``no-new-ops``) is advisory, as the
reference treats its jax version.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import costmodel, graph_audit, matrix, recompile, rules
from .graph_audit import (ALL_GATHER_OPS, ANY_OP, COLLECTIVE_OPS,
                          HOST_SYNC_OPS, KERNEL_OPS, SCATTER_OPS)
from ..core.regions import CHEAP_CORE, THERMAL, TRACE

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def rules_for(case, baseline_entry, advisory):
    """The named rule set one case's folded inventory must satisfy."""
    rs = [
        rules.ForbidOp(
            name="no-host-sync-in-step", ops=HOST_SYNC_OPS,
            why="a host read stalls the device loop and breaks a CUDA "
                "graph of the step"),
        rules.ExactCount(
            name="cheap-core-scatter-free", ops=SCATTER_OPS,
            region=CHEAP_CORE, expect="scatter_cheap_core",
            why="the cheap-core scatter budget is pinned and must not "
                "grow"),
        rules.NoNewOps(advisory=advisory),
    ]
    if case.kind == "sharded":
        rs.append(rules.ExactCount(
            name="one-all-gather-per-sharded-leaf", ops=ALL_GATHER_OPS,
            expect=case.n_sharded,
            why="the macro-step's whole collective phase is the "
                "top-of-step gather"))
        rs.append(rules.ForbidOp(
            name="no-other-collectives", ops=COLLECTIVE_OPS - ALL_GATHER_OPS,
            why="any second collective kind per step breaks the thin "
                "collective-phase contract"))
    else:
        rs.append(rules.ForbidOp(
            name="no-collectives-single-device", ops=COLLECTIVE_OPS,
            why="the unsharded engine must stay communication-free"))
    if not case.thermal_on:
        rs.append(rules.ForbidOp(
            name="thermal-off-statically-absent",
            ops={"aten.exp", "aten.cos", "aten.sin"},
            why="disabled thermal must contribute zero ops "
                "(transcendentals are its static signature)"))
        rs.append(rules.ForbidOp(
            name="thermal-off-statically-absent", ops=ANY_OP,
            region=THERMAL, why="disabled thermal must run no op"))
    if not case.trace_on:
        rs.append(rules.ForbidOp(
            name="trace-off-statically-absent", ops=ANY_OP, region=TRACE,
            why="a disabled flight recorder must run no op"))
    return rs


def kernels_single_nodes(config, inv, launched: dict) -> list:
    """``kernels-are-single-nodes``, on a card recording: each
    ``repro_torch::`` op appears exactly as often as its kernel launched
    (``launched``: {op name: launches during the recording}), and no op of
    a plain version was recorded."""
    out = []
    got = {}
    for s in inv.sites_of(KERNEL_OPS):
        got[s.op] = got.get(s.op, 0) + 1
    for op in sorted(set(got) | set(launched)):
        if got.get(op, 0) != launched.get(op, 0):
            out.append(rules.Violation(
                rule="kernels-are-single-nodes", config=config,
                message=f"{op}: {got.get(op, 0)} op node(s), "
                        f"{launched.get(op, 0)} launch(es)"))
    plain = [s for s in inv.sites if s.folded_away]
    if plain:
        out.append(rules.Violation(
            rule="kernels-are-single-nodes", config=config,
            message=f"{len(plain)} op(s) of a kernel's plain version on "
                    f"the card",
            sites=tuple(f"{s.op} at {s.src}" for s in plain[:8])))
    return out


def record_case(case):
    """[(rank, folded Inventory, full Inventory, ClockReport, launches)] of
    a case (one entry unless it is sharded), the engine step recorded once
    on a fresh state; ``launches`` ({op name: kernel launches during the
    recording}) is None for the spawned ranks."""
    from ..kernels import ops
    if case.kind == "sharded":
        return [(r, inv.folded(), inv, clock, None)
                for r, (inv, clock) in enumerate(case.ranks)]
    before = ops.launch_counts()
    inv, clock = graph_audit.audit(case.step, case.fresh(), case.time_dtype)
    launches = {ops.OPS[k]: n - before[k]
                for k, n in ops.launch_counts().items() if n > before[k]}
    return [(0, inv.folded(), inv, clock, launches)]


def audit_case(case, baseline_entry, advisory, on_card=False):
    """(violations, report, folded inventory of rank 0) of one case;
    ``on_card`` adds ``kernels-are-single-nodes``."""
    violations, report = [], {}
    for rank, folded, full, clock, launches in record_case(case):
        tag = case.name if rank == 0 else f"{case.name} rank {rank}"
        for rule in rules_for(case, baseline_entry, advisory):
            # host syncs count in a plain version's ops too
            inv = full if rule.name == "no-host-sync-in-step" else folded
            violations.extend(rule.check(tag, inv, baseline_entry))
        violations.extend(rules.DtypePolicy().check_clock(tag, clock))
        if on_card and launches is not None:
            violations.extend(kernels_single_nodes(tag, full, launches))
        if rank == 0:
            first = folded
            report = {
                "summary": folded.summary(),
                "cost": costmodel.cost_of(folded).to_json(),
                "clock": {
                    "time_dtype": clock.time_dtype,
                    "out_census": clock.out_census,
                    "degraded_leaves": clock.degraded_leaves,
                    # time-derived values exiting to lower precision
                    # outside f32_domain (benign while degraded_leaves is
                    # empty: they feed physics, not clocks)
                    "time_downcast_sites": clock.downcast_sites,
                },
            }
    if case.n_sharded is not None:
        report["n_sharded_leaves"] = case.n_sharded
    report["violations"] = [v.render() for v in violations]
    return violations, report, first


# what each device's runs must build (once): on the card both engine
# kernels' libraries and the advance's scratch; on the CPU nothing
EXPECTED_BUILDS = {"cuda": ("build.load", "dcsim_step.scratch"), "cpu": ()}


def rebuild_check(device):
    """The rebuild sentinel in a spawned process: any key built twice is a
    ``no-rebuild`` violation, and an expected tag that never fired means
    its hook is disconnected."""
    from ..core import shard_sim

    dev = "cpu" if device == "cpu" else None
    backend = "gloo" if device == "cpu" else "nccl"
    rebuilt, events = shard_sim.spawn(recompile.simulate_twice, 1,
                                      (dev,), backend)[0]
    violations = [rules.Violation(
        rule="no-rebuild", config=hit["tag"],
        message=f"key built {hit['builds']}x -- the per-key cache "
                f"leaked: {hit['key'][:200]}") for hit in rebuilt]
    seen = {e["tag"] for e in events}
    kind = "cpu" if device == "cpu" else "cuda"
    for tag in EXPECTED_BUILDS[kind]:
        if tag not in seen:
            violations.append(rules.Violation(
                rule="no-rebuild", config="sentinel",
                message=f"sentinel saw no '{tag}' build -- the cache's "
                        f"miss count (kernels.build.MISSES) is "
                        f"disconnected"))
    return violations, {"builds": events,
                        "violations": [v.render() for v in violations]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.simlint")
    ap.add_argument("--out", default="simlint_report.json",
                    help="JSON report path")
    ap.add_argument("--check", metavar="BASELINE",
                    help="diff against a committed baseline; exit 1 on "
                         "violations")
    ap.add_argument("--update", metavar="BASELINE",
                    help="write/refresh the baseline (waivers preserved)")
    ap.add_argument("--configs", default="",
                    help="comma-separated case subset (default: the full "
                         "matrix but sharded_d8)")
    ap.add_argument("--no-rebuild", action="store_true",
                    help="skip the rebuild sentinel (it spawns a process "
                         "that runs small simulations)")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where to record (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.device == "cpu" else None
    if device is None and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to record on the CPU")

    names = matrix.case_names()
    if args.configs:
        want = args.configs.split(",")
        known = matrix.case_names(include_d8=True)
        unknown = [w for w in want if w not in known]
        if unknown:
            ap.error(f"unknown configs {unknown}; known: {known}")
        names = [n for n in known if n in want]

    baseline = {}
    if args.check:
        baseline = rules.load_baseline(args.check)
    elif args.update and os.path.exists(args.update):
        baseline = rules.load_baseline(args.update)
    baseline_cases = baseline.get("cases", {})
    advisory = bool(baseline) and baseline.get("torch") != torch.__version__
    if advisory:
        print(f"note: baseline torch {baseline.get('torch')} != runtime "
              f"{torch.__version__}; histogram drift demoted to advisory")

    report = {"torch": torch.__version__, "device": args.device or "cuda",
              "cases": {}}
    new_cases, all_violations = {}, []
    for name in names:
        case = matrix.build_case(name, device)
        violations, case_report, inv = audit_case(
            case, baseline_cases.get(name), advisory, device is None)
        report["cases"][name] = case_report
        new_cases[name] = rules.merge_baseline_entry(
            baseline_cases.get(name), rules.baseline_entry_from(inv))
        all_violations.extend(violations)
        s = case_report["summary"]
        print(f"{name:<26} ops={s['ops']:<5} scatter={s['scatter']:<4} "
              f"(cheap_core={s['scatter_cheap_core']}) "
              f"collectives={sum(s['collectives'].values())} "
              f"host_syncs={s['host_syncs']} violations={len(violations)}")

    if not args.no_rebuild:
        rebuild_violations, rebuild_report = rebuild_check(device)
        report["rebuild"] = rebuild_report
        all_violations.extend(rebuild_violations)
        print(f"{'rebuild-sentinel':<26} "
              f"builds={len(rebuild_report['builds'])} "
              f"violations={len(rebuild_violations)}")

    footprints = {label: matrix.footprint_of(cfg)
                  for label, cfg in matrix.state_footprint_cases().items()}
    report["footprints"] = footprints
    print("\nstate footprint (HBM budget):")
    print(costmodel.footprint_table(footprints))
    print("\nlargest fields, farm_65536:")
    print(costmodel.field_table(footprints["farm_65536"]))

    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
    print(f"\nreport written to {args.out}")

    if args.update:
        rules.save_baseline(args.update, {"torch": torch.__version__,
                                          "cases": new_cases})
        print(f"baseline written to {args.update}")
        return 0

    hard = [v for v in all_violations
            if not (advisory and v.rule == "no-new-ops")]
    if all_violations:
        print(f"\n{len(all_violations)} violation(s):")
        for v in all_violations:
            print(v.render())
    if args.check:
        missing = [n for n in names if n not in baseline_cases]
        if missing:
            print(f"\nno baseline entry for {missing} -- run --update")
            return 1
        return 1 if hard else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
