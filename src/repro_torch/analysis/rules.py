"""Declarative rules over op inventories, diffed against a committed
baseline; a copy of ``repro.analysis.rules`` with ops in place of
primitives.

A rule is a named check over one recorded call.  Violations carry the rule
name and the offending op's source line, so a failure reads::

    [cheap-core-scatter-free] policy_load_balance: 31 op(s) of [...] in
    region 'cheap_core', expected exactly 30
        at aten.scatter_add at repro_torch/core/engine.py:352 (...)

The baseline (``analysis/baseline.json``) pins the exact counts the
current engine earns; ``NoNewOps`` also pins the full per-region op
histogram, so any structural drift is loud.  Intentional drift is recorded
as a waiver ``{config, region, op, reason}`` (``"*"`` wildcards allowed)
rather than by regenerating the baseline silently.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from ..core import regions
from . import graph_audit
from .graph_audit import as_opset


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    config: str
    message: str
    sites: tuple = ()  # source locations backing the message

    def render(self) -> str:
        lines = [f"[{self.rule}] {self.config}: {self.message}"]
        lines += [f"    at {s}" for s in self.sites]
        return "\n".join(lines)


class Rule:
    """Base: ``check(config_name, inventory, baseline_entry) ->
    [Violation]``."""

    def check(self, config, inv, baseline_entry):
        raise NotImplementedError


def _where(region) -> str:
    return f" in region '{region}'" if region else ""


@dataclasses.dataclass
class ForbidOp(Rule):
    """Named ops must not appear (optionally only within a region)."""

    name: str
    ops: object                       # OpSet, set of names or one name
    region: Optional[str] = None
    why: str = ""

    def check(self, config, inv, baseline_entry):
        sites = inv.sites_of(self.ops, self.region)
        if not sites:
            return []
        found = sorted({s.op for s in sites})
        return [Violation(
            rule=self.name, config=config,
            message=(f"{len(sites)} forbidden op(s) {found}"
                     f"{_where(self.region)}"
                     + (f" — {self.why}" if self.why else "")),
            sites=tuple(f"{s.op} at {s.src}" for s in sites[:8]))]


@dataclasses.dataclass
class ExactCount(Rule):
    """An op set must appear exactly ``expect`` times.

    ``expect`` may be an int, or the name of a baseline field to read the
    pinned count from (so budgets live in the baseline, not in code).
    """

    name: str
    ops: object
    expect: object                    # int | str (baseline field)
    region: Optional[str] = None
    why: str = ""

    def check(self, config, inv, baseline_entry):
        expect = self.expect
        if isinstance(expect, str):
            if baseline_entry is None or expect not in baseline_entry:
                return [Violation(
                    rule=self.name, config=config,
                    message=f"baseline field '{expect}' missing — run "
                            f"--update")]
            expect = baseline_entry[expect]
        got = inv.count(self.ops, self.region)
        if got == expect:
            return []
        sites = inv.sites_of(self.ops, self.region)
        return [Violation(
            rule=self.name, config=config,
            message=(f"{got} op(s) of {list(as_opset(self.ops))}"
                     f"{_where(self.region)}, expected exactly {expect}"
                     + (f" — {self.why}" if self.why else "")),
            sites=tuple(f"{s.op} at {s.src}" for s in sites[:8]))]


@dataclasses.dataclass
class DtypePolicy(Rule):
    """Clock discipline: declared time leaves keep ``time_dtype`` end to
    end, and no time value is rebuilt from a lossy downcast outside the
    declared ``f32_domain`` regions."""

    name: str = "clock-dtype-policy"

    def check_clock(self, config, report):
        out = []
        for leaf, where, dtype in report.census_violations:
            out.append(Violation(
                rule=self.name, config=config,
                message=(f"time leaf '{leaf}' ({where}) has dtype {dtype},"
                         f" policy requires {report.time_dtype}")))
        for leaf, site in report.degraded_leaves:
            out.append(Violation(
                rule=self.name, config=config,
                message=(f"time leaf '{leaf}' reconstructed from a value"
                         f" downcast below {report.time_dtype} outside"
                         f" '{regions.F32_DOMAIN}'"),
                sites=(f"downcast at {site}",)))
        return out

    def check(self, config, inv, baseline_entry):
        return []  # clock checks run via check_clock with a ClockReport


@dataclasses.dataclass
class NoNewOps(Rule):
    """The per-region op histogram must match the committed baseline
    exactly, modulo explicit waivers."""

    name: str = "no-new-ops"
    advisory: bool = False  # demoted when the torch version drifted

    def check(self, config, inv, baseline_entry):
        if baseline_entry is None or "histogram" not in baseline_entry:
            return [Violation(
                rule=self.name, config=config,
                message="no committed histogram for this config — run "
                        "--update")]
        want = baseline_entry["histogram"]
        got = inv.histogram()
        waivers = baseline_entry.get("waivers", [])
        out = []
        for region in sorted(set(want) | set(got)):
            wh = want.get(region, {})
            gh = got.get(region, {})
            for op in sorted(set(wh) | set(gh)):
                w, g = wh.get(op, 0), gh.get(op, 0)
                if w == g or _waived(waivers, config, region, op):
                    continue
                sites = [s for s in inv.sites_of(op)
                         if s.region == region][:4]
                out.append(Violation(
                    rule=self.name, config=config,
                    message=(f"region '{region or '<outer>'}': {op} count"
                             f" {g} != baseline {w}"
                             + (" (advisory: torch version drift)"
                                if self.advisory else "")),
                    sites=tuple(f"{s.op} at {s.src}" for s in sites)))
        return out


def _waived(waivers, config, region, op) -> bool:
    def hit(pat, val):
        return pat == "*" or pat == val

    return any(hit(w.get("config", "*"), config)
               and hit(w.get("region", "*"), region)
               and hit(w.get("op", "*"), op)
               for w in waivers)


# ==========================================================================
# baseline file handling
# ==========================================================================

def load_baseline(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def save_baseline(path, baseline: dict) -> None:
    with open(path, "w") as fh:
        json.dump(baseline, fh, indent=2, sort_keys=True)
        fh.write("\n")


def baseline_entry_from(inv) -> dict:
    """Build the committed entry for one config from its (folded)
    inventory."""
    return {
        "histogram": inv.histogram(),
        "scatter_cheap_core": inv.count(graph_audit.SCATTER_OPS,
                                        regions.CHEAP_CORE),
        "scatter_total": inv.count(graph_audit.SCATTER_OPS),
        "ops": inv.n_ops,
        "waivers": [],
    }


def merge_baseline_entry(old: Optional[dict], new: dict) -> dict:
    """Regenerate counts but keep hand-written waivers."""
    if old and old.get("waivers"):
        new = dict(new)
        new["waivers"] = old["waivers"]
    return new


__all__ = ["Violation", "Rule", "ForbidOp", "ExactCount", "DtypePolicy",
           "NoNewOps", "load_baseline", "save_baseline",
           "baseline_entry_from", "merge_baseline_entry"]
