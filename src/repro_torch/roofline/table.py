"""Aggregate dry-run JSONs into the EXPERIMENTS.md roofline table (the
port's copy of ``repro.roofline.table``, pinned to it by
tests/test_torch_roofline.py)."""
from __future__ import annotations

import json
import pathlib
import sys


def load(dir_="results/dryrun", tag=""):
    rows = []
    for p in sorted(pathlib.Path(dir_).glob("*.json")):
        d = json.loads(p.read_text())
        if "error" in d or d.get("tag", "") != tag:
            continue
        rows.append(d)
    return rows


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def markdown(rows, mesh_filter=None):
    hdr = ("| arch | shape | mesh | compute | memory | collective | "
           "dominant | step est | useful FLOP | roofline frac | GB/dev |")
    sep = "|" + "---|" * 11
    out = [hdr, sep]
    for d in rows:
        mesh = "multipod" if "pod" in d["mesh"] else "pod"
        if mesh_filter and mesh != mesh_filter:
            continue
        out.append(
            f"| {d['arch']} | {d['shape']} | {mesh} "
            f"| {fmt_s(d['t_compute'])} | {fmt_s(d['t_memory'])} "
            f"| {fmt_s(d['t_collective'])} "
            f"| {d['dominant'].replace('t_', '')} "
            f"| {fmt_s(d['step_time_est'])} "
            f"| {d['useful_flop_ratio']:.2f} "
            f"| {d['roofline_fraction']:.3f} "
            f"| {d['bytes_per_device']/1e9:.1f} |")
    return "\n".join(out)


def main():
    rows = load(*(sys.argv[1:2] or ["results/dryrun"]))
    print(markdown(rows))
    print()
    # worst cells by roofline fraction (train/prefill only — decode is
    # inherently memory-bound)
    interesting = [r for r in rows if r["kind"] != "decode"
                   and "pod" not in str(r["mesh"].get("pod", ""))]
    interesting = sorted(rows, key=lambda r: r["roofline_fraction"])
    print("lowest roofline fraction cells:")
    for r in interesting[:6]:
        print(f"  {r['arch']} {r['shape']} {r['mesh']} "
              f"frac={r['roofline_fraction']:.3f} dom={r['dominant']}")
    coll = sorted(rows, key=lambda r: -(r["t_collective"] /
                                        max(r["step_time_est"], 1e-30)))
    print("most collective-bound cells:")
    for r in coll[:6]:
        print(f"  {r['arch']} {r['shape']} {r['mesh']} "
              f"coll_share={r['t_collective']/max(r['step_time_est'],1e-30):.2f}")


if __name__ == "__main__":
    main()
