"""Tabulate the port's dry-run reports (``repro_torch.launch.dryrun``).

  python tools/dryrun_table.py [results/dryrun_torch] [--against DIR]

Prints a markdown table, an (arch) row and a (shape, mesh) column each:
an ok configuration's seconds of set-up + trace and its peak of live
local bytes (``temp_size_in_bytes``, GB), or the error's first words. With
``--against`` (another run's reports), one line a configuration ok in
both: FLOPs a rank, collective counts and output bytes, the other run's
beside this one's.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("pod16x16", "pod2x16x16")


def load(directory: str) -> dict:
    out = {}
    for path in glob.glob(os.path.join(directory, "*.json")):
        rep = json.load(open(path))
        out[(rep["arch"], rep["shape"], rep["mesh"])] = rep
    return out


def cell(rep) -> str:
    if rep is None:
        return "-"
    if not rep["ok"]:
        return f"fail {rep.get('seconds')} s: {rep['error'][:40]}"
    temp = rep["memory_analysis"]["temp_size_in_bytes"]
    peak = "no peak" if temp is None else f"{temp / 1e9:.3g}"
    return f"{rep['lower_s'] + rep['compile_s']:.1f}, {peak}"


def table(reps: dict) -> str:
    cols = [(s, m) for s in SHAPES for m in MESHES]
    head = "| arch | " + " | ".join(f"{s.split('_')[0]} {m[3:]}" for s, m in cols) + " |"
    rows = [head, "|" + "---|" * (len(cols) + 1)]
    for arch in sorted({a for a, _, _ in reps}):
        rows.append(f"| {arch} | " + " | ".join(
            cell(reps.get((arch, s, m))) for s, m in cols) + " |")
    n_ok = sum(r["ok"] for r in reps.values())
    rows.append(f"\n{n_ok} of {len(reps)} ok")
    return "\n".join(rows)


def compare(new: dict, old: dict) -> str:
    lines = ["| config | FLOPs a rank | collectives (ag/ar/rs/a2a) | output bytes |",
             "|---|---|---|---|"]
    keys = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
    for k in sorted(new):
        a, b = old.get(k), new[k]
        if not (a and a["ok"] and b["ok"]):
            continue
        ca = "/".join(str(a["collective_counts"][c]) for c in keys)
        cb = "/".join(str(b["collective_counts"][c]) for c in keys)
        lines.append(
            f"| {' '.join(k)} | {a['cost_analysis']['flops']:.4g} -> "
            f"{b['cost_analysis']['flops']:.4g} | {ca} -> {cb} | "
            f"{a['memory_analysis']['output_size_in_bytes']} -> "
            f"{b['memory_analysis']['output_size_in_bytes']} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("reports", nargs="?", default=os.path.join(
        os.path.dirname(__file__), "..", "results", "dryrun_torch"))
    ap.add_argument("--against", default=None,
                    help="another run's reports, compared config by config")
    args = ap.parse_args(argv)
    reps = load(args.reports)
    print(table(reps))
    if args.against:
        print()
        print(compare(reps, load(args.against)))


if __name__ == "__main__":
    main()
