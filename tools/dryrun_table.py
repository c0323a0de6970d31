"""Tabulate the port's dry-run reports (``repro_torch.launch.dryrun``).

  python tools/dryrun_table.py [results/dryrun_torch] [--against DIR] \
      [--reference results/dryrun]

Prints a markdown table, an (arch) row and a (shape, mesh) column each:
an ok configuration's seconds of set-up + trace and its peak of live
local bytes (``temp_size_in_bytes``, GB), or the error's first words. With
``--against`` (another run's reports), two more grids, a configuration
ok in both: a rank's FLOPs over the analytic ``flops_per_device``, the
other run's -> this one's (``--reference``: beside them, the JAX
package's report of the configuration, from its ``launch/dryrun.py``),
then the peak and the collective bytes.
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


def flops_over_analytic(rep) -> float:
    """A rank's traced FLOPs over the analytic ``flops_per_device``."""
    return rep["cost_analysis"]["flops"] / rep["roofline"]["flops_per_device"]


def _gb(rep, key) -> float:
    if key == "peak":
        return rep["memory_analysis"]["temp_size_in_bytes"] / 1e9
    return rep["collective_bytes"]["total"] / 1e9


def compare(new: dict, old: dict, ref: dict = None) -> str:
    """Two grids like :func:`table`'s, a configuration ok in both runs:
    a rank's FLOPs over the analytic term, the other run's -> this run's
    (and in brackets the reference's report of the configuration, where
    ``ref`` has one), then the peak and the collective bytes, GB."""
    cols = [(s, m) for s in SHAPES for m in MESHES]
    head = ["| arch | " + " | ".join(f"{s.split('_')[0]} {m[3:]}"
                                     for s, m in cols) + " |",
            "|" + "---|" * (len(cols) + 1)]

    def grid(title, cell):
        rows = [title, ""] + head
        for arch in sorted({a for a, _, _ in new}):
            cells = []
            for s, m in cols:
                a, b = old.get((arch, s, m)), new.get((arch, s, m))
                cells.append(cell(a, b, (ref or {}).get((arch, s, m)))
                             if a and b and a["ok"] and b["ok"] else "-")
            rows.append(f"| {arch} | " + " | ".join(cells) + " |")
        return rows + [""]

    def ratio(a, b, r):
        out = f"{flops_over_analytic(a):.3g} -> {flops_over_analytic(b):.3g}"
        return out + (f" [{flops_over_analytic(r):.3g}]" if r and r["ok"] else "")

    def sizes(a, b, r):
        return "; ".join(f"{_gb(a, k):.3g} -> {_gb(b, k):.3g}"
                         for k in ("peak", "coll"))
    return "\n".join(
        grid("FLOPs a rank over the analytic flops_per_device, other run -> "
             "this run [reference]:", ratio)
        + grid("peak of live local bytes (temp_size_in_bytes); collective "
               "bytes a rank, GB, other run -> this run:", sizes))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("reports", nargs="?", default=os.path.join(
        os.path.dirname(__file__), "..", "results", "dryrun_torch"))
    ap.add_argument("--against", default=None,
                    help="another run's reports, compared config by config")
    ap.add_argument("--reference", default=None,
                    help="the JAX package's reports (results/dryrun), beside "
                         "the FLOPs with --against")
    args = ap.parse_args(argv)
    reps = load(args.reports)
    print(table(reps))
    if args.against:
        print()
        print(compare(reps, load(args.against),
                      load(args.reference) if args.reference else None))


if __name__ == "__main__":
    main()
