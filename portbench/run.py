"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (``workloads/<cell>.json``) names its configuration, its
traffic mix, the driver that puts the mix to the program (``drivers/``),
the plan, the chips and the limits of the comparison. The run sets the
program up from the seed, warms up the shapes its traffic uses, measures
for ``--seconds``, checks a sample of what the window produced against the
plain reference, and prints as its last line one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, each from its reader under
``metrics/``), ``device`` and, last, ``checks`` (each number compared
beside its limit). It exits non-zero, printing no result, where there is
no card or too few, and where JAX or the JAX package was loaded, in this
process or in a rank process it started.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def _device_facts(t, device) -> dict:
    import torch

    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(t["chips"]),
           "memory_peak_bytes": int(t["peak_bytes"])}
    if t.get("traced"):
        out["busy_s"] = t["busy_s"]
        out["window_s"] = t["traced_window_s"]
    return out


def context_for_readers(res: dict, ctx, chips: int, kind: str) -> dict:
    """The facts every metric reader reads, ``res`` with the traced
    stretch's per-card summaries merged."""
    from portbench import flops

    t = dict(res)
    t["chips"] = chips
    t["model"] = ctx.model
    t["peaks"] = flops.peaks(kind)
    traces = [r["trace"] for r in res.get("ranks", []) if r.get("trace")]
    t["traced"] = bool(traces)
    if traces:
        sums = [tr["summary"] for tr in traces]
        t["traces"] = traces
        t["busy_s"] = sum(s["busy_s"] for s in sums) / len(sums)
        t["traced_window_s"] = sum(s["window_s"] for s in sums) / len(sums)
    return t


def execute(ctx) -> dict:
    """Drive the cell, compare, and read its metrics: the result's fields,
    and under ``forbidden`` the forbidden modules that this process or
    any rank process had loaded once the window closed."""
    import importlib

    import torch

    from portbench import correct, harness, spec

    driver = importlib.import_module(f"portbench.drivers.{ctx.spec['driver']}")
    chips = int(ctx.spec["chips"])
    kind = (torch.cuda.get_device_name(ctx.device)
            if ctx.device.type == "cuda" else "cpu")
    res = driver.run(ctx)
    t = context_for_readers(res, ctx, chips, kind)
    device = _device_facts(t, ctx.device)
    readings, _ = res.pop("readings")()
    limits = ctx.spec["check"]["limits"]
    section = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(ctx.spec["name"], section):
        value = spec.reader(m["name"])(t)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct.verdict(readings, limits),
           "attempted": int(res["attempted"]), "failed": int(res["failed"]),
           "metrics": metrics, "device": device}
    if t["traced"]:
        s = t["traces"][0]["summary"]
        out["breakdown"] = {"device_ops": s["device_ops"],
                            "idle_gaps": s["idle_gaps"]}
    if "lateness_s" in res and res["lateness_s"]:
        late = sorted(res["lateness_s"])
        print(f"generator lateness: {len(late)} submits, median "
              f"{late[len(late) // 2]!r} s, max {late[-1]!r} s", flush=True)
    out["checks"] = correct.report(readings, limits)
    found = set(harness.forbidden_modules())
    for r in res.get("ranks", []):
        found.update(r.get("forbidden", ()))
    out["forbidden"] = sorted(found)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from portbench import harness, spec

    chips = int(spec.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    ctx = harness.new_context(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    out = execute(ctx)
    found = out.pop("forbidden")
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    from portbench import correct

    correct.print_report(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
