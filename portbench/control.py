"""The readings a cell's limits are set from, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 6

For each seed, one process runs the cell's own set-up and a short window
at the cell's own load (``--seconds``, long enough to finish its longest
requests), and reads the numbers compared on the window's sample (the
lower readings); for the control seeds it also reads them with the
reference itself in the program's place, in the precision one step below
the configuration's (float8 e4m3 products, the tower's TF32): the upper
readings. Prints one JSON line a seed and, last, the largest program
reading and the smallest control reading of each number.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def main(argv=None) -> int:
    import importlib

    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    for seed in seeds:
        ctx = harness.new_context(args.workload, seed, args.seconds, False,
                                  "cuda", harness.clock())
        driver = importlib.import_module(f"portbench.drivers.{ctx.spec['driver']}")
        t0 = harness.clock()
        res = driver.run(ctx)
        t1 = harness.clock()
        prog, ctrl = res["readings"](seed in controls)
        line = {"seed": seed, "completed": res["completed"], "program": prog,
                "control": ctrl, "run_s": t1 - t0,
                "reference_s": harness.clock() - t1}
        print(json.dumps(line), flush=True)
        for k, v in prog.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in (ctrl or {}).items():
            upper[k] = min(upper.get(k, v), v)
        del res
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
