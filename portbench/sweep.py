"""Find the knee of an open-loop serving cell: the highest arrival rate
the engine sustains without a growing backlog.

    python3 portbench/sweep.py --workload sdxl-dit.serve-poisson \\
        --rates 1.5,2,2.5,3,3.5,4,5 --seconds 30 --seed 1

One process sets the cell up once (weights, pipeline, warm-up), then for
each rate runs the cell's open loop with the mix's arrival rate replaced,
each on a fresh engine: every request due in the window is waited for.
Prints one JSON line a rate: requests due, completed by the close, the
backlog (queued requests) at the close, the median and 90th percentile of
due-to-done seconds, and how late the generator ran. The cell's rate is
then written into its traffic file as a number (0.8 of the knee).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]


def main(argv=None) -> int:
    import numpy as np
    import torch

    from portbench import harness, trace, traffic, weights
    from portbench.drivers import serve

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    ctx = harness.new_context(args.workload, args.seed, args.seconds, False,
                              "cuda", T_START)
    device = ctx.device
    rates = [float(r) for r in args.rates.split(",")]
    mix0 = ctx.spec["mix"]
    n = traffic.open_loop_count(dict(mix0, rate_per_s=max(rates)),
                                args.seconds + serve.GRACE_S)
    params = weights.make(ctx.model, ctx.seed, device)
    lat = weights.latents(ctx.model, ctx.seed, n, device)
    pipe = harness.pipeline(ctx, params, device)
    serve._warm(ctx, pipe, lat, device)
    for rate in rates:
        mix = dict(mix0, rate_per_s=rate)
        reqs = traffic.requests(mix, ctx.seed, n)
        loop = serve._Loop(ctx, pipe, reqs, lat, device, trace.Spans())
        t0 = harness.clock()
        _, lats, late, due, _ = serve._open_loop(loop, args.seconds, 0)
        closed = sum(1 for k in due if k in loop.done
                     and loop.done[k][0] - t0 <= args.seconds)
        print(json.dumps({
            "rate_per_s": rate, "due": len(due), "completed_by_close": closed,
            "completed": sum(1 for k in due if k in loop.done),
            "backlog_at_close": loop.backlog_at_close,
            "p50_s": float(np.percentile(lats, 50)) if lats else None,
            "p90_s": float(np.percentile(lats, 90)) if lats else None,
            "lateness_p90_s": float(np.percentile(late, 90)) if late else None,
            "rounds": len(loop.engine.rounds)}), flush=True)
        del loop
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
