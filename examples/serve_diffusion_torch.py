"""Serve a queue of diffusion requests with continuous batching on the
port (reference: ``examples/serve_diffusion.py``).

Builds a :class:`StadiPipeline` for a 2-device heterogeneous cluster,
wraps it in a :class:`DiffusionServingEngine` with a fixed number of slots,
submits requests in two waves (the second admitted mid-flight), drains the
queue and prints each request's queueing / service rounds, modeled cluster
latency and SLO verdict. Request 0's image is held to a lone
``pipe.generate``: a lane group runs as one batched forward, so the two
agree to rounding (the port's bar is 1e-5), bitwise where the batch does
not change the arithmetic. Runs on the GPU unless ``--device cpu`` is
given.

  PYTHONPATH=src python examples/serve_diffusion_torch.py
  PYTHONPATH=src python examples/serve_diffusion_torch.py --requests 10 \\
      --slots 4 --occupancies 0.0,0.55 --slo-ms 150
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.pipeline import StadiConfig, StadiPipeline, resolve_device
from repro_torch.models.diffusion import dit
from repro_torch.serving import DiffusionServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--occupancies", default="0.0,0.55")
    ap.add_argument("--m-base", type=int, default=16)
    ap.add_argument("--m-warmup", type=int, default=4)
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("tiny-dit").reduced()
    params = dit.init_params(torch.Generator(dev).manual_seed(0), cfg)
    sched = sampler_lib.linear_schedule(T=1000)
    occ = [float(x) for x in args.occupancies.split(",")]
    config = StadiConfig.from_occupancies(occ, m_base=args.m_base,
                                          m_warmup=args.m_warmup)
    pipe = StadiPipeline(cfg, params, sched, config, device=dev)
    engine = DiffusionServingEngine(pipe, slots=args.slots)
    print(f"cluster speeds {config.speeds} -> steps "
          f"{engine.plan.temporal.steps}, patches {engine.plan.patches}")

    rng = np.random.default_rng(0)
    xs = [torch.randn((1, cfg.latent_size, cfg.latent_size, cfg.channels),
                      generator=torch.Generator(dev).manual_seed(1 + i),
                      device=dev) for i in range(args.requests)]
    conds = [int(c) for c in rng.integers(0, cfg.n_classes, args.requests)]
    slo_s = args.slo_ms / 1e3 if args.slo_ms is not None else None

    # wave 1 fills the slots; wave 2 queues and is admitted mid-flight
    wave1 = args.requests // 2
    for i in range(wave1):
        engine.submit(xs[i], conds[i], slo_s=slo_s)
    engine.step()
    engine.step()
    for i in range(wave1, args.requests):
        engine.submit(xs[i], conds[i], slo_s=slo_s)
    done = engine.run_to_completion()

    stats = engine.stats()
    print("\nuid  queued  served  modeled-latency  slo")
    for r in stats["requests"]:
        slo = {None: "-", True: "met", False: "MISSED"}[r["slo_met"]]
        print(f"{r['uid']:3d}  {r['queue_rounds']:6d}  "
              f"{r['service_rounds']:6d}  {r['modeled_latency_s']*1e3:13.1f}ms"
              f"  {slo}")
    print(f"\nthroughput: {stats['throughput_wall_rps']:.2f} img/s wall / "
          f"{stats['throughput_modeled_rps']:.2f} img/s modeled over "
          f"{stats['rounds']} rounds")

    ref = pipe.generate(xs[0], torch.tensor([conds[0]], device=dev))
    req0 = next(r for r in done if r.uid == 0)
    err = float((req0.image - ref.image).abs().max())
    print(f"request 0 vs single-request generate: max |diff| {err:.2e}")
    assert err <= 1e-5, "serving changed numerics!"
    return done


if __name__ == "__main__":
    main()
