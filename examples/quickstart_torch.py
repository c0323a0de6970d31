"""Quickstart on the PyTorch/CUDA port: STADI in ~40 lines (reference:
``examples/quickstart.py``).

One config object, one pipeline, one call: plans steps (Eq. 4) + patches
(Eq. 5) for a heterogeneous 2-"GPU" cluster, runs the exact-numerics engine
on a tiny DiT, and compares the result against non-distributed DDIM. Runs
on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import patch_parallel, sampler
from repro_torch.core.pipeline import StadiConfig, StadiPipeline, resolve_device
from repro_torch.models.diffusion import dit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m-base", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a heterogeneous cluster: device 1 is 60%-occupied by background work
    config = StadiConfig.from_occupancies([0.0, 0.6], m_base=args.m_base,
                                          m_warmup=4, planner="stadi",
                                          backend="emulated")
    print(f"effective speeds: {config.speeds}")

    # 2. a small denoiser + schedule, on the device
    cfg = get_config("tiny-dit").reduced()
    params = dit.init_params(torch.Generator(dev).manual_seed(0), cfg)
    sched = sampler.linear_schedule(T=1000)
    x_T = torch.randn((1, cfg.latent_size, cfg.latent_size, cfg.channels),
                      generator=torch.Generator(dev).manual_seed(1), device=dev)
    cond = torch.tensor([3], device=dev)

    # 3. STADI: temporal + spatial adaptation (Algorithm 1) in one call
    pipe = StadiPipeline(cfg, params, sched, config, device=dev)
    result = pipe.generate(x_T, cond)
    print(f"steps per device:   {result.plan.temporal.steps}")
    print(f"patch rows per dev: {result.plan.patches}")

    # 4. compare with the non-distributed Origin trajectory
    origin = patch_parallel.run_origin(params, cfg, sched, x_T, cond,
                                       m_base=args.m_base)
    rel = float(torch.linalg.norm(result.image - origin)
                / torch.linalg.norm(origin))
    print(f"relative deviation from Origin: {rel:.4f} (stale-KV + mixed-rate)")
    assert bool(torch.isfinite(result.image).all())
    print("ok")
    return rel


if __name__ == "__main__":
    main()
