"""Conditional generation with classifier-free guidance on a heterogeneous
cluster, on the port (reference: ``examples/conditional_generation.py``).

1.  CFG is two denoiser evaluations per fine step, combined as
    ``eps = eps_u + w * (eps_c - eps_u)`` (on the card by kernel K3); the
    schedule-level entry point is ``StadiConfig(cfg_scale=w)``.
2.  The ``stadi_guidance`` planner picks fused, split (cond and uncond on
    disjoint device groups sized by speed) or interleaved guidance.
3.  Split guidance is held to the fused-batch reference under one schedule,
    and the image to the exact CFG Origin (PSNR).
4.  ``--serve`` drains a mixed CFG / non-CFG queue through the
    ``DiffusionServingEngine``.

Runs on the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/conditional_generation_torch.py
  PYTHONPATH=src python examples/conditional_generation_torch.py \\
      --cfg-scale 4.0 --guidance split --occupancies 0.0,0.0,0.5,0.5
"""
import argparse
import dataclasses
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import patch_parallel as pp
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.pipeline import StadiConfig, StadiPipeline, resolve_device
from repro_torch.models.diffusion import dit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--occupancies", default="0.0,0.0,0.5,0.5")
    ap.add_argument("--cfg-scale", type=float, default=3.0)
    ap.add_argument("--guidance", default="none",
                    choices=["none", "fused", "split", "interleaved"],
                    help="'none' lets the stadi_guidance planner choose")
    ap.add_argument("--cond", type=int, default=7)
    ap.add_argument("--m-base", type=int, default=16)
    ap.add_argument("--m-warmup", type=int, default=4)
    ap.add_argument("--serve", action="store_true",
                    help="also drain a mixed CFG/non-CFG serving queue")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("tiny-dit").reduced()
    params = dit.nondegenerate_params(
        dit.init_params(torch.Generator(dev).manual_seed(0), cfg),
        torch.Generator(dev).manual_seed(101))
    sched = sampler_lib.linear_schedule(T=1000)
    occ = [float(x) for x in args.occupancies.split(",")]
    x_T = torch.randn((1, cfg.latent_size, cfg.latent_size, cfg.channels),
                      generator=torch.Generator(dev).manual_seed(1), device=dev)
    cond = torch.full((1,), args.cond % cfg.n_classes, dtype=torch.int64,
                      device=dev)

    # 1) the guided pipeline: one config knob turns CFG on
    config = StadiConfig.from_occupancies(
        occ, m_base=args.m_base, m_warmup=args.m_warmup,
        planner="stadi_guidance", cfg_scale=args.cfg_scale,
        guidance=args.guidance)
    pipe = StadiPipeline(cfg, params, sched, config, device=dev)
    plan = pipe.plan()
    gp = plan.guidance
    print(f"cluster speeds {config.speeds} -> guidance mode {gp.mode!r} "
          f"(scale {gp.scale})")
    if gp.mode != "fused":
        print(f"  cond devices   {gp.cond_devices}\n"
              f"  uncond devices {gp.uncond_devices}")
    print(f"  steps {plan.temporal.steps} ratios {plan.temporal.ratios} "
          f"patches {plan.patches}")
    img = pipe.generate(x_T, cond).image
    print(f"guided image {tuple(img.shape)} finite={bool(torch.isfinite(img).all())}")

    # 2) split CFG against the fused-batch CFG reference, one schedule
    if gp.mode == "split":
        fused = pp.run_schedule(
            params, cfg, sched, x_T, cond, plan.temporal, plan.patches,
            guidance=dataclasses.replace(gp, mode="fused", cond_devices=(),
                                         uncond_devices=())).image
        err = float((img - fused).abs().max())
        print(f"split vs fused-batch reference (same schedule): max |diff| "
              f"{err:.2e}")
        assert err <= 1e-5

    # 3) proximity to the exact CFG Origin (no patching, no staleness)
    origin = pp.run_origin_cfg(params, cfg, sched, x_T, cond, args.m_base,
                               args.cfg_scale)
    mse = float(((img - origin) ** 2).mean())
    psnr = 10 * math.log10(float(origin.max() - origin.min()) ** 2 / mse)
    print(f"PSNR vs fused-batch CFG Origin: {psnr:.1f} dB")

    # 4) optional: a mixed CFG / non-CFG serving queue
    if args.serve:
        from repro_torch.serving import DiffusionServingEngine
        serve_cfg = StadiConfig.from_occupancies(
            occ[:2], m_base=args.m_base, m_warmup=args.m_warmup)
        engine = DiffusionServingEngine(
            StadiPipeline(cfg, params, sched, serve_cfg, device=dev), slots=3)
        for uid in range(6):
            x = torch.randn((1, cfg.latent_size, cfg.latent_size, cfg.channels),
                            generator=torch.Generator(dev).manual_seed(10 + uid),
                            device=dev)
            engine.submit(x, uid % cfg.n_classes,
                          cfg_scale=args.cfg_scale if uid % 2 == 0 else None)
        done = engine.run_to_completion()
        guided = sum(1 for r in done if r.guided)
        print(f"served {len(done)} requests ({guided} CFG / "
              f"{len(done) - guided} plain) in {engine.stats()['rounds']} rounds")
    return psnr


if __name__ == "__main__":
    main()
