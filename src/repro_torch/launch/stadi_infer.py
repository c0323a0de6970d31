"""STADI inference driver of the port (reference: ``repro.launch.stadi_infer``).

Thin CLI over :class:`repro_torch.core.pipeline.StadiPipeline`; strategy
selection is ``--planner`` (uniform / spatial / temporal / stadi / makespan /
stadi_guidance) and ``--backend`` (emulated / simulate); ``--cfg-scale``
turns on classifier-free guidance. It runs on the GPU unless ``--device
cpu`` is given. Weights are random (``--seed``), as in the reference driver.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.stadi_infer --arch sdxl-dit \
      --occupancies 0.0,0.5 --m-base 16 --m-warmup 4 [--cfg-scale 4.0]
"""
from __future__ import annotations

import argparse
import json
import time

#: reference flags and choices that later slices of the port bring
_LATER_FLAGS = {
    "--spmd": "the multi-GPU slice (queue 1 item 7)",
    "--check-vs-emulation": "the multi-GPU slice (queue 1 item 7)",
    "--num-stages": "the pipefuse slice (queue 1 item 10)",
    "--micro-patches": "the pipefuse slice (queue 1 item 10)",
    "--seq-shards": "the sequence-parallel slice (queue 1 item 11)",
    "--num-frames": "the frames slice (queue 1 item 12)",
    "--frame-groups": "the frames slice (queue 1 item 12)",
    "--prompt": "the prompt-conditioning slice (queue 1 item 13)",
    "--cond-tokens": "the prompt-conditioning slice (queue 1 item 13)",
    "--cond-seq-len": "the prompt-conditioning slice (queue 1 item 13)",
    "--use-pallas": "no slice: on the port the device picks the kernel path",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--occupancies", default="0.0,0.6")
    ap.add_argument("--capabilities", default=None)
    ap.add_argument("--m-base", type=int, default=16)
    ap.add_argument("--m-warmup", type=int, default=4)
    ap.add_argument("--a", type=float, default=0.75)
    ap.add_argument("--b", type=float, default=0.25)
    ap.add_argument("--arch", default="tiny-dit", choices=["tiny-dit", "sdxl-dit"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--planner", default="stadi",
                    choices=["uniform", "spatial", "temporal", "stadi",
                             "makespan", "stadi_guidance"])
    ap.add_argument("--backend", default="emulated",
                    choices=["emulated", "simulate"])
    ap.add_argument("--cond", type=int, default=0,
                    help="class id to condition on")
    ap.add_argument("--cfg-scale", type=float, default=0.0,
                    help="classifier-free guidance weight w (DESIGN.md "
                         "§12): 0 = unguided; > 0 runs CFG "
                         "(eps_u + w*(eps_c - eps_u))")
    ap.add_argument("--guidance", default="none",
                    choices=["none", "fused", "split", "interleaved"],
                    help="CFG placement: fused-batch on every worker, "
                         "split cond/uncond device groups, or interleaved "
                         "uncond reuse; split/interleaved need "
                         "--planner stadi_guidance ('none' + --cfg-scale "
                         "lets stadi_guidance auto-search)")
    ap.add_argument("--uncond-refresh", type=int, default=2,
                    help="interleaved guidance: recompute the uncond "
                         "branch every E adaptive intervals")
    ap.add_argument("--rebalance-every", type=int, default=0)
    ap.add_argument("--exchange", default="sync",
                    choices=["sync", "stale_async", "predictive"],
                    help="boundary-exchange policy (DESIGN.md §10)")
    ap.add_argument("--exchange-refresh", type=int, default=2,
                    help="full refresh every E boundaries (stale/predictive)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the numerics run; 'cpu' takes the kernels' "
                         "plain versions")
    return ap


def main(argv=None):
    ap = _parser()
    args, rest = ap.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in _LATER_FLAGS:
            ap.error(f"{flag} is not ported yet: it comes with "
                     f"{_LATER_FLAGS[flag]} of ROADMAP.md")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import sampler as sampler_lib
    from repro_torch.core.pipeline import (StadiConfig, StadiPipeline,
                                           resolve_device)
    from repro_torch.core.simulate import CostModel
    from repro_torch.models.diffusion import dit

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = dit.init_params(
        torch.Generator(device=device).manual_seed(args.seed), cfg)
    sched = sampler_lib.linear_schedule(T=1000)
    shape = (args.batch, cfg.latent_size, cfg.latent_size, cfg.channels)
    x_T = torch.randn(shape, device=device,
                      generator=torch.Generator(device=device)
                      .manual_seed(args.seed + 1)).to(dit._torch_dtype(cfg.dtype))
    cond = torch.full((args.batch,), args.cond % cfg.n_classes,
                      dtype=torch.int64, device=device)

    knobs = {}
    if args.backend == "simulate":
        # nominal per-step cost model (not a measurement of any device)
        knobs["cost_model"] = CostModel(t_fixed=1e-3, t_row=5e-4)
    if args.planner == "makespan":
        knobs["tiers"] = (1, 2, 4)        # generalized ratios (DESIGN.md §7)
    occ = [float(x) for x in args.occupancies.split(",")]
    caps = ([float(x) for x in args.capabilities.split(",")]
            if args.capabilities else None)
    config = StadiConfig.from_occupancies(
        occ, caps, m_base=args.m_base, m_warmup=args.m_warmup,
        a=args.a, b=args.b, planner=args.planner, backend=args.backend,
        rebalance_every=args.rebalance_every, exchange=args.exchange,
        exchange_refresh=args.exchange_refresh, guidance=args.guidance,
        cfg_scale=args.cfg_scale, uncond_refresh=args.uncond_refresh,
        **knobs)
    pipe = StadiPipeline(cfg, params, sched, config, device=device)
    plan = pipe.plan()
    print(f"speeds={config.speeds} steps={plan.temporal.steps} "
          f"ratios={plan.temporal.ratios} patches={plan.patches} "
          f"guidance={plan.guidance}")

    if device.type == "cuda":
        from repro_torch.kernels import ops
        ops.load_library()                 # build the kernels outside the timing
    t0 = time.perf_counter()
    res = pipe.generate(x_T, cond)
    summary = {"patches": plan.patches, "steps": plan.temporal.steps,
               "planner": args.planner, "backend": args.backend,
               "device": str(device)}
    if res.image is None:                  # trace-only backend
        print(f"{args.backend} run: modeled latency {res.latency_s:.6f}s")
        print(json.dumps({**summary, "latency_s": res.latency_s}))
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    finite = bool(torch.isfinite(res.image).all())
    print(f"{args.backend} run on {device}: {seconds:.2f}s image "
          f"{tuple(res.image.shape)} finite={finite} "
          f"kernel_stats={json.dumps(res.kernel_stats, sort_keys=True)}")
    print(json.dumps({**summary, "finite": finite}))


if __name__ == "__main__":
    main()
