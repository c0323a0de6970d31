"""STADI inference driver of the port (reference: ``repro.launch.stadi_infer``).

Thin CLI over :class:`repro_torch.core.pipeline.StadiPipeline`; strategy
selection is ``--planner`` (uniform / spatial / temporal / stadi / makespan /
stadi_pipefuse / stadi_guidance / stadi_seq / stadi_video) and ``--backend``
(emulated / simulate / pipefuse / spmd / spmd_pipefuse / spmd_guidance /
spmd_seq / spmd_frames; ``--spmd`` is short for ``--backend spmd``);
``--num-stages`` splits the depth into a stage chain (``--micro-patches``
pins its micro-batch count), ``--cfg-scale`` turns on classifier-free
guidance, ``--seq-shards`` sequence-parallel attention and ``--num-frames``
a video of that many frames (a ``[B, F, H, W, C]`` latent; ``--frame-groups``
pins the frame placement). It runs on the GPU unless ``--device cpu`` is
given. Weights are random (``--seed``), as in the reference's CLI.

The multi-rank backends start one rank per device of the cluster,
``spmd_seq`` ``seq_shards`` ranks per patch worker, ``spmd_pipefuse`` one
rank per stage and ``spmd_frames`` one per patch-worker column of each frame
row (leftover devices idle) (:mod:`repro_torch.launch.ranks`): NCCL with one card per
rank, or gloo with ``--dist-backend gloo``, which also lets the ranks share
fewer cards (their times are then not a multi-GPU makespan); CPU ranks
always run gloo. ``--check-vs-emulation`` also runs the emulated backend
(``pipefuse`` for ``spmd_pipefuse``) in this process and holds the ranks'
image to it (relative error < 1e-3).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.stadi_infer --arch sdxl-dit \
      --occupancies 0.0,0.5 --m-base 16 --m-warmup 4 [--cfg-scale 4.0]
  PYTHONPATH=src python -m repro_torch.launch.stadi_infer --device cpu \
      --reduced --spmd --check-vs-emulation
  PYTHONPATH=src python -m repro_torch.launch.stadi_infer --device cpu \
      --reduced --seq-shards 2 --exchange ring --backend spmd_seq \
      --check-vs-emulation
  PYTHONPATH=src python -m repro_torch.launch.stadi_infer --device cpu \
      --reduced --num-stages 2 --backend spmd_pipefuse --check-vs-emulation
  PYTHONPATH=src python -m repro_torch.launch.stadi_infer --device cpu \
      --reduced --num-frames 3 --occupancies 0.0,0.0,0.5,0.5 \
      --planner stadi_video --frame-groups 2 --backend spmd_frames \
      --check-vs-emulation
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

#: reference flags and choices that later slices of the port bring
_LATER_FLAGS = {
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
                             "makespan", "stadi_pipefuse", "stadi_guidance",
                             "stadi_seq", "stadi_video"])
    ap.add_argument("--backend", default="emulated",
                    choices=["emulated", "simulate", "pipefuse", "spmd",
                             "spmd_pipefuse", "spmd_guidance", "spmd_seq",
                             "spmd_frames"])
    ap.add_argument("--spmd", action="store_true",
                    help="short for --backend spmd")
    ap.add_argument("--num-stages", type=int, default=1,
                    help="displaced stage chain (DESIGN.md §11): depth "
                         "stages for the pipefuse backends (1 = pure patch "
                         "parallelism, 0 = let stadi_pipefuse search)")
    ap.add_argument("--micro-patches", type=int, default=0,
                    help="micro-batches streaming through the stage chain "
                         "(0 = auto)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="collectives of the multi-rank backends: NCCL (the "
                         "default on CUDA, one card per rank) or gloo (CPU "
                         "ranks; on CUDA only when named, and ranks may then "
                         "share cards)")
    ap.add_argument("--check-vs-emulation", action="store_true",
                    help="multi-rank backends: also run the emulated backend "
                         "and require relative error < 1e-3")
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
                    choices=["sync", "stale_async", "predictive", "ring"],
                    help="boundary-exchange policy (DESIGN.md §10; ring: "
                         "§13)")
    ap.add_argument("--seq-shards", type=int, default=1,
                    help="sequence-parallel attention (DESIGN.md §13): "
                         "Ulysses/ring shards per patch worker (1 = off, 0 = "
                         "let --planner stadi_seq search)")
    ap.add_argument("--num-frames", type=int, default=1,
                    help="video (DESIGN.md §16): latent frames denoised "
                         "jointly (1 = image; > 1 needs a frame backend: "
                         "emulated, simulate or spmd_frames)")
    ap.add_argument("--frame-groups", type=int, default=0,
                    help="frame placement: 1 = frame-sequential, > 1 = "
                         "frame-parallel member rows (needs --planner "
                         "stadi_video; spmd_frames runs groups x workers "
                         "ranks), 0 = let stadi_video search")
    ap.add_argument("--exchange-refresh", type=int, default=2,
                    help="full refresh every E boundaries (stale/predictive)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the numerics run; 'cpu' takes the kernels' "
                         "plain versions")
    return ap


def _setup(args, device):
    """Model, weights, noise, class and pipeline config of a run, all from
    ``args`` and its seed: every rank and the parent build the same."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import sampler as sampler_lib
    from repro_torch.core.pipeline import StadiConfig
    from repro_torch.core.simulate import CostModel
    from repro_torch.models.diffusion import dit

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = dit.init_params(
        torch.Generator(device=device).manual_seed(args.seed), cfg)
    sched = sampler_lib.linear_schedule(T=1000)
    shape = (args.batch, cfg.latent_size, cfg.latent_size, cfg.channels)
    if args.num_frames > 1:               # video latent: [B, F, H, W, C]
        shape = shape[:1] + (args.num_frames,) + shape[1:]
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
        seq_shards=args.seq_shards, num_stages=args.num_stages,
        micro_patches=args.micro_patches, num_frames=args.num_frames,
        frame_groups=args.frame_groups, **knobs)
    return cfg, params, sched, x_T, cond, config


def _rank_generate(ctx, argv):
    """One rank of a multi-rank run: the same setup as the parent, on the
    rank's device, then ``generate``. Returns what the parent prints."""
    import torch

    from repro_torch.core.pipeline import StadiPipeline

    args = _parse(argv)
    cfg, params, sched, x_T, cond, config = _setup(args, ctx.device)
    pipe = StadiPipeline(cfg, params, sched, config, device=ctx.device)
    t0 = time.perf_counter()
    res = pipe.generate(x_T, cond)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return {"rank": ctx.rank, "seconds": time.perf_counter() - t0,
            "launches": res.kernel_stats["launches"],
            "image": res.image.float().cpu().numpy()}


def _parse(argv):
    ap = _parser()
    args, rest = ap.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in _LATER_FLAGS:
            ap.error(f"{flag} is not ported yet: it comes with "
                     f"{_LATER_FLAGS[flag]} of ROADMAP.md")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.spmd:
        args.backend = "spmd"
    return args


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)

    import numpy as np
    import torch

    from repro_torch.core.pipeline import StadiPipeline, resolve_device

    device = resolve_device(args.device)
    cfg, params, sched, x_T, cond, config = _setup(args, device)
    pipe = StadiPipeline(cfg, params, sched, config, device=device)
    plan = pipe.plan()
    print(f"speeds={config.speeds} steps={plan.temporal.steps} "
          f"ratios={plan.temporal.ratios} patches={plan.patches} "
          f"stages={plan.stages} guidance={plan.guidance} seq={plan.seq} "
          f"frames={plan.frames}")
    summary = {"patches": plan.patches, "steps": plan.temporal.steps,
               "planner": args.planner, "backend": args.backend,
               "device": str(device)}

    if args.backend in ("spmd", "spmd_guidance", "spmd_seq", "spmd_pipefuse",
                        "spmd_frames"):
        from repro_torch.launch import ranks
        if args.backend == "spmd_seq" and plan.seq is not None:
            world = plan.seq.n_shards * len(plan.patches)
        elif args.backend == "spmd_pipefuse" and plan.stages:
            world = len(plan.stages)
        elif args.backend == "spmd_frames" and plan.frames is not None:
            world = plan.frames.n_groups * len(plan.patches)
        else:
            world = config.n_devices
        per_rank = ranks.spawn(_rank_generate, world, device_type=device.type,
                               dist_backend=args.dist_backend, args=(argv,))
        backend = ranks.resolve_backend(device.type, world, args.dist_backend)
        img = per_rank[0]["image"]
        same = all(np.array_equal(r["image"], img) for r in per_rank)
        finite = bool(np.isfinite(img).all())
        shared = (device.type == "cuda"
                  and world > torch.cuda.device_count())
        print(f"{args.backend} run on {world} {device.type} ranks ({backend}"
              f"{'; ranks share the cards: not a makespan' if shared else ''}"
              f"): seconds per rank "
              f"{[round(r['seconds'], 3) for r in per_rank]}, image "
              f"{img.shape} finite={finite} same on every rank={same}, "
              f"launches per rank {[r['launches'] for r in per_rank]}")
        summary.update(ranks=world, dist_backend=backend, finite=finite)
        if args.check_vs_emulation:
            emu = StadiPipeline(cfg, params, sched, dataclasses.replace(
                config, backend=("pipefuse" if args.backend == "spmd_pipefuse"
                                 else "emulated")), device=device)
            ref = emu.generate(x_T, cond).image.float().cpu().numpy()
            err = float(np.linalg.norm(img - ref) / np.linalg.norm(ref))
            print(f"rel_err_vs_emulation={err:.3e}")
            if not err < 1e-3:
                raise AssertionError(f"rel_err_vs_emulation {err} >= 1e-3")
            summary["rel_err_vs_emulation"] = err
        print(json.dumps(summary))
        return summary

    if device.type == "cuda":
        from repro_torch.kernels import ops
        ops.load_library()                 # build the kernels outside the timing
    t0 = time.perf_counter()
    res = pipe.generate(x_T, cond)
    if res.image is None:                  # trace-only backend
        print(f"{args.backend} run: modeled latency {res.latency_s:.6f}s")
        print(json.dumps({**summary, "latency_s": res.latency_s}))
        return summary
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    finite = bool(torch.isfinite(res.image).all())
    print(f"{args.backend} run on {device}: {seconds:.2f}s image "
          f"{tuple(res.image.shape)} finite={finite} "
          f"kernel_stats={json.dumps(res.kernel_stats, sort_keys=True)}")
    print(json.dumps({**summary, "finite": finite}))
    return summary


if __name__ == "__main__":
    main()
