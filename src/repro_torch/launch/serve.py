"""Serving entry point of the port (reference: ``repro.launch.serve``):
batched LLM requests of random prompts through the
:class:`~repro_torch.serving.ServingEngine`, or a diffusion request queue
through the continuous-batching :class:`~repro_torch.serving.
DiffusionServingEngine` (``--diffusion``), on the GPU unless ``--device
cpu`` is given. Weights are random (seeded), as in the reference's; the
model is the ``reduced()`` form, as there.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --requests 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --diffusion \\
      --arch tiny-dit --occupancies 0.0,0.6 --requests 8 --slots 4 \\
      --slo-ms 200 --cfg-scale 4.0 --device cpu

The diffusion flags of later slices (``--num-stages``, ``--num-frames``,
``--frame-groups``, the prompt flags, and ``--backend spmd``) raise
NotImplementedError naming their ROADMAP.md queue 1 items.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.pipeline import later_slice
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

#: the reference's diffusion flags that later slices of the port bring
_LATER_FLAGS = {"--num-stages": "stages", "--num-frames": "frames",
                "--frame-groups": "frames", "--prompt": "prompt",
                "--cond-tokens": "prompt", "--cond-seq-len": "prompt"}


def serve(arch: str, *, n_requests: int = 8, slots: int = 4,
          prompt_len: int = 16, max_new: int = 12, reduced: bool = True,
          window: int = 0, seed: int = 0, device=None):
    """Serve ``n_requests`` random prompts; returns the finished requests.
    ``device`` defaults to ``cuda``."""
    from repro_torch.core.pipeline import resolve_device

    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    engine = ServingEngine(model, params, slots=slots,
                           max_len=prompt_len + max_new + 8,
                           window=window or cfg.sliding_window)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for uid in range(n_requests):
        prompt = rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    done = engine.run_to_completion()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)}/{n_requests} requests, {tok} tokens in "
          f"{dt:.2f}s ({tok/dt:.1f} tok/s) on {device}")
    return done


def serve_diffusion(arch: str = "tiny-dit", *, occupancies=(0.0, 0.6),
                    n_requests: int = 4, slots: int = 4, m_base: int = 16,
                    m_warmup: int = 4, planner: str = "stadi",
                    backend: str = "emulated", reduced: bool = True,
                    slo_s: float = None, seed: int = 0,
                    exchange: str = "sync", exchange_refresh: int = 2,
                    cfg_scale: float = 0.0, seq_shards: int = 1,
                    plan_cache_dir: str = None, device=None):
    """Continuous batching on a heterogeneous cluster: requests enter a FIFO
    queue, the :class:`DiffusionServingEngine` admits them into ``slots``
    concurrent lanes and drains the queue with batched denoise rounds.
    ``cfg_scale > 0`` makes every other request a classifier-free-guidance
    one (DESIGN.md §12) — the mixed CFG / non-CFG workload the engine's
    per-lane guidance state exists for. Returns the finished requests."""
    from repro_torch.core import sampler as sampler_lib
    from repro_torch.core.pipeline import (StadiConfig, StadiPipeline,
                                           resolve_device)
    from repro_torch.models.diffusion import dit
    from repro_torch.serving import DiffusionServingEngine

    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    params = dit.init_params(torch.Generator(device=device).manual_seed(seed),
                             cfg)
    sched = sampler_lib.linear_schedule(T=1000)
    config = StadiConfig.from_occupancies(list(occupancies), m_base=m_base,
                                          m_warmup=m_warmup, planner=planner,
                                          backend=backend, exchange=exchange,
                                          exchange_refresh=exchange_refresh,
                                          seq_shards=seq_shards,
                                          plan_cache_dir=plan_cache_dir)
    pipe = StadiPipeline(cfg, params, sched, config, device=device)
    engine = DiffusionServingEngine(pipe, slots=slots)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    n_guided = 0
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.channels)
    for uid in range(n_requests):
        x_T = torch.randn(shape, generator=gen)
        scale = cfg_scale if (cfg_scale > 0 and uid % 2 == 0) else None
        n_guided += scale is not None
        engine.submit(x_T, int(rng.integers(0, cfg.n_classes)), slo_s=slo_s,
                      cfg_scale=scale)
    done = engine.run_to_completion()
    dt = time.perf_counter() - t0
    for req in done:
        assert bool(torch.isfinite(req.image.float()).all())
    stats = engine.stats()
    note = ("" if stats["cost_model"] == "configured"
            else " [default-uncalibrated cost model]")
    print(f"served {stats['n_completed']}/{n_requests} generation requests "
          f"({n_guided} CFG) in {dt:.2f}s ({stats['n_completed']/dt:.2f} "
          f"img/s wall, {stats['throughput_modeled_rps']:.2f} img/s "
          f"modeled{note}) planner={planner} backend={backend} "
          f"slots={slots} rounds={stats['rounds']} "
          f"patches={engine.plan.patches} seq={engine.seq} on {device}; "
          f"dispatches {stats['dispatches']}, launches {stats['kernels']}")
    if stats["plan_cache"] is not None:
        c = stats["plan_cache"]
        print(f"  plan cache: {c['hits']} hits / {c['misses']} misses "
              f"(hit rate {c['hit_rate']:.0%}), "
              f"{c['invalidations']} invalidated — a warm cache skips "
              "planner search on restart")
    for r in stats["requests"]:
        slo = "" if r["slo_met"] is None else f" slo_met={r['slo_met']}"
        print(f"  req {r['uid']}: queued {r['queue_rounds']} rounds, "
              f"served {r['service_rounds']} rounds, modeled latency "
              f"{r['modeled_latency_s']*1e3:.1f} ms{slo}")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b",
                    help="the port serves hymba-1.5b (the reference's "
                         "default, gemma-2b, comes with queue 1 item 15b)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--diffusion", action="store_true",
                    help="serve diffusion requests via StadiPipeline")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--occupancies", default="0.0,0.6")
    ap.add_argument("--planner", default="stadi",
                    help="allocation planner (diffusion only): uniform / "
                         "spatial / temporal / stadi / makespan / "
                         "stadi_guidance / stadi_seq")
    ap.add_argument("--backend", default="emulated",
                    help="serving stepper (diffusion only): 'emulated'; the "
                         "multi-rank 'spmd' stepper comes with queue 1 item "
                         "9b, 'pipefuse' with item 10")
    ap.add_argument("--m-base", type=int, default=16)
    ap.add_argument("--m-warmup", type=int, default=4)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request modeled-latency SLO (diffusion only)")
    ap.add_argument("--exchange", default="sync",
                    choices=["sync", "stale_async", "predictive", "ring"],
                    help="boundary-exchange policy (diffusion only, "
                         "DESIGN.md §10)")
    ap.add_argument("--exchange-refresh", type=int, default=2,
                    help="full refresh every E boundaries (stale/predictive)")
    ap.add_argument("--cfg-scale", type=float, default=0.0,
                    help="classifier-free guidance weight (diffusion only): "
                         "> 0 submits every other request as a CFG request")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="persistent plan-cache directory (diffusion only)")
    ap.add_argument("--seq-shards", type=int, default=1,
                    help="sequence-parallel attention (diffusion only): "
                         "lanes batch by ring-hop identity (1 = unsharded, "
                         "0 = let stadi_seq search)")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    for tok in rest:
        name = _LATER_FLAGS.get(tok.split("=", 1)[0])
        if name is not None:
            raise later_slice(name)
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.diffusion:
        arch = "tiny-dit" if args.arch == ap.get_default("arch") else args.arch
        if "dit" not in arch:
            ap.error(f"--diffusion serves DiT archs, not {arch!r}")
        return serve_diffusion(
            arch, occupancies=[float(x) for x in args.occupancies.split(",")],
            n_requests=args.requests, slots=args.slots, m_base=args.m_base,
            m_warmup=args.m_warmup, planner=args.planner,
            backend=args.backend,
            slo_s=None if args.slo_ms is None else args.slo_ms / 1e3,
            exchange=args.exchange, exchange_refresh=args.exchange_refresh,
            cfg_scale=args.cfg_scale, seq_shards=args.seq_shards,
            plan_cache_dir=args.plan_cache, device=args.device)
    return serve(args.arch, n_requests=args.requests, slots=args.slots,
                 prompt_len=args.prompt_len, max_new=args.max_new,
                 device=args.device)


if __name__ == "__main__":
    main()
