"""Serving entry point of the port (reference: ``repro.launch.serve``):
batched LLM requests of random prompts through the
:class:`~repro_torch.serving.ServingEngine`, or a diffusion request queue
through the continuous-batching :class:`~repro_torch.serving.
DiffusionServingEngine` (``--diffusion``), on the GPU unless ``--device
cpu`` is given. Weights are random (seeded), as in the reference's; the
model is the ``reduced()`` form, as there.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --requests 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --diffusion \\
      --arch tiny-dit --occupancies 0.0,0.6 --requests 8 --slots 4 \\
      --slo-ms 200 --cfg-scale 4.0 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --diffusion \\
      --backend pipefuse --num-stages 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --diffusion \\
      --backend spmd --occupancies 0.0,0.5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --diffusion \\
      --num-frames 3 --requests 3 --slots 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --diffusion \\
      --cond-tokens 8 --device cpu

``--num-frames F`` serves video lanes: one clip of F frames a request, run
whole in its admission round (``--frame-groups`` pins the frame placement
of ``--planner stadi_video``). ``--backend spmd`` starts one rank per device
of ``--occupancies``, ``--backend spmd_frames`` one per patch-worker column
of each frame row (:mod:`repro_torch.launch.ranks`; NCCL with one card per
rank, or gloo with ``--dist-backend gloo``), each of which builds the same
engine, receives the same requests and drains them; rank 0's requests are
reported. ``--prompt`` (the prompt, suffixed with the request's uid, through
the frozen text encoder) or ``--cond-tokens L`` (1 to L random prompt
tokens, varied by uid so that more than one bucket is served) serves
prompt lanes of a text-conditioned model (``--cond-seq-len`` its largest
bucket).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.pipeline import StadiConfig, StadiPipeline
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine


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
                    num_stages: int = 1, cfg_scale: float = 0.0,
                    seq_shards: int = 1, num_frames: int = 1,
                    frame_groups: int = 0, plan_cache_dir: str = None,
                    prompt: str = None, cond_tokens: int = None,
                    cond_seq_len: int = 32, dist_backend: str = None,
                    device=None):
    """Continuous batching on a heterogeneous cluster: requests enter a FIFO
    queue, the :class:`DiffusionServingEngine` admits them into ``slots``
    concurrent lanes and drains the queue with batched denoise rounds.
    ``cfg_scale > 0`` makes every other request a classifier-free-guidance
    one (DESIGN.md §12) — the mixed CFG / non-CFG workload the engine's
    per-lane guidance state exists for. ``num_stages > 1`` with backend
    ``pipefuse`` serves the displaced stage chain (DESIGN.md §11);
    ``num_frames > 1`` serves video lanes, one clip a request (DESIGN.md
    §16). ``prompt`` or ``cond_tokens`` builds the model text-conditioned
    and serves prompt lanes (DESIGN.md §17). Backend ``spmd`` runs the
    engine on one rank per device of the cluster, ``spmd_frames`` on one per
    column of each frame row, every rank on the same requests; rank 0
    reports. Returns the finished requests
    (rank 0's, on the CPU, for the multi-rank backends)."""
    from repro_torch.core.pipeline import resolve_device

    kw = dict(arch=arch, occupancies=list(occupancies), n_requests=n_requests,
              slots=slots, m_base=m_base, m_warmup=m_warmup, planner=planner,
              backend=backend, reduced=reduced, slo_s=slo_s, seed=seed,
              exchange=exchange, exchange_refresh=exchange_refresh,
              num_stages=num_stages, cfg_scale=cfg_scale,
              seq_shards=seq_shards, num_frames=num_frames,
              frame_groups=frame_groups, plan_cache_dir=plan_cache_dir,
              prompt=prompt, cond_tokens=cond_tokens,
              cond_seq_len=cond_seq_len)
    device = resolve_device(device)
    if backend not in ("spmd", "spmd_frames"):
        return _serve_diffusion_here(**kw, device=device)
    world = len(occupancies)
    if backend == "spmd_frames":
        # the frame plan decides the ranks: planning reads no weights
        cfg, config = _model_and_config(**{k: kw[k] for k in _CONFIG_KW})
        plan = StadiPipeline(cfg, {}, None, config, device="cpu").plan()
        if plan.frames is not None:
            world = plan.frames.n_groups * len(plan.patches)
    from repro_torch.launch import ranks as ranks_lib
    return ranks_lib.spawn(_serve_rank, world, device_type=device.type,
                           dist_backend=dist_backend, args=(kw,))[0]


#: the arguments of :func:`_model_and_config`
_CONFIG_KW = ("arch", "occupancies", "m_base", "m_warmup", "planner",
              "backend", "reduced", "exchange", "exchange_refresh",
              "num_stages", "seq_shards", "num_frames", "frame_groups",
              "plan_cache_dir", "prompt", "cond_tokens", "cond_seq_len")


def _model_and_config(arch, *, occupancies, m_base, m_warmup, planner,
                      backend, reduced, exchange, exchange_refresh,
                      num_stages, seq_shards, num_frames, frame_groups,
                      plan_cache_dir, prompt, cond_tokens, cond_seq_len):
    """The served model's config (text-conditioned for prompt lanes) and
    the pipeline config."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if prompt is not None or cond_tokens is not None:
        cfg = cfg.text_conditioned(cond_seq_len=cond_seq_len)
    config = StadiConfig.from_occupancies(list(occupancies), m_base=m_base,
                                          m_warmup=m_warmup, planner=planner,
                                          backend=backend, exchange=exchange,
                                          exchange_refresh=exchange_refresh,
                                          num_stages=num_stages,
                                          seq_shards=seq_shards,
                                          num_frames=num_frames,
                                          frame_groups=frame_groups,
                                          plan_cache_dir=plan_cache_dir)
    return cfg, config


def _serve_rank(ctx, kw):
    """One rank of ``serve --diffusion --backend spmd|spmd_frames``: the same
    engine and requests as every other rank; rank 0 prints the report."""
    done = _serve_diffusion_here(**kw, device=ctx.device,
                                 report=ctx.rank == 0)
    for req in done:                     # returned by value, off the card
        req.x_T, req.cond, req.image = (req.x_T.cpu(), req.cond.cpu(),
                                        req.image.cpu())
    return done


def _serve_diffusion_here(arch, *, occupancies, n_requests, slots, m_base,
                          m_warmup, planner, backend, reduced, slo_s, seed,
                          exchange, exchange_refresh, num_stages, cfg_scale,
                          seq_shards, num_frames, frame_groups,
                          plan_cache_dir, prompt, cond_tokens, cond_seq_len,
                          device, report=True):
    """The body of :func:`serve_diffusion` in this process on ``device``."""
    from repro_torch.core import sampler as sampler_lib
    from repro_torch.models import text_encoder
    from repro_torch.models.diffusion import dit
    from repro_torch.serving import DiffusionServingEngine

    cfg, config = _model_and_config(
        arch, occupancies=occupancies, m_base=m_base, m_warmup=m_warmup,
        planner=planner, backend=backend, reduced=reduced, exchange=exchange,
        exchange_refresh=exchange_refresh, num_stages=num_stages,
        seq_shards=seq_shards, num_frames=num_frames,
        frame_groups=frame_groups, plan_cache_dir=plan_cache_dir,
        prompt=prompt, cond_tokens=cond_tokens, cond_seq_len=cond_seq_len)
    params = dit.init_params(torch.Generator(device=device).manual_seed(seed),
                             cfg)
    sched = sampler_lib.linear_schedule(T=1000)
    pipe = StadiPipeline(cfg, params, sched, config, device=device)
    engine = DiffusionServingEngine(pipe, slots=slots)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    n_guided = 0
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.channels)
    if num_frames > 1:                   # video lanes: one clip a request
        shape = shape[:1] + (num_frames,) + shape[1:]
    for uid in range(n_requests):
        x_T = torch.randn(shape, generator=gen)
        scale = cfg_scale if (cfg_scale > 0 and uid % 2 == 0) else None
        n_guided += scale is not None
        if prompt is not None:
            cond = text_encoder.encode([f"{prompt} #{uid}"], cfg,
                                       device=device)[0]
        elif cond_tokens is not None:
            n_tok = 1 + uid % cond_tokens
            L = text_encoder.bucket_length(n_tok, cfg.cond_seq_len)
            mask = (torch.arange(L) < n_tok).float()[:, None]
            feats = torch.randn((L, cfg.cond_dim), generator=gen)
            cond = torch.cat([feats * mask, mask], dim=-1)
        else:
            cond = int(rng.integers(0, cfg.n_classes))
        engine.submit(x_T, cond, slo_s=slo_s, cfg_scale=scale)
    done = engine.run_to_completion()
    dt = time.perf_counter() - t0
    for req in done:
        assert bool(torch.isfinite(req.image.float()).all())
    if not report:
        return done
    stats = engine.stats()
    note = ("" if stats["cost_model"] == "configured"
            else " [default-uncalibrated cost model]")
    print(f"served {stats['n_completed']}/{n_requests} generation requests "
          f"({n_guided} CFG) in {dt:.2f}s ({stats['n_completed']/dt:.2f} "
          f"img/s wall, {stats['throughput_modeled_rps']:.2f} img/s "
          f"modeled{note}) planner={planner} backend={backend} "
          f"slots={slots} rounds={stats['rounds']} "
          f"patches={engine.plan.patches} stages={engine.stages} "
          f"seq={engine.seq} frames={engine.frames} on {device}; "
          f"dispatches {stats['dispatches']}, launches {stats['kernels']}")
    if engine._prompt_mode:
        print(f"  dispatches by (guidance/prompt bucket): "
              f"{stats['dispatches_by_bucket']}")
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
    # no abbreviations: "--prompt" and "--prompt-len" are two flags
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--arch", default="gemma-2b",
                    help="an LM (its reduced form; seamless-m4t-medium, "
                         "the enc-dec, is refused by the engine, as in the "
                         "reference), or a DiT with --diffusion")
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
                         "stadi_pipefuse / stadi_guidance / stadi_seq / "
                         "stadi_video")
    ap.add_argument("--backend", default="emulated",
                    choices=["emulated", "pipefuse", "spmd", "spmd_frames"],
                    help="serving stepper (diffusion only): 'emulated', "
                         "'pipefuse' (the displaced stage chain with "
                         "--num-stages), 'spmd' (the multi-rank stepper, "
                         "one rank per device of --occupancies) or "
                         "'spmd_frames' (video lanes on the frame rows' "
                         "ranks)")
    ap.add_argument("--num-stages", type=int, default=1,
                    help="depth stages for --backend pipefuse (diffusion "
                         "only, DESIGN.md §11): 1 = pure patch parallelism, "
                         "0 = let stadi_pipefuse search")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="collectives of --backend spmd: NCCL (the default "
                         "on CUDA, one card per rank) or gloo")
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
    ap.add_argument("--num-frames", type=int, default=1,
                    help="video serving lanes (diffusion only, DESIGN.md "
                         "§16): latent frames per request (1 = image; > 1 "
                         "serves one clip a request, run to completion in "
                         "its admission round)")
    ap.add_argument("--frame-groups", type=int, default=0,
                    help="frame placement (diffusion only): 1 = frame-"
                         "sequential, > 1 = frame-parallel member rows "
                         "(needs --planner stadi_video), 0 = auto search")
    cond_group = ap.add_mutually_exclusive_group()
    cond_group.add_argument("--prompt", default=None,
                            help="text prompt (diffusion only, DESIGN.md "
                                 "§17): the model is built text-conditioned "
                                 "and every request carries encoded prompt "
                                 "tokens (suffixed with its uid)")
    cond_group.add_argument("--cond-tokens", type=int, default=None,
                            metavar="L",
                            help="prompt lanes with 1 to L random prompt "
                                 "tokens a request (varied by uid, so that "
                                 "more than one bucket is served)")
    ap.add_argument("--cond-seq-len", type=int, default=32,
                    help="text-conditioned models: the largest prompt "
                         "bucket (DiTConfig.cond_seq_len)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
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
            num_stages=args.num_stages, cfg_scale=args.cfg_scale,
            seq_shards=args.seq_shards, num_frames=args.num_frames,
            frame_groups=args.frame_groups, plan_cache_dir=args.plan_cache,
            prompt=args.prompt, cond_tokens=args.cond_tokens,
            cond_seq_len=args.cond_seq_len, dist_backend=args.dist_backend,
            device=args.device)
    return serve(args.arch, n_requests=args.requests, slots=args.slots,
                 prompt_len=args.prompt_len, max_new=args.max_new,
                 device=args.device)


if __name__ == "__main__":
    main()
