"""Closed-loop image generation: back-to-back ``StadiPipeline.generate``
calls, each the next request of the mix, each waited for on the card as a
user waits for the image. On a one-card plan it runs in this process; on
the ``spmd`` backend every card runs a rank, and rank 0 decides when the
window has closed and tells the others after each image.

The traced run profiles ``trace.images`` whole images from the middle of
the window on; the per-layer metrics read that stretch alone, its busy
and its wall seconds alike. The facts returned: set-up and window
seconds, images, peak memory, the program's plan, the sample's images,
the traced stretch's summaries and call shapes, and (a rank) the
forbidden modules it had loaded once the window closed.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from portbench import correct, harness, trace, traffic, weights


def _setup(ctx: harness.Context, device):
    params = weights.make(ctx.model, ctx.seed, device)
    n = traffic.closed_loop_count(ctx.seconds, 1)
    reqs = traffic.requests(ctx.spec["mix"], ctx.seed, n)
    lat = weights.latents(ctx.model, ctx.seed, n, device)
    pipe = harness.pipeline(ctx, params, device)
    return params, reqs, lat, pipe


def _cond(req, device):
    return torch.tensor([req["cls"]], device=device)


#: what happens after an image: the window closes, the next image runs,
#: or the next ``trace.images`` images run under the profiler
STOP, GO, TRACE = 0, 1, 2


def _next(ctx, elapsed: float, traced: bool) -> int:
    """The next step of the window at ``elapsed`` seconds: the traced
    stretch starts with the first image after half the window."""
    if elapsed >= ctx.seconds:
        return STOP
    if ctx.trace and not traced and elapsed >= ctx.seconds / 2:
        return TRACE
    return GO


def _window(ctx, pipe, reqs, lat, device, decide):
    """Generate until ``decide(elapsed, traced)`` says STOP; returns
    (window seconds, images, the traced stretch or None)."""
    k = int(ctx.spec.get("trace", {}).get("images", 3))
    spans = trace.Spans()
    images, traced, walls = [], None, []
    i, step = 0, GO
    t0 = harness.clock()
    while step != STOP:
        tracing = step == TRACE
        stretch = (trace.traced(spans, ctx.model_cfg, device) if tracing
                   else contextlib.nullcontext({}))
        with stretch as holder:
            for _ in range(k if tracing else 1):
                t = harness.clock()
                with spans.span("generate", tracing):
                    res = pipe.generate(lat[i:i + 1], _cond(reqs[i], device))
                harness.sync(device)
                walls.append(harness.clock() - t)
                images.append(res.image)
                i += 1
        if tracing:
            traced = (holder["prof"], spans, k)
        step = decide(harness.clock() - t0, traced is not None)
    q = np.percentile(walls, [0, 25, 50, 75, 100]).round(4).tolist()
    print(f"image seconds (min, q1, median, q3, max): {q} over {len(walls)}",
          flush=True)
    return harness.clock() - t0, images, traced


def _facts(ctx, pipe, reqs, lat, images, window_s, traced, setup_s, device):
    """What one process (or rank) hands back."""
    out = {"setup_s": setup_s, "window_s": window_s,
           "completed": len(images), "attempted": len(images),
           "failed": sum(int(not bool(torch.isfinite(im.float()).all()))
                         for im in images),
           "peak_bytes": harness.peak_bytes(device),
           "plan": harness.program_plan(pipe)}
    if traced is not None:
        prof, spans, k = traced
        out["trace"] = {"summary": trace.summarize(prof, spans), "images": k,
                        "forwards": spans.forwards,
                        "attention": spans.attention}
    return out


def _sample(ctx, reqs, lat, images):
    count = int(ctx.spec["check"]["samples"])
    return [{"x_T": lat[i:i + 1].cpu(), "cls": reqs[i]["cls"],
             "cfg_scale": reqs[i]["cfg_scale"], "image": images[i].cpu()}
            for i in correct.pick(len(images), ctx.seed, count)]


def run(ctx: harness.Context) -> Dict:
    if ctx.spec["plan"]["backend"] == "spmd":
        return _run_spmd(ctx)
    device = ctx.device
    params, reqs, lat, pipe = _setup(ctx, device)
    for i in range(int(ctx.spec.get("warmup", 2))):
        pipe.generate(lat[i:i + 1], _cond(reqs[i], device))
        harness.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = harness.clock() - ctx.t_start
    window_s, images, traced = _window(
        ctx, pipe, reqs, lat, device,
        lambda elapsed, traced: _next(ctx, elapsed, traced))
    out = _facts(ctx, pipe, reqs, lat, images, window_s, traced, setup_s,
                 device)
    out["ranks"] = [dict(out)]
    samples = _sample(ctx, reqs, lat, images)
    del pipe, images
    out["readings"] = lambda control=False: correct.readings(
        ctx.spec, params, samples, out["plan"], device, control)
    return out


# ----------------------------------------------------------------------
# spmd: a rank a card
# ----------------------------------------------------------------------

def _rank(rank_ctx, ctx: harness.Context):
    import torch.distributed as dist

    device = rank_ctx.device
    params, reqs, lat, pipe = _setup(ctx, device)
    for i in range(int(ctx.spec.get("warmup", 2))):
        pipe.generate(lat[i:i + 1], _cond(reqs[i], device))
        harness.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    flag = torch.zeros(1, device=device)
    dist.broadcast(flag, 0)                    # the window opens together
    harness.sync(device)
    setup_end = harness.clock()

    def decide(elapsed, traced):
        flag.fill_(float(_next(ctx, elapsed, traced)))
        dist.broadcast(flag, 0)                # rank 0's clock decides
        return int(flag.item())
    window_s, images, traced = _window(ctx, pipe, reqs, lat, device, decide)
    out = _facts(ctx, pipe, reqs, lat, images, window_s, traced,
                 setup_end - ctx.t_start, device)
    out["forbidden"] = harness.forbidden_modules()
    if rank_ctx.rank == 0:
        out["sample"] = _sample(ctx, reqs, lat, images)
    return out


def _run_spmd(ctx: harness.Context) -> Dict:
    from repro_torch.launch import ranks

    world = len(ctx.spec["plan"]["occupancies"])
    per_rank = ranks.spawn(_rank, world, device_type=ctx.device.type,
                           args=(ctx,), timeout=300)
    out = dict(per_rank[0])
    out["ranks"] = per_rank
    out["peak_bytes"] = max(r["peak_bytes"] for r in per_rank)
    samples = out.pop("sample")
    device = ctx.device

    def readings(control=False):
        params = weights.make(ctx.model, ctx.seed, device)
        return correct.readings(ctx.spec, params, samples, out["plan"], device,
                                control)
    out["readings"] = readings
    return out
