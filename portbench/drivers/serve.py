"""Served requests through ``DiffusionServingEngine`` on the cell's plan,
its ``slots`` lanes, and the mix's arrivals: open loop (``poisson``: each
request submitted when it is due, whatever the engine's backlog) or closed
loop (``closed``: ``clients`` callers, each sending its next request when
its last is done). A prompt model's request is encoded by the program's
text tower inside the window, as the request's own work.

Open loop: a request is timed from when it was due to when the round that
retired it returned (the engine waits for the card before it retires a
lane). Every request due inside the window is waited for, with arrivals
going on, up to a minute past the close; one still not done then counts
as failed, and with the seconds it had waited by then, so that a backlog
raises the tail. How late each submit ran behind its due time is kept. Closed loop: the window ends with the first round
that returns after ``seconds``, and every image retired by then counts.

The traced run profiles ``trace.rounds`` rounds from the middle of the
window on.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from portbench import correct, harness, trace, traffic, weights

#: seconds past the window's close that a due request is waited for
GRACE_S = 60.0


class _Loop:
    """The engine, the requests and what the window saw."""

    def __init__(self, ctx, pipe, reqs, lat, device, spans):
        from repro_torch.models import text_encoder
        from repro_torch.serving import DiffusionServingEngine

        self.ctx, self.reqs, self.lat, self.device = ctx, reqs, lat, device
        self.encode = text_encoder.encode
        self.engine = DiffusionServingEngine(pipe, slots=int(ctx.spec["slots"]))
        self.tokens, self.done = {}, {}
        self.encode_s, self.encoded = 0.0, 0
        self.tracing = False
        self.spans = spans
        self.backlog_at_close = None

    def submit(self, j: int) -> None:
        req = self.reqs[j]
        with self.spans.span("submit", self.tracing):
            if req["prompt"] is not None:
                t = harness.clock()
                with self.spans.span("encode", self.tracing):
                    cond = self.encode([req["prompt"]], self.ctx.model_cfg,
                                       device=self.device)
                self.encode_s += harness.clock() - t
                self.encoded += 1
                self.tokens[j] = cond
            else:
                cond = req["cls"]
            self.engine.submit(self.lat[j:j + 1], cond, uid=j,
                               cfg_scale=req["cfg_scale"])

    def step(self):
        with self.spans.span("step", self.tracing):
            finished = self.engine.step()
        now = harness.clock()
        for r in finished:
            self.done[r.uid] = (now, r.image)
        return finished, now

    def busy(self) -> bool:
        return bool(self.engine.queue or self.engine.active)


def _warm(ctx, pipe, lat, device):
    """The shapes the traffic uses: every prompt bucket through the tower,
    and full lane groups of each kind of request the mix sends (guided
    ones at the largest prompt bucket) through a drained engine."""
    from repro_torch.models import text_encoder
    from repro_torch.serving import DiffusionServingEngine

    slots = int(ctx.spec["slots"])
    mix, model = ctx.spec["mix"], ctx.model
    prompt = None
    if mix.get("prompt_words"):
        for n in (4, 8, 16, 32):
            if n <= model["cond_seq_len"]:
                text_encoder.encode([" ".join(["w"] * n)], ctx.model_cfg,
                                    device=device)
        prompt = text_encoder.encode([" ".join(["w"] * model["cond_seq_len"])],
                                     ctx.model_cfg, device=device)
    share = float(mix.get("guided_share", 0.0))
    kinds = ([7.5] if share > 0 else []) + ([None] if share < 1 else [])
    for scale in kinds:
        engine = DiffusionServingEngine(pipe, slots=slots)
        for j in range(slots):
            engine.submit(lat[j:j + 1], prompt if prompt is not None else 0,
                          cfg_scale=scale)
        engine.run_to_completion()
        del engine
    harness.sync(device)


def _open_loop(loop: _Loop, seconds: float, trace_rounds: int):
    """Returns (window seconds, latencies of every request due in the
    window, generator lateness, those requests, traced or None)."""
    reqs, ctx = loop.reqs, loop.ctx
    due_window = [j for j, r in enumerate(reqs) if r["due_s"] < seconds]
    lateness, traced = [], None
    j, rounds_traced = 0, 0
    holder, stretch = None, None
    t0 = harness.clock()
    while True:
        now = harness.clock()
        while j < len(reqs) and t0 + reqs[j]["due_s"] <= now:
            lateness.append(now - (t0 + reqs[j]["due_s"]))
            loop.submit(j)
            j += 1
        if (ctx.trace and stretch is None and traced is None
                and now - t0 >= seconds / 2):
            stretch = trace.traced(loop.spans, ctx.model_cfg, loop.device)
            holder = stretch.__enter__()
            loop.tracing = True
        if loop.busy():
            _, now = loop.step()
            if stretch is not None:
                rounds_traced += 1
                if rounds_traced >= trace_rounds:
                    loop.tracing = False
                    stretch.__exit__(None, None, None)
                    traced, stretch = (holder["prof"], rounds_traced), None
        elif j < len(reqs):
            time.sleep(max(0.0, min(t0 + reqs[j]["due_s"] - now, 0.05)))
        if now - t0 >= seconds:
            if loop.backlog_at_close is None:
                loop.backlog_at_close = len(loop.engine.queue)
            left = [k for k in due_window if k not in loop.done]
            if (not left or now - t0 >= seconds + GRACE_S
                    or (j >= len(reqs) and not loop.busy())):
                break
    if stretch is not None:
        loop.tracing = False
        stretch.__exit__(None, None, None)
        traced = (holder["prof"], rounds_traced)
    end = harness.clock()
    lat = [loop.done[k][0] - (t0 + reqs[k]["due_s"]) if k in loop.done
           else end - (t0 + reqs[k]["due_s"]) for k in due_window]
    return seconds, lat, lateness, due_window, traced


def _closed_loop(loop: _Loop, seconds: float, trace_rounds: int):
    """Returns (window seconds, requests sent, traced or None)."""
    ctx = loop.ctx
    clients = int(ctx.spec["mix"]["clients"])
    traced, holder, stretch, rounds_traced = None, None, None, 0
    t0 = harness.clock()
    for j in range(clients):
        loop.submit(j)
    sent = clients
    while True:
        if (ctx.trace and stretch is None and traced is None
                and harness.clock() - t0 >= seconds / 2):
            stretch = trace.traced(loop.spans, ctx.model_cfg, loop.device)
            holder = stretch.__enter__()
            loop.tracing = True
        finished, now = loop.step()
        if stretch is not None:
            rounds_traced += 1
            if rounds_traced >= trace_rounds:
                loop.tracing = False
                stretch.__exit__(None, None, None)
                traced, stretch = (holder["prof"], rounds_traced), None
        if now - t0 >= seconds:
            break
        for _ in finished:
            loop.submit(sent)
            sent += 1
    if stretch is not None:
        loop.tracing = False
        stretch.__exit__(None, None, None)
        traced = (holder["prof"], rounds_traced)
    return now - t0, sent, traced


def run(ctx: harness.Context) -> Dict:
    device = ctx.device
    mix = ctx.spec["mix"]
    open_loop = mix["arrival"] == "poisson"
    params = weights.make(ctx.model, ctx.seed, device)
    n = (traffic.open_loop_count(mix, ctx.seconds + GRACE_S) if open_loop
         else traffic.closed_loop_count(ctx.seconds, int(mix["clients"])))
    reqs = traffic.requests(mix, ctx.seed, n)
    lat = weights.latents(ctx.model, ctx.seed, n, device)
    pipe = harness.pipeline(ctx, params, device)
    _warm(ctx, pipe, lat, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = harness.clock() - ctx.t_start
    spans = trace.Spans()
    loop = _Loop(ctx, pipe, reqs, lat, device, spans)
    rounds = int(ctx.spec.get("trace", {}).get("rounds", 10))
    out = {"setup_s": setup_s}
    if open_loop:
        window_s, lats, lateness, due, traced = _open_loop(
            loop, ctx.seconds, rounds)
        eligible = [k for k in due if k in loop.done]
        out.update(latencies=lats, lateness_s=lateness, attempted=len(due),
                   failed=len(due) - len(eligible), completed=len(eligible))
    else:
        window_s, sent, traced = _closed_loop(loop, ctx.seconds, rounds)
        out.update(attempted=sent, failed=0, completed=len(loop.done))
        eligible = sorted(loop.done)
    out["window_s"] = window_s
    out["peak_bytes"] = harness.peak_bytes(device)
    out["plan"] = harness.program_plan(pipe)
    stats = loop.engine.stats()
    d = stats["dispatches"]
    out["dispatches"] = d.get("plain", 0) + d.get("guided", 0)
    out["lanes"] = d.get("plain_lanes", 0) + d.get("guided_lanes", 0)
    out["encode_s"], out["encoded"] = loop.encode_s, loop.encoded
    out["rounds"] = stats["rounds"]
    out["backlog_at_close"] = loop.backlog_at_close
    if traced is not None:
        prof, k = traced
        out["trace"] = {"summary": trace.summarize(prof, spans), "rounds": k,
                        "forwards": spans.forwards,
                        "attention": spans.attention}
    out["ranks"] = [dict(out)]
    # the sample: drawn from the seed, with the longest request among it
    # (guided, the longest prompt) and of those the most strongly guided,
    # whose image moves most with the arithmetic (guidance multiplies the
    # two branches' difference by the scale)
    key = lambda k: (reqs[k]["cfg_scale"] is not None,
                     len(reqs[k]["prompt"].split()) if reqs[k]["prompt"] else 0,
                     reqs[k]["cfg_scale"] or 0.0)
    longest = sorted(range(len(eligible)), key=lambda i: key(eligible[i]))[-1:]
    picked = correct.pick(len(eligible), ctx.seed,
                          int(ctx.spec["check"]["samples"]), must=longest)
    samples = []
    for i in picked:
        k = eligible[i]
        samples.append({"x_T": lat[k:k + 1].cpu(), "cls": reqs[k]["cls"],
                        "cfg_scale": reqs[k]["cfg_scale"],
                        "prompt": reqs[k]["prompt"],
                        "tokens": (loop.tokens[k].cpu() if k in loop.tokens
                                   else None),
                        "image": loop.done[k][1].cpu()})
    out["failed"] += sum(int(not bool(torch.isfinite(s["image"].float()).all()))
                         for s in samples)
    del loop, pipe
    out["readings"] = lambda control=False: correct.readings(
        ctx.spec, params, samples, out["plan"], device, control)
    return out
