"""What a ``--trace 1`` run reads: the benchmark's own spans around the
calls into each layer of the program, and the profiler's device events,
reduced to one summary a card.

The profiler records the device's activity only (CUDA kernels, copies and
the runtime calls that launched them): recording every host operator as
well made an image of the generate cell 50 to 80 % slower on the H100,
against some 10 % for the device's activity alone. So the spans are the
benchmark's own: :class:`Spans` wraps, while a stretch is traced, the
entry points of the model step (``dit.forward_patch``), of kernels K1 and
K2 (``kernels.ops``) and of the collectives (``core.comm``), notes each
call's shapes, and stamps the host intervals of the layers it and the
drivers enter on the same wall clock the profiler stamps events with.

:func:`summarize` reads the profiler's raw events (``key_averages`` builds
a Python object an event first, and an image launches some 10^4 kernels):
the union of the device's busy intervals, device time by kernel, the
device time of K1's and K2's launches (they run one kernel, so each
launch of it is matched, in launch order, with the calls the spans saw;
where the counts differ, nothing is matched and the mismatch is printed),
and the idle gaps by the innermost host span open across them.
"""
from __future__ import annotations

import bisect
import contextlib
import sys
import time
from typing import Dict, List

import torch

#: the host spans, innermost first: an idle gap is charged to the first
#: that covers it
SPANS = ("exchange", "encode", "forward", "submit", "step", "generate")
#: the device kernel that K1 and K2 (and K4, K5) launch
ATTENTION_KERNEL = "stale_kv_attention_wgmma_kernel"


class Spans:
    """Call shapes and host intervals of the program's layers."""

    def __init__(self):
        self.forwards: List[tuple] = []   # (B, Nl real, N ctx, Lc, full)
        self.attention: List[tuple] = []  # ("k1" | "k2", B, H, Nl, N, hd)
        self.host: Dict[str, list] = {n: [] for n in SPANS}
        self.window_ns = None
        self._saved = []

    @contextlib.contextmanager
    def span(self, name: str, on: bool = True):
        if not on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.host[name].append((t0, time.time_ns()))

    def _wrap(self, module, name, span=None, note=None):
        fn = getattr(module, name)

        def call(*args, **kw):
            if note is not None:
                note(*args, **kw)
            if span is None:
                return fn(*args, **kw)
            with self.span(span):
                return fn(*args, **kw)
        self._saved.append((module, name, fn))
        setattr(module, name, call)

    def install(self, model_cfg) -> None:
        from repro_torch.core import comm
        from repro_torch.kernels import ops
        from repro_torch.models.diffusion import dit

        side = model_cfg.tokens_per_side

        def forward(params, cfg, x_rows, t, cond, row_start, buffers=None,
                    return_kv=True, valid_tokens=None, attend_fn=None,
                    frame=None, ctx_tokens=None):
            nl = valid_tokens or x_rows.shape[1] // cfg.patch_size * side
            lc = cond.shape[1] if getattr(cond, "ndim", 0) >= 3 else 0
            self.forwards.append((x_rows.shape[0], nl,
                                  ctx_tokens or cfg.n_tokens, lc,
                                  buffers is None))

        def k1(q, kf, vf, ks, vs, *, tok_start):
            self.attention.append(("k1", q.shape[0], q.shape[2], q.shape[1],
                                   ks.shape[1], q.shape[3]))

        def k2(q, kf, vf, ks, vs, tok_start, valid_tokens, *, n_tokens):
            self.attention.append(("k2", q.shape[0], q.shape[2], valid_tokens,
                                   n_tokens, q.shape[3]))

        self._wrap(dit, "forward_patch", "forward", forward)
        self._wrap(ops, "stale_kv_attention", note=k1)
        self._wrap(ops, "stale_kv_attention_padded", note=k2)
        self._wrap(comm, "uneven_all_gather_padded", "exchange")

    def remove(self) -> None:
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved = []


@contextlib.contextmanager
def traced(spans: Spans, model_cfg, device):
    """Profile the body as one stretch: the device is synchronised as the
    stretch opens and before it closes, so its wall interval spans every
    operation of the body. Yields a dict that holds the profiler once the
    stretch has closed."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    cuda = device.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                   else [ProfilerActivity.CPU])
    if cuda:
        torch.cuda.synchronize(device)
    prof.start()
    spans.install(model_cfg)
    t0 = time.time_ns()
    try:
        yield out
        if cuda:
            torch.cuda.synchronize(device)
    finally:
        spans.window_ns = (t0, time.time_ns())
        spans.remove()
        prof.stop()
    out["prof"] = prof


def _union(intervals):
    """Merged [(start, end)] of sorted intervals."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(prof, spans: Spans, top: int = 10) -> Dict:
    """One card's stretch: window and busy seconds, device operations,
    device seconds by kernel name, K1's and K2's device seconds (None
    where the launches could not be matched), and idle seconds by the
    innermost host span open across each gap."""
    cuda = torch.autograd.DeviceType.CUDA
    lo, hi = spans.window_ns
    device = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != cuda or e.is_async() or e.is_user_annotation()
                or e.start_thread_id() != e.end_thread_id()):
            continue
        if e.end_ns() > lo and e.start_ns() < hi:
            device.append((e.start_ns(), e.end_ns(), e.name(),
                           e.correlation_id()))
    device.sort()
    busy = _union([(max(s, lo), min(e, hi)) for s, e, _, _ in device])
    by_name: Dict[str, list] = {}
    for s, e, name, _ in device:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (min(e, hi) - max(s, lo)) * 1e-9
        acc[1] += 1
    launches = sorted((corr, (e - s) * 1e-9) for s, e, name, corr in device
                      if ATTENTION_KERNEL in name)
    kernel_s = None
    if len(launches) == len(spans.attention):
        kernel_s = {"k1": 0.0, "k2": 0.0}
        for (_, sec), call in zip(launches, spans.attention):
            kernel_s[call[0]] += sec
    else:
        print(f"portbench: {len(launches)} launches of {ATTENTION_KERNEL} "
              f"in the trace against {len(spans.attention)} K1/K2 calls: "
              "no roofline", file=sys.stderr, flush=True)
    host = {n: sorted(v) for n, v in spans.host.items() if v}
    starts = {n: [s for s, _ in v] for n, v in host.items()}

    def open_span(t):
        for n in SPANS:
            if n in host:
                i = bisect.bisect_right(starts[n], t) - 1
                if i >= 0 and host[n][i][1] >= t:
                    return n
        return "harness"

    gaps: Dict[str, float] = {}
    edges = [lo] + [x for b in busy for x in b] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            n = open_span((a + b) // 2)
            gaps[n] = gaps.get(n, 0.0) + (b - a) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"window_s": (hi - lo) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "kernels": len(device),
            "by_name": dict(ops),
            "attention_s": kernel_s,
            "device_ops": [[k[:120], v[0]] for k, v in ops[:top]],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top]}


def kernel_seconds(summary: Dict, part: str) -> float:
    """Device seconds of the kernels whose name holds ``part``."""
    return sum(v[0] for k, v in summary["by_name"].items() if part in k)
