"""The program's own spans and counters (``repro_torch.spans``) joined to a
traced stretch's device events, reduced to one summary a process, and the
per-layer numbers read from those summaries.

Both sides stamp with ``time.time_ns()``: the recorder its host intervals,
torch's profiler its device operations and the runtime and driver calls
that launched them. Each device operation is matched to its launch, the
runtime or driver event with the same correlation id, and the launch's host
start places the operation in the innermost program span open at that
moment. Where over :data:`MAX_UNMATCHED` of a stretch's operations find no
launch, the numbers that need the join are not given, as
:func:`portbench.trace.summarize` gives no roofline where K1's launches and
calls differ in count.

A run hands :func:`summarize` the recorder's ``take()`` (the spans of the
whole window: the recorder is on from the window's opening to its close),
the stretch's device events (:func:`device_events`) and the stretch's wall
interval. The summary is small and picklable, so a rank process can hand
it back; the exchange's numbers compare the ranks' summaries.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the largest share of a stretch's device operations that may find no
#: launch before the join's numbers are withheld
MAX_UNMATCHED = 0.01
#: the largest median spread of the ranks' ends of one collective: a ring
#: all-gather ends on every rank within microseconds, so a wider spread
#: means the processes' clocks disagree
MAX_END_SPREAD_NS = 100_000


def device_events(prof, lo: int, hi: int):
    """(ops, launches) of a stopped ``torch.profiler.profile``: the device
    operations that overlap [lo, hi] as ``(start_ns, end_ns, name,
    correlation)``, sorted (filtered as ``trace.summarize`` filters them),
    and the host start of each host event that carries a correlation id
    (the runtime and driver calls that launch device work), by id."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if (e.is_async() or e.is_user_annotation()
                    or e.start_thread_id() != e.end_thread_id()):
                continue
            if e.end_ns() > lo and e.start_ns() < hi:
                ops.append((e.start_ns(), e.end_ns(), e.name(),
                            e.correlation_id()))
        elif e.correlation_id():
            corr = e.correlation_id()
            launches[corr] = min(e.start_ns(),
                                 launches.get(corr, e.start_ns()))
    ops.sort()
    return ops, launches


class _Tree:
    """The recorded spans, searchable by host time."""

    def __init__(self, recorded: Sequence[tuple]):
        order = sorted(range(len(recorded)), key=lambda i: recorded[i][1])
        pos = {old: new for new, old in enumerate(order)}
        self.spans = [recorded[i] for i in order]
        self.parent = [None if s[3] is None else pos[s[3]]
                       for s in self.spans]
        self.starts = [s[1] for s in self.spans]

    def innermost(self, t: int) -> Optional[int]:
        """The innermost span open at ``t``: the latest to start at or
        before ``t``, or the nearest of its ancestors still open (spans
        nest, so any span open at ``t`` that started earlier contains it)."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0 and self.spans[i][2] < t:
            i = self.parent[i]
        return i if i is not None and i >= 0 else None

    def within(self, i: Optional[int], name: str) -> Optional[int]:
        """The innermost span named ``name`` among ``i`` and its ancestors."""
        while i is not None:
            if self.spans[i][0] == name:
                return i
            i = self.parent[i]
        return None

    def outermost(self, name: str) -> List[int]:
        """The spans named ``name`` with no ancestor of that name."""
        return [i for i, s in enumerate(self.spans) if s[0] == name
                and self.within(self.parent[i], name) is None]


def _union(intervals):
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(taken: Dict, ops: Sequence[tuple], launches: Dict[int, int],
              stretch: Tuple[int, int]) -> Dict:
    """One process's summary: the join's coverage, device time by the
    program span that launched it, the exchange's kernels, the forwards'
    host seconds inside and outside the stretch, and the stretch's idle
    seconds by the innermost program span open across each gap."""
    lo, hi = stretch
    tree = _Tree(taken["spans"])

    def inside(i):              # the span opened within the stretch
        return lo <= tree.spans[i][1] <= hi

    owner, unmatched = [], 0
    for s, e, name, corr in ops:
        t = launches.get(corr)
        if t is None:
            unmatched += 1
        owner.append(None if t is None else tree.innermost(t))
    device_s: Dict[str, float] = {}
    forward_ops, state_ns = 0, 0
    nccl: Dict[int, list] = {}
    for (s, e, name, _), i in zip(ops, owner):
        sec = (min(e, hi) - max(s, lo)) * 1e-9
        key = tree.spans[i][0] if i is not None else "none"
        device_s[key] = device_s.get(key, 0.0) + sec
        if tree.within(i, "forward") is not None:
            forward_ops += 1
        if tree.within(i, "engine.state") is not None:
            state_ns += min(e, hi) - max(s, lo)
        x = tree.within(i, "exchange")
        if x is not None and "nccl" in name.lower():
            nccl.setdefault(x, []).append((s, e))
    exchanges, bad = [], 0
    for i, sp in enumerate(tree.spans):
        if sp[0] != "exchange" or not inside(i):
            continue
        kernels = nccl.get(i, [])
        if len(kernels) != 1:
            bad += 1
            continue
        exchanges.append((sp[4]["seq"], sp[4]["bytes_in"]) + kernels[0])

    images = tree.outermost("generate")
    forwards = tree.outermost("forward")
    fwd_ns = {True: 0, False: 0}
    for i in forwards:
        fwd_ns[inside(i)] += tree.spans[i][2] - tree.spans[i][1]
    gaps: Dict[str, float] = {}
    busy = _union([(max(s, lo), min(e, hi)) for s, e, _, _ in ops])
    edges = [lo] + [x for b in busy for x in b] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            i = tree.innermost((a + b) // 2)
            key = tree.spans[i][0] if i is not None else "none"
            gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-9
    counters = taken.get("counters", {})
    return {
        "ops": len(ops), "unmatched": unmatched,
        "device_s": device_s, "forward_ops": forward_ops,
        "state_s": state_ns * 1e-9,
        "rounds": sum(1 for i, sp in enumerate(tree.spans)
                      if sp[0] == "engine.round" and inside(i)),
        "images_in": sum(1 for i in images if inside(i)),
        "images_out": sum(1 for i in images if not inside(i)),
        "forward_host_s_in": fwd_ns[True] * 1e-9,
        "forward_host_s_out": fwd_ns[False] * 1e-9,
        "exchanges": exchanges,
        "exchange_spans": len(exchanges) + bad,
        "exchange_unpaired": bad,
        "bytes_in_per_image": (counters.get("exchange.bytes_in", 0)
                               / len(images) if images else None),
        "idle_s": gaps,
    }


def joined(s: Dict) -> bool:
    """Whether a summary's join covers its stretch."""
    return s["ops"] > 0 and s["unmatched"] <= MAX_UNMATCHED * s["ops"]


def host_us_per_op(summaries: Sequence[Dict]) -> Optional[float]:
    """Host microseconds of the ``forward`` spans an image, over the
    unprofiled images, over the device operations an image launched inside
    ``forward`` spans in the stretch; mean over the processes."""
    vals = []
    for s in summaries:
        if (not joined(s) or not s["images_out"] or not s["images_in"]
                or not s["forward_ops"]):
            return None
        host = s["forward_host_s_out"] / s["images_out"]
        vals.append(1e6 * host / (s["forward_ops"] / s["images_in"]))
    return float(np.mean(vals)) if vals else None


def profiler_host_cost(summaries: Sequence[Dict]) -> Optional[float]:
    """The ``forward`` spans' host seconds an image inside the stretch over
    outside it, mean over the processes: the profiler's own host cost."""
    vals = [(s["forward_host_s_in"] / s["images_in"])
            / (s["forward_host_s_out"] / s["images_out"])
            for s in summaries if s["images_in"] and s["images_out"]
            and s["forward_host_s_out"]]
    return float(np.mean(vals)) if vals else None


def state_ms_per_round(summaries: Sequence[Dict]) -> Optional[float]:
    """Device milliseconds of the operations launched inside
    ``engine.state`` spans, over the stretch's rounds."""
    s = summaries[0] if len(summaries) == 1 else None
    if s is None or not joined(s) or not s["rounds"]:
        return None
    return 1e3 * s["state_s"] / s["rounds"]


def queue_wait_p88(stamps: Sequence[Tuple[int, Optional[int]]],
                   end_ns: int) -> Optional[float]:
    """88th percentile of ``admit_ns - submit_ns`` in seconds over the
    requests submitted in the window, ``(submit_ns, admit_ns or None)``; a
    request not admitted by ``end_ns`` counts with what it had waited."""
    waits = [((a if a else end_ns) - s) * 1e-9 for s, a in stamps]
    return float(np.percentile(waits, 88)) if waits else None


def _exchange_split(summaries: Sequence[Dict]):
    """Per rank, the (wait ns, bytes, transfer ns) of each collective that
    every rank ran inside its ``exchange`` spans, matched by ``seq``, and
    the median spread of the ranks' ends; None, with the reason, where a
    rank's spans and kernels differ in count."""
    for r, s in enumerate(summaries):
        if not joined(s) or s["exchange_unpaired"] or not s["exchanges"]:
            return None, (f"rank {r}: {s['exchange_spans']} exchange spans, "
                          f"{s['exchange_unpaired']} without one NCCL kernel, "
                          f"{s['unmatched']} of {s['ops']} operations "
                          "unmatched")
    by_seq = [{x[0]: x for x in s["exchanges"]} for s in summaries]
    seqs = sorted(set.intersection(*(set(b) for b in by_seq)))
    if not seqs:
        return None, "no collective common to every rank"
    per_rank = [[] for _ in summaries]
    spreads = []
    for q in seqs:
        xs = [b[q] for b in by_seq]
        latest = max(x[2] for x in xs)
        spreads.append(max(x[3] for x in xs) - min(x[3] for x in xs))
        for r, (_, nbytes, start, end) in enumerate(xs):
            per_rank[r].append((latest - start, nbytes, end - latest))
    spread = float(np.median(spreads))
    if spread > MAX_END_SPREAD_NS:
        return None, (f"the ranks' ends of one collective spread "
                      f"{spread / 1e3:.1f} us on median: clocks disagree")
    return per_rank, spread


def exchange_wait_ms_per_image(summaries: Sequence[Dict]) -> Optional[float]:
    """Per rank, the sum over the stretch's collectives of the latest start
    of the collective's kernel across the ranks less its own start; mean
    over the ranks, in ms an image."""
    per_rank, _ = _exchange_split(summaries)
    images = summaries[0]["images_in"] if summaries else 0
    if per_rank is None or not images:
        return None
    return float(np.mean([sum(w for w, _, _ in xs) for xs in per_rank])
                 ) * 1e-6 / images


def exchange_gbps(summaries: Sequence[Dict]) -> Optional[float]:
    """Per rank, its bytes received over the stretch's collectives over
    the sum of (its kernel's end less the latest start across the ranks);
    mean over the ranks, in GB/s (bytes a nanosecond)."""
    per_rank, _ = _exchange_split(summaries)
    if per_rank is None:
        return None
    vals = []
    for xs in per_rank:
        ns = sum(t for _, _, t in xs)
        if ns <= 0:
            return None
        vals.append(sum(b for _, b, _ in xs) / ns)
    return float(np.mean(vals))


def lines(summaries: Sequence[Dict]) -> List[str]:
    """What a traced run prints before its result line: each process's
    unmatched share and idle seconds by program span, and the exchange's
    check where there is one."""
    out = []
    for r, s in enumerate(summaries):
        share = s["unmatched"] / s["ops"] if s["ops"] else 0.0
        idle = sorted(s["idle_s"].items(), key=lambda kv: -kv[1])
        out.append(f"program idle by span (process {r}): "
                   + ", ".join(f"{k} {v!r} s" for k, v in idle)
                   + f"; unmatched launches {s['unmatched']} of {s['ops']} "
                   f"({100 * share:.3f} %)")
    if any(s["exchange_spans"] for s in summaries):
        per_rank, why = _exchange_split(summaries)
        out.append(f"exchange: {why}" if per_rank is None else
                   f"exchange: {len(per_rank[0])} collectives on every "
                   f"rank, median end spread {why / 1e3:.2f} us")
    return out
