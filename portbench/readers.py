"""Reductions the metric readers under ``metrics/`` share. Each takes the
run's facts ``t`` (see ``run.py``) and returns a number, or None where the
run holds nothing to read: an untraced run, a stretch with no device
operation, or a chip whose peaks the yardstick does not list."""
from __future__ import annotations

from typing import Optional

import numpy as np

from portbench import flops, trace


def _traces(t):
    return t.get("traces") or []


def _units(tr) -> int:
    """Images (generate) or rounds (serve) of a traced stretch."""
    return tr.get("images") or tr.get("rounds") or 0


def idle_share(t) -> Optional[float]:
    """Percent of the traced stretch's seconds with no device operation
    running, mean over the cards: busy and wall seconds both of the one
    traced stretch (the busy intervals are clipped to it, so the share
    is never below 0). An NCCL kernel that waits for the other ranks
    runs on the card, so that wait reads as busy."""
    trs = _traces(t)
    if not trs or not all(tr["summary"]["busy_s"] > 0 for tr in trs):
        return None
    return 100.0 * float(np.mean([1 - tr["summary"]["busy_s"]
                                  / tr["summary"]["window_s"] for tr in trs]))


def mfu(t) -> Optional[float]:
    """Percent of the cards' bf16 peak: the operations of the traced
    stretch's forwards (a full-image forward that every rank repeats
    counted once, from rank 0) over the stretch's own seconds (the
    profiler's wall interval, mean over the cards), the chips and the
    peak."""
    trs, peak = _traces(t), t.get("peaks")
    if not trs or peak is None or idle_share(t) is None:
        return None
    ops = 0.0
    for r, tr in enumerate(trs):
        for B, nl, n, lc, full in tr["forwards"]:
            if r == 0 or not full:
                ops += flops.dit_forward(t["model"], B, nl, n, lc)
    seconds = float(np.mean([tr["summary"]["window_s"] for tr in trs]))
    return 100.0 * ops / (seconds * t["chips"] * peak["bf16"])


def roofline(t, kernel: str) -> Optional[float]:
    """Percent: the kernel's least time over the launches the stretch made
    (from their shapes) over their device time, summed over the cards;
    None where a card's launches could not be matched to its calls."""
    trs, peak = _traces(t), t.get("peaks")
    if not trs or peak is None:
        return None
    least = measured = 0.0
    for tr in trs:
        seconds = tr["summary"]["attention_s"]
        if seconds is None:
            return None
        for call in tr["attention"]:
            if call[0] == kernel:
                least += flops.least_seconds(
                    *flops.attention_kernel(*call[1:]), peak)
        measured += seconds[kernel]
    if least == 0.0 or measured == 0.0:
        return None
    return 100.0 * least / measured


def per_unit(t, value) -> Optional[float]:
    """Mean over the cards of ``value(summary)`` an image (or round)."""
    trs = [tr for tr in _traces(t) if _units(tr)]
    if not trs or idle_share(t) is None:
        return None
    return float(np.mean([value(tr["summary"]) / _units(tr) for tr in trs]))


def kernels_per_image(t):
    return per_unit(t, lambda s: s["kernels"])


def nccl_ms_per_image(t):
    return per_unit(t, lambda s: 1e3 * trace.kernel_seconds(s, "nccl"))


def lanes_per_dispatch(t):
    return t["lanes"] / t["dispatches"] if t.get("dispatches") else None
