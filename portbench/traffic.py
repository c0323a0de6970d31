"""The one general traffic generator: a traffic mix is a data file under
``traffic/`` (``<name>.json``) and this module turns it and a seed into
requests. Everything the program is handed is made here or in
:mod:`portbench.weights`.

A mix gives its arrival process (``closed``: ``clients`` callers that each
send the next request when the last is done; ``poisson``: open-loop
arrivals at ``rate_per_s``), the share of guided requests and the range
of their scales, the class vocabulary, and for prompt models the word
counts and the words. So that every seed carries the same work, the sizes
(gaps, guided flags, scales, word counts) come from a fixed set of
``period`` quantiles of their distributions, which each period of the
sequence shuffles anew; only which class, which words and which order are
the seed's.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def _quantiles(period: int) -> np.ndarray:
    return (np.arange(period) + 0.5) / period


def _gaps(mix: dict, period: int) -> np.ndarray:
    """Exponential gaps at the mix's rate, their mean exactly 1 / rate."""
    g = -np.log1p(-_quantiles(period))
    return g / g.mean() / float(mix["rate_per_s"])


def _word_counts(spec: dict, period: int) -> np.ndarray:
    """Quantiles of P(n) proportional to n^-tail on [min, max]."""
    n = np.arange(spec["min"], spec["max"] + 1)
    cdf = np.cumsum(n ** -float(spec["tail"]))
    cdf /= cdf[-1]
    return n[np.searchsorted(cdf, _quantiles(period))]


def requests(mix: dict, seed: int, count: int) -> List[Dict]:
    """``count`` requests in order: ``index`` (its row of the latents),
    ``cls``, ``cfg_scale`` (None when unguided), ``prompt`` (None for a
    class model), and ``due_s`` (open loops: seconds after the window
    opens that it is due)."""
    period = int(mix.get("period", 64))
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0x7261]))
    guided = np.arange(period) < round(float(mix.get("guided_share", 0.0)) * period)
    lo, hi = mix.get("cfg_scale", [0.0, 0.0])
    scales = lo + (hi - lo) * _quantiles(period)
    words = mix.get("prompt_words")
    counts = _word_counts(words, period) if words else None
    poisson = mix["arrival"] == "poisson"
    gaps = _gaps(mix, period) if poisson else None
    out, due = [], 0.0
    for start in range(0, count, period):
        perm = {k: rng.permutation(period) for k in ("g", "s", "w", "a")}
        for j in range(min(period, count - start)):
            i = start + j
            req = {"index": i, "cls": int(rng.integers(mix["classes"])),
                   "cfg_scale": (float(scales[perm["s"][j]])
                                 if guided[perm["g"][j]] else None),
                   "prompt": None, "due_s": None}
            if counts is not None:
                n = int(counts[perm["w"][j]])
                req["prompt"] = " ".join(rng.choice(mix["vocabulary"], n))
            if poisson:
                due += float(gaps[perm["a"][j]])
                req["due_s"] = due
            out.append(req)
    return out


def open_loop_count(mix: dict, seconds: float) -> int:
    """Requests an open loop sends in ``seconds`` (with a margin)."""
    return int(math.ceil(float(mix["rate_per_s"]) * seconds * 1.2)) + 64


#: fewer seconds than any request of these cells takes on the card
FASTEST_S = 0.05


def closed_loop_count(seconds: float, clients: int) -> int:
    """A bound on the requests a closed loop can finish in ``seconds``."""
    return int(seconds / FASTEST_S) + 4 * clients + 64
