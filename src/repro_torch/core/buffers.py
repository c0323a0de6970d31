"""DistriFusion-style stale activation buffers (reference:
``repro.core.buffers``).

``Published`` holds the full-image per-layer K/V as of the last completed
sync interval. Within an interval every worker reads ``published`` for
remote regions (stale) while its own fresh local K/V is read instead inside
``dit.forward_patch``. Workers' newly published local K/V accumulate in
``pending`` and are merged at the interval boundary — the emulation-exact
counterpart of an async broadcast landing by the next sync point.

Nothing here writes into a tensor it was given: the engine keeps aliases of
old ``Published`` objects (``prev_published`` for prediction), so
:func:`merge` and :func:`extrapolate` always return new tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class Published:
    k: torch.Tensor         # [L, B, N_tokens, H, hd] ([2, L, ...] guided)
    v: torch.Tensor
    step: int = 0           # fine-step index of last merge


def publish_local(pending: Dict[int, Tuple], worker: int, k_local, v_local,
                  tok_start: int) -> None:
    """Queue worker's fresh local K/V ([L,B,Nl,H,hd]) for the next merge."""
    pending[worker] = (k_local, v_local, tok_start)


def merge(published: Published, pending: Dict[int, Tuple],
          step: int, axis: int = 2) -> Published:
    """Apply all queued regional updates into NEW tensors; ``published``
    itself is left untouched. ``axis`` is the token axis: 2 for plain
    [L,B,N,H,hd] buffers, 3 for the branch-stacked [2,L,B,N,H,hd] guidance
    buffers (DESIGN.md §12)."""
    k, v = published.k.clone(), published.v.clone()
    for _, (kl, vl, start) in sorted(pending.items()):
        k.narrow(axis, start, kl.shape[axis]).copy_(kl)
        v.narrow(axis, start, vl.shape[axis]).copy_(vl)
    return Published(k, v, step)


def extrapolation_factor(prev_step: int, last_step: int, fine_step: int) -> float:
    """Linear-extrapolation coefficient for the "predict" exchange kind:
    how far past the last full refresh the boundary at ``fine_step`` sits,
    in units of the last refresh gap."""
    gap = last_step - prev_step
    if gap <= 0:
        return 0.0
    return (fine_step - last_step) / gap


def extrapolate_arrays(last, prev, f: float):
    """The Reuse-then-Predict rule: ``last + f*(last - prev)`` in last's
    dtype."""
    return (last + f * (last - prev)).to(last.dtype)


def extrapolate(prev: Optional[Published], last: Published,
                fine_step: int) -> Published:
    """Predict the remote K/V at ``fine_step`` from the last two exchanged
    versions (Reuse-then-Predict). Until two refreshes have landed there is
    nothing to difference, so fall back to stale reuse of ``last``."""
    if prev is None:
        return last
    f = extrapolation_factor(prev.step, last.step, fine_step)
    if f == 0.0:
        return last
    return Published(extrapolate_arrays(last.k, prev.k, f),
                     extrapolate_arrays(last.v, prev.v, f), last.step)
