"""Boundary-exchange policies and the analytic wire-row helpers — the
framework-free half of ``repro.core.comm`` (DESIGN.md §10).

The :class:`BoundaryExchange` policy decides, per interval boundary, whether
the latent/KV exchange happens synchronously ("full"), is skipped against
stale buffers ("skip", DistriFusion-style stale-async with a corrective
refresh cadence), or is replaced by local extrapolation of the remote slabs
("predict", Reuse-then-Predict). The schedule IR (:mod:`repro_torch.core.
events`) consults the policy when lowering; executors only ever see the
resulting per-boundary kind.

The collectives themselves (padded and broadcast uneven all-gathers, the
stage handoff) and the sequence-parallel "ring" policy come with the
multi-device slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence


def ring_hop_rows(segments: Sequence[int]) -> int:
    """Modeled wire rows per rank for ONE ring hop of sequence-parallel
    attention (DESIGN.md §13): every rank forwards one K/V segment to its
    ring neighbor per hop, padded to max(segments). A single segment (or
    none) hops nothing."""
    active = [s for s in segments if s > 0]
    if len(active) <= 1:
        return 0
    return max(active)


def uneven_all_gather_rows(sizes: Sequence[int]) -> int:
    """Modeled wire rows per rank for the padded uneven all-gather: each of
    the N participating ranks receives N-1 remote slabs padded to
    max(sizes). A single participant (or none) exchanges nothing."""
    active = [s for s in sizes if s > 0]
    if len(active) <= 1:
        return 0
    return (len(active) - 1) * max(active)


# ----------------------------------------------------------------------
# boundary-exchange policies (DESIGN.md §10)
# ----------------------------------------------------------------------

#: per-boundary verdicts a policy may emit
EXCHANGE_KINDS = ("full", "skip", "predict")


@dataclasses.dataclass(frozen=True)
class BoundaryExchange:
    """Decides the exchange kind at each 0-based interval boundary.

    ``refresh_every`` = E means one corrective FULL refresh every E
    boundaries (so E-1 of every E boundaries are degraded); E = 1 is fully
    synchronous. The final boundary of a run is always forced to "full" by
    the IR regardless of the policy (the image must assemble).
    """
    name: str
    refresh_every: int = 1
    degraded_kind: str = "full"          # what non-refresh boundaries emit

    def __post_init__(self):
        if self.refresh_every < 1:
            raise ValueError(f"refresh_every must be >= 1, got "
                             f"{self.refresh_every}")
        if self.degraded_kind not in EXCHANGE_KINDS:
            raise ValueError(f"unknown exchange kind {self.degraded_kind!r}")

    def kind(self, boundary_index: int) -> str:
        if (boundary_index + 1) % self.refresh_every == 0:
            return "full"
        return self.degraded_kind


EXCHANGES: Dict[str, Callable[[int], BoundaryExchange]] = {}


def register_exchange(name: str):
    def deco(factory):
        EXCHANGES[name] = factory
        return factory
    return deco


def get_exchange(name: str, refresh_every: int = 2) -> BoundaryExchange:
    """Look up a boundary-exchange policy by registry name.

    ``refresh_every`` parameterizes the degraded policies (ignored by
    "sync"): stale_async/predictive skip/predict on ``refresh_every - 1``
    of every ``refresh_every`` boundaries.
    """
    try:
        factory = EXCHANGES[name]
    except KeyError:
        raise KeyError(f"unknown exchange policy {name!r}; registered: "
                       f"{sorted(EXCHANGES)}") from None
    return factory(refresh_every)


@register_exchange("sync")
def _sync(refresh_every: int) -> BoundaryExchange:
    """Blocking latent all-gather + KV merge at every boundary."""
    return BoundaryExchange("sync", refresh_every=1)


@register_exchange("stale_async")
def _stale_async(refresh_every: int) -> BoundaryExchange:
    """DistriFusion-style: skip the boundary exchange on E-1 of every E
    boundaries; workers denoise against neighbor slabs up to E intervals
    stale, with a corrective full refresh every E-th boundary."""
    return BoundaryExchange("stale_async", refresh_every=refresh_every,
                            degraded_kind="skip")


@register_exchange("predictive")
def _predictive(refresh_every: int) -> BoundaryExchange:
    """Reuse-then-Predict: on non-refresh boundaries, linearly extrapolate
    the remote K/V slabs from the last two fully-exchanged versions (falls
    back to stale reuse until two refreshes have landed)."""
    return BoundaryExchange("predictive", refresh_every=refresh_every,
                            degraded_kind="predict")
