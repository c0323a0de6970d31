"""Pluggable allocation planners behind a string registry (reference:
``repro.core.planners``, DESIGN.md §8).

A :class:`Planner` turns per-device effective speeds plus the schedule knobs
of a :class:`~repro_torch.core.pipeline.StadiConfig` into one
:class:`ExecutionPlan` — the single currency every execution backend
consumes. Registered planners:

    "uniform"   DistriFusion baseline: equal steps, equal patches (Table III "None")
    "spatial"   +SA: equal steps, Eq. 5 patches
    "temporal"  +TA: Eq. 4 steps, equal patches
    "stadi"     +TA+SA: Eq. 4 steps, Eq. 5 patches (the paper's Algorithm 1)
    "makespan"  beyond-paper exhaustive-over-tiers makespan-optimal allocator

The joint planners of the later axes (stadi_pipefuse, stadi_guidance,
stadi_seq, stadi_video) come with the slices that port those axes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Protocol, Sequence, runtime_checkable

from repro_torch.core import schedule as sched_lib
from repro_torch.core.schedule import TemporalPlan


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A complete allocation decision: who steps when, on which rows.

    temporal: per-device step counts / interval ratios (Eq. 4 or uniform)
    patches:  token-rows per device, sum == p_total (Eq. 5 or uniform)
    planner:  provenance — registry name of the planner that produced it
    speeds:   the effective speeds the plan was computed from
    modeled_interval_cost: planner-modeled cost per fine-step interval
        (the makespan planner fills this in)
    stages / guidance / seq / frames: the later axes of the reference's
        six-axis plan; None on every plan this slice's planners return.
    """
    temporal: TemporalPlan
    patches: List[int]
    planner: str
    speeds: List[float]
    modeled_interval_cost: Optional[float] = None
    stages: Optional[List[int]] = None
    guidance: Optional[object] = None
    seq: Optional[object] = None
    frames: Optional[object] = None

    @property
    def active(self) -> List[int]:
        return [i for i in self.temporal.active if self.patches[i] > 0]


@runtime_checkable
class Planner(Protocol):
    """Anything callable as ``planner(speeds, knobs, p_total)``.

    ``knobs`` is any object exposing ``m_base``, ``m_warmup``, ``a``, ``b``,
    ``tiers``, ``granularity`` and ``min_patch`` (in practice a
    :class:`~repro_torch.core.pipeline.StadiConfig`).
    """

    def __call__(self, speeds: Sequence[float], knobs, p_total: int) -> ExecutionPlan:
        ...


PLANNERS: Dict[str, Planner] = {}


def register_planner(name: str) -> Callable[[Planner], Planner]:
    def deco(fn: Planner) -> Planner:
        PLANNERS[name] = fn
        return fn
    return deco


def get_planner(name: str) -> Planner:
    try:
        return PLANNERS[name]
    except KeyError:
        raise KeyError(f"unknown planner {name!r}; registered: "
                       f"{sorted(PLANNERS)}") from None


# ----------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------

def _uniform_temporal(n: int, m_base: int, m_warmup: int) -> TemporalPlan:
    return TemporalPlan([m_base] * n, [1] * n, [False] * n, m_base, m_warmup)


def _equal_patches(plan: TemporalPlan, p_total: int) -> List[int]:
    """Equal split of token-rows over the plan's active devices."""
    active = plan.active
    base, rem = divmod(p_total, len(active))
    out, j = [], 0
    for i in range(len(plan.steps)):
        if i not in active:
            out.append(0)
        else:
            out.append(base + (1 if j < rem else 0))
            j += 1
    return out


# ----------------------------------------------------------------------
# registered planners
# ----------------------------------------------------------------------

@register_planner("uniform")
def uniform_planner(speeds, knobs, p_total) -> ExecutionPlan:
    """DistriFusion patch parallelism: no adaptation at all."""
    plan = _uniform_temporal(len(speeds), knobs.m_base, knobs.m_warmup)
    return ExecutionPlan(plan, _equal_patches(plan, p_total), "uniform",
                         list(speeds))


@register_planner("spatial")
def spatial_planner(speeds, knobs, p_total) -> ExecutionPlan:
    """+SA: uniform steps, patches mended by Eq. 5."""
    plan = _uniform_temporal(len(speeds), knobs.m_base, knobs.m_warmup)
    patches = sched_lib.spatial_allocation(speeds, plan.steps, p_total,
                                           knobs.granularity, knobs.min_patch)
    return ExecutionPlan(plan, patches, "spatial", list(speeds))


@register_planner("temporal")
def temporal_planner(speeds, knobs, p_total) -> ExecutionPlan:
    """+TA: Eq. 4 steps, equal patches over the surviving devices."""
    plan = sched_lib.temporal_allocation(speeds, knobs.m_base, knobs.m_warmup,
                                         knobs.a, knobs.b, knobs.tiers)
    return ExecutionPlan(plan, _equal_patches(plan, p_total), "temporal",
                         list(speeds))


@register_planner("stadi")
def stadi_planner(speeds, knobs, p_total) -> ExecutionPlan:
    """Full STADI: Eq. 4 then Eq. 5 (Algorithm 1 lines 1-6)."""
    plan = sched_lib.temporal_allocation(speeds, knobs.m_base, knobs.m_warmup,
                                         knobs.a, knobs.b, knobs.tiers)
    patches = sched_lib.spatial_allocation(speeds, plan.steps, p_total,
                                           knobs.granularity, knobs.min_patch)
    return ExecutionPlan(plan, patches, "stadi", list(speeds))


@register_planner("makespan")
def makespan_planner(speeds, knobs, p_total) -> ExecutionPlan:
    """Beyond-paper DP: exhaustive tier search minimizing modeled makespan.

    Searches exactly ``knobs.tiers`` (ratios not dividing the post-warmup
    step count are dropped); pass ``tiers=(1, 2, 4)`` for the generalized
    ratios of DESIGN.md §7 — the default (1, 2) restricts the search to the
    paper's two tiers.
    """
    plan, patches, cost = sched_lib.makespan_optimal_allocation(
        speeds, knobs.m_base, knobs.m_warmup, p_total,
        granularity=knobs.granularity, tiers=knobs.tiers, b=knobs.b)
    return ExecutionPlan(plan, patches, "makespan", list(speeds),
                         modeled_interval_cost=cost)
