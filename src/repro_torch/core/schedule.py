"""STADI scheduling: temporal adaptation (Eq. 4) + spatial patch-size
mending (Eq. 5) — the port's own copy of ``repro.core.schedule`` (pure
Python; tests hold it equal to the reference).

Temporal adaptation quantizes per-device step counts so that the set of
post-warmup step *intervals* has a minimal least common multiple (the paper
restricts ratios to {1, 2}: fast devices take M_base steps, medium devices
take (M_base + M_warmup)/2 — i.e. exactly half the post-warmup steps — and
devices slower than b*v_max are excluded). The beyond-paper generalized
allocator extends ratios to {1, 2, 4} and a makespan-optimal search
(DESIGN.md §7), still LCM-bounded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class TemporalPlan:
    steps: List[int]          # M_i per device (0 if excluded)
    ratios: List[int]         # post-warmup interval ratio r_i (fine steps per own step)
    excluded: List[bool]
    m_base: int
    m_warmup: int

    @property
    def active(self) -> List[int]:
        return [i for i, e in enumerate(self.excluded) if not e]

    @property
    def lcm(self) -> int:
        rs = [r for r, e in zip(self.ratios, self.excluded) if not e]
        return math.lcm(*rs) if rs else 1


def effective_speed(c: float, rho: float) -> float:
    """Paper §III-B: capability c_i scaled by background occupancy ρ_i."""
    return c * max(0.0, 1.0 - rho)


def temporal_allocation(speeds: Sequence[float], m_base: int, m_warmup: int,
                        a: float = 0.75, b: float = 0.25,
                        tiers: Sequence[int] = (1, 2)) -> TemporalPlan:
    """Eq. (4). ``tiers`` lists the allowed step-interval ratios (paper: (1,2)).

    Post-warmup fine steps F = m_base - m_warmup must be divisible by every
    tier ratio; we require m_base/m_warmup chosen accordingly (validated).
    """
    if not speeds:
        raise ValueError("need at least one device")
    if not (0.0 < b < a < 1.0):
        raise ValueError(f"need 0 < b < a < 1, got a={a} b={b}")
    if m_warmup >= m_base:
        raise ValueError("m_warmup must be < m_base")
    F = m_base - m_warmup
    for r in tiers:
        if F % r:
            raise ValueError(f"post-warmup steps {F} not divisible by tier ratio {r}")

    vmax = max(speeds)
    steps, ratios, excluded = [], [], []
    # thresholds: tier k gets speeds in (thr_{k+1}, thr_k]; paper has 2 tiers
    # with thresholds (a*vmax, vmax], (b*vmax, a*vmax]. Generalized tiers
    # interpolate geometrically between a and b.
    n_t = len(tiers)
    if n_t == 1:
        thr = [b]                 # single tier: every non-excluded device
    elif n_t == 2:
        thr = [a, b]
    else:
        thr = [a * (b / a) ** (k / (n_t - 1)) for k in range(n_t)]
    for v in speeds:
        if v <= b * vmax:
            steps.append(0); ratios.append(0); excluded.append(True)
            continue
        tier = n_t - 1
        for k, th in enumerate(thr):
            if v > th * vmax:
                tier = k
                break
        r = tiers[tier]
        steps.append(m_warmup + F // r)
        ratios.append(r)
        excluded.append(False)
    if all(excluded):
        # degenerate: keep the fastest device
        i = max(range(len(speeds)), key=lambda j: speeds[j])
        steps[i], ratios[i], excluded[i] = m_base, 1, False
    return TemporalPlan(steps, ratios, excluded, m_base, m_warmup)


def spatial_allocation(speeds: Sequence[float], steps: Sequence[int],
                       p_total: int, granularity: int = 1,
                       min_patch: Optional[int] = None) -> List[int]:
    """Eq. (5): P_i ∝ v_i / M_i, integerized to multiples of ``granularity``
    by largest-remainder rounding; excluded devices (M_i == 0) get 0.

    The paper's "hardware/operator constraints (e.g. power-of-two
    dimensions)" are honored through ``granularity`` (we allocate in slabs).
    """
    if p_total % granularity:
        raise ValueError("p_total must be a multiple of granularity")
    min_patch = granularity if min_patch is None else min_patch
    rate = [ (v / m) if m else 0.0 for v, m in zip(speeds, steps) ]
    total_rate = sum(rate)
    if total_rate <= 0:
        raise ValueError("no active devices")
    slots = p_total // granularity
    ideal = [r / total_rate * slots for r in rate]
    base = [int(math.floor(x)) for x in ideal]
    # every active device gets at least min_patch worth of slots
    min_slots = max(1, min_patch // granularity)
    n_active = sum(1 for r in rate if r > 0)
    if slots < n_active * min_slots:
        raise ValueError(
            f"p_total={p_total} cannot give {n_active} active devices "
            f"min_patch={min_patch} at granularity={granularity}")
    for i, r in enumerate(rate):
        if r > 0:
            base[i] = max(base[i], min_slots)
    rem = slots - sum(base)
    order = sorted(range(len(ideal)), key=lambda i: ideal[i] - base[i], reverse=True)
    for i in order:
        if rem <= 0:
            break
        if rate[i] > 0:
            base[i] += 1
            rem -= 1
    # lifting to min_slots may have overshot: take granules back from the
    # devices furthest above their ideal share, never dropping below min_slots
    while rem < 0:
        j = max((j for j in range(len(base)) if rate[j] > 0 and base[j] > min_slots),
                key=lambda j: base[j] - ideal[j])
        base[j] -= 1
        rem += 1
    assert sum(base) == slots, (base, slots)
    return [b * granularity for b in base]


def patch_bounds(patch_sizes: Sequence[int]) -> List[tuple]:
    """Cumulative [start, end) row ranges per device (0-size for excluded)."""
    out, start = [], 0
    for p in patch_sizes:
        out.append((start, start + p))
        start += p
    return out


def makespan_optimal_allocation(speeds: Sequence[float], m_base: int, m_warmup: int,
                                p_total: int, granularity: int = 1,
                                tiers: Sequence[int] = (1, 2, 4),
                                b: float = 0.25,
                                fixed_overhead: float = 0.05):
    """Beyond-paper: exhaustive-over-tiers allocator minimizing the modeled
    makespan  max_i r_i_interval  where a device with ratio r contributes
    r * (fixed + P_i/v_i-normalized work) per LCM interval. Searches every
    tier assignment (N small), then mends patches by Eq. 5. Returns
    (TemporalPlan, patches, modeled_interval_cost).
    """
    import itertools
    N = len(speeds)
    vmax = max(speeds)
    i_fast = max(range(N), key=lambda j: speeds[j])
    active = [v > b * vmax for v in speeds]
    F = m_base - m_warmup
    tiers = [t for t in tiers if F % t == 0]
    best = None
    for assign in itertools.product(range(len(tiers)), repeat=N):
        ratios = [tiers[k] if act else 0 for k, act in zip(assign, active)]
        if ratios[i_fast] != 1:
            continue            # quality anchor: fastest device keeps M_base
                                # steps (same invariant as the paper's Eq. 4)
        if not any(ratios):
            continue
        steps = [m_warmup + F // r if r else 0 for r in ratios]
        patches = spatial_allocation(speeds, steps, p_total, granularity)
        # per fine-step interval of the fastest tier, device i runs 1/r_i of
        # a step; interval cost normalized per fine step:
        cost = 0.0
        for v, r, p in zip(speeds, ratios, patches):
            if r:
                cost = max(cost, (fixed_overhead + p / p_total) / v / r)
        if best is None or cost < best[2]:
            plan = TemporalPlan(steps, ratios, [not a for a in active], m_base, m_warmup)
            best = (plan, patches, cost)
    return best
