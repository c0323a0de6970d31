"""Classifier-free guidance as a fourth scheduling dimension (DESIGN.md §12)
— the port's own copy of ``repro.core.guidance``, which is framework-free;
the port imports nothing of the JAX package, so it keeps this copy.

Every production diffusion deployment runs CFG: two denoiser evaluations per
fine step — conditional and unconditional — combined as

    eps = eps_u + w * (eps_c - eps_u)                 (w = cfg_scale)

STADI schedules steps, patches and depth stages; this module makes the
cond/uncond split itself schedulable work (the "Conditional Guidance
Scheduling" direction of PAPERS.md). A :class:`GuidancePlan` names one of
three placements:

    fused        every patch worker computes BOTH branches in one
                 branch-vmapped dispatch (the fused-batch reference). No
                 cross-branch traffic; per-row compute and staged-K/V
                 traffic double.
    split        the cluster is bipartitioned into a cond group and an
                 uncond group sized by aggregate effective speed
                 (:func:`guidance_groups`); logical patch worker i is a
                 PAIR (cond_devices[i], uncond_devices[i]) computing the
                 same row slab, one branch each. Only the per-step epsilon
                 combine crosses the group boundary — the staged K/V of
                 each branch never leaves its group, which is the
                 structural comm saving over fused CFG. Numerics are
                 bitwise-identical to fused under the same
                 (temporal, patches) schedule by construction: the mode
                 moves work between devices, never between math.
    interleaved  split placement + DistriFusion-style staleness applied to
                 the UNCOND branch of STRAGGLER pairs (pair speed below
                 the fastest pair's): on every interval except each
                 ``uncond_refresh``-th, a straggler's uncond device idles
                 and its cond side reuses the eps_u cached at the last
                 refresh interval — staleness is spent exactly where
                 compute is scarce, fast pairs stay exact. Lossy
                 (benchmarked < 1 dB PSNR drift).

The schedule IR (:mod:`repro_torch.core.events`) lowers split/interleaved
plans with a :class:`~repro_torch.core.events.GuidanceExchange` event per
adaptive interval, so every executor (in this port: emulated and simulate)
agrees on exactly which intervals recompute the uncond branch and where the
eps combine happens.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

#: reserved class id meaning "the unconditional (null) branch" — see
#: repro_torch.models.diffusion.dit._cond_vector
NULL_COND = -1

GUIDANCE_MODES = ("fused", "split", "interleaved")


@dataclasses.dataclass(frozen=True)
class GuidancePlan:
    """One guidance-placement decision, carried on an ExecutionPlan.

    mode: "fused" | "split" | "interleaved"
    scale: the CFG weight w (> 0; w == 1 degenerates to conditional-only)
    cond_devices / uncond_devices: split/interleaved placement — parallel
        tuples, pair i computes logical patch worker i's slab (cond branch
        on cond_devices[i], uncond on uncond_devices[i]). Empty for fused.
    uncond_refresh: interleaved cadence E — a reusing worker's uncond
        branch runs on each E-th adaptive interval and idles (eps_u
        reused) on the others.
    reuse_workers: interleaved only — the logical workers whose uncond
        branch reuses (the paper-spirit "slow devices": straggler pairs,
        filled in by :func:`split_plan`). None = every worker reuses.
    """
    mode: str
    scale: float
    cond_devices: Tuple[int, ...] = ()
    uncond_devices: Tuple[int, ...] = ()
    uncond_refresh: int = 2
    reuse_workers: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.mode not in GUIDANCE_MODES:
            raise ValueError(f"unknown guidance mode {self.mode!r}; one of "
                             f"{GUIDANCE_MODES}")
        if self.scale <= 0.0:
            raise ValueError(f"cfg_scale must be > 0 for guided generation, "
                             f"got {self.scale}")
        if self.uncond_refresh < 1:
            raise ValueError(f"uncond_refresh must be >= 1, got "
                             f"{self.uncond_refresh}")
        if self.mode == "fused":
            if self.cond_devices or self.uncond_devices:
                raise ValueError("fused guidance has no device groups")
            return
        if len(self.cond_devices) != len(self.uncond_devices):
            raise ValueError(
                f"split guidance pairs devices 1:1, got "
                f"{len(self.cond_devices)} cond vs "
                f"{len(self.uncond_devices)} uncond")
        if not self.cond_devices:
            raise ValueError(f"{self.mode} guidance needs at least one "
                             "device pair")
        both = self.cond_devices + self.uncond_devices
        if len(set(both)) != len(both):
            raise ValueError(f"guidance groups must be disjoint, got "
                             f"cond={self.cond_devices} "
                             f"uncond={self.uncond_devices}")

    @property
    def n_pairs(self) -> int:
        return len(self.cond_devices)

    def pair_speeds(self, speeds: Sequence[float]) -> List[float]:
        """Effective speed of each logical worker pair: both branches must
        finish before the eps combine, so the pair runs at the slower
        branch's speed."""
        return [min(speeds[c], speeds[u])
                for c, u in zip(self.cond_devices, self.uncond_devices)]

    def uncond_fresh(self, interval_index: int) -> bool:
        """Does adaptive interval ``interval_index`` recompute eps_u?"""
        if self.mode != "interleaved":
            return True
        return interval_index % self.uncond_refresh == 0

    def worker_reuses(self, worker: int) -> bool:
        """May logical worker ``worker`` reuse eps_u on non-refresh
        intervals? (Fast pairs keep computing fresh — staleness is spent
        where compute is scarce.)"""
        if self.mode != "interleaved":
            return False
        return self.reuse_workers is None or worker in self.reuse_workers


def guidance_groups(speeds: Sequence[float]
                    ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Bipartition devices into (cond_group, uncond_group) for split CFG.

    Both branches carry identical work, so the groups should have equal
    aggregate effective speed; group sizes may differ by at most one (each
    logical worker is a 1:1 device pair — see :class:`GuidancePlan`). For
    clusters up to 16 devices the size-constrained bipartition minimizing
    ``|sum(v_cond) - sum(v_uncond)|`` is found exhaustively; larger
    clusters fall back to greedy balancing. The cond branch (whose output
    anchors quality, and which keeps running in interleaved mode) goes to
    the group with the >= aggregate speed. Groups are disjoint and cover
    every device passed in; each is returned sorted fastest-first — pair i
    is (cond[i], uncond[i]).
    """
    n = len(speeds)
    if n < 2:
        raise ValueError(f"split guidance needs >= 2 devices, got {n}")
    ids = sorted(range(n), key=lambda i: (-speeds[i], i))
    size_a = n // 2
    if n <= 16:
        best = None
        for combo in itertools.combinations(range(n), size_a):
            a = set(combo)
            sa = sum(speeds[i] for i in a)
            sb = sum(speeds[i] for i in range(n) if i not in a)
            gap = abs(sa - sb)
            if best is None or gap < best[0] - 1e-12:
                best = (gap, a)
        group_a = best[1]
    else:                                 # greedy: fastest-first into the
        group_a, group_b = set(), set()   # lighter group, capacity-capped
        sa = sb = 0.0
        size_b = n - size_a
        for i in ids:
            to_a = (sa <= sb and len(group_a) < size_a) or \
                len(group_b) >= size_b
            if to_a:
                group_a.add(i)
                sa += speeds[i]
            else:
                group_b.add(i)
                sb += speeds[i]
    a = tuple(sorted(group_a, key=lambda i: (-speeds[i], i)))
    b = tuple(sorted((i for i in range(n) if i not in group_a),
                     key=lambda i: (-speeds[i], i)))
    sum_a = sum(speeds[i] for i in a)
    sum_b = sum(speeds[i] for i in b)
    cond, uncond = (a, b) if sum_a >= sum_b else (b, a)
    return cond, uncond


def split_plan(speeds: Sequence[float], mode: str, scale: float,
               uncond_refresh: int = 2) -> GuidancePlan:
    """Build a split/interleaved GuidancePlan from cluster speeds: balanced
    groups via :func:`guidance_groups`, then 1:1 rank-order pairing (i-th
    fastest cond device with i-th fastest uncond device). With unequal
    group sizes the slowest unpaired device idles — the guided planner's
    candidate comparison accounts for the lost capacity.

    For interleaved mode, reuse is granted to the STRAGGLER pairs only
    (pair speed strictly below the fastest pair's): staleness is applied
    where compute is scarce, and a homogeneous cluster — nothing to hide —
    degenerates to exact split numerics."""
    cond, uncond = guidance_groups(speeds)
    n_pairs = min(len(cond), len(uncond))
    gp = GuidancePlan(mode, scale, cond[:n_pairs], uncond[:n_pairs],
                      uncond_refresh=uncond_refresh)
    if mode == "interleaved":
        ps = gp.pair_speeds(speeds)
        stragglers = tuple(i for i, v in enumerate(ps)
                           if v < max(ps) - 1e-12)
        gp = dataclasses.replace(gp, reuse_workers=stragglers)
    return gp
