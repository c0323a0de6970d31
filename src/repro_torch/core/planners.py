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
    "stadi_guidance"  joint (steps, patches, CFG placement) search
    "stadi_seq" joint (steps, patches, sequence shards) search

The joint planners of the other axes (stadi_pipefuse, stadi_video) come with
the slices that port those axes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Protocol, Sequence, runtime_checkable

from repro_torch.core import comm as comm_lib
from repro_torch.core import guidance as guide_lib
from repro_torch.core import schedule as sched_lib
from repro_torch.core.schedule import TemporalPlan
from repro_torch.core.simulate import CostModel


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A complete allocation decision: who steps when, on which rows.

    temporal: per-device step counts / interval ratios (Eq. 4 or uniform)
    patches:  token-rows per device, sum == p_total (Eq. 5 or uniform)
    planner:  provenance — registry name of the planner that produced it
    speeds:   the effective speeds the plan was computed from
    modeled_interval_cost: planner-modeled cost per fine-step interval
        (the makespan and stadi_guidance planners fill this in)
    guidance: the :class:`~repro_torch.core.guidance.GuidancePlan` of a
        guided run (None = unguided)
    seq: the :class:`~repro_torch.core.seqpar.SeqPlan` of a
        sequence-sharded run (None = attention-unsharded)
    stages / frames: the later axes of the reference's six-axis plan; None
        on every plan the port's planners return.
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
    ``tiers``, ``granularity`` and ``min_patch``; ``stadi_guidance`` also
    reads ``cfg_scale``, ``guidance``, ``uncond_refresh``, ``cost_model``,
    ``latent_bytes`` and ``kv_row_bytes``, and ``stadi_seq`` ``seq_shards``,
    ``n_heads`` and ``exchange_refresh`` (in practice a
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


def _guided_plan_cost(plan: ExecutionPlan, speeds, p_total: int, cm,
                      kv_row: float, latent_bytes: float) -> float:
    """Modeled seconds of one adaptive interval ending in a full boundary,
    under the guided cost model of :func:`repro_torch.core.simulate.
    _simulate_guided` (fused serializes both branches' staged K/V; split
    runs the branch domains concurrently and pays only the per-substep
    epsilon combine across them). With no byte provenance (kv_row == 0)
    this is the compute-only makespan. Interleaved costs average the
    fresh/stale interval mix over the uncond_refresh cadence."""
    g = plan.guidance
    t = plan.temporal
    R = t.lcm
    row_bytes = latent_bytes / max(p_total, 1)

    def interval_cost(fresh: bool) -> float:
        compute, eps_bytes, kv_bytes, hops = 0.0, 0.0, 0.0, 0
        for i in plan.active:
            sub = R // t.ratios[i]
            rows = plan.patches[i]
            if g.mode == "fused":
                step_t = cm.t_fixed + cm.t_row * rows * 2.0
                tt = sub * step_t / max(speeds[i], 1e-9)
            else:
                vc = speeds[g.cond_devices[i]]
                vu = speeds[g.uncond_devices[i]]
                step_t = cm.t_fixed + cm.t_row * rows
                if fresh or not g.worker_reuses(i):
                    tt = sub * step_t / max(min(vc, vu), 1e-9)
                else:                    # reuse: uncond idles, cond runs
                    tt = sub * step_t / max(vc, 1e-9)
            compute = max(compute, tt)
            eps_sub = sub if fresh or not g.worker_reuses(i) else 0
            eps_bytes += 2 * eps_sub * rows * row_bytes
            kv_bytes += kv_row * rows
            hops = max(hops, eps_sub)
        eps_t = 0.0
        if g.mode != "fused":
            eps_t = eps_bytes / cm.link_bw + hops * cm.link_latency
        branch_factor = 2.0 if g.mode == "fused" else 1.0
        kv_t = branch_factor * kv_bytes / cm.link_bw
        gather_rows = comm_lib.uneven_all_gather_rows(
            [plan.patches[i] for i in plan.active])
        gather_t = gather_rows * row_bytes / cm.link_bw
        return max(compute, kv_t) + gather_t + cm.link_latency + eps_t

    if g.mode != "interleaved":
        return interval_cost(True)
    E = g.uncond_refresh
    return (interval_cost(True) + (E - 1) * interval_cost(False)) / E


@register_planner("stadi_guidance")
def stadi_guidance_planner(speeds, knobs, p_total) -> ExecutionPlan:
    """Joint (steps, patches, guidance placement) search (DESIGN.md §12).

    Candidates: FUSED — the plain STADI plan over all devices, every worker
    computing both CFG branches; SPLIT — the cluster bipartitioned by
    :func:`repro_torch.core.guidance.guidance_groups`, logical workers =
    rank-paired (cond, uncond) devices, the STADI allocator run over the
    pairwise-min speeds; INTERLEAVED — split placement + uncond reuse on the
    ``knobs.uncond_refresh`` cadence (lossy, so only considered when
    forced). ``knobs.guidance`` pins the mode ("none" = auto over
    fused/split); candidates are scored by :func:`_guided_plan_cost` with
    the byte provenance ``knobs.latent_bytes``/``kv_row_bytes`` (which
    ``StadiPipeline`` fills in) and the cheapest wins. Needs
    ``knobs.cfg_scale > 0``.
    """
    scale = knobs.cfg_scale
    if scale <= 0.0:
        raise ValueError("the stadi_guidance planner plans GUIDED "
                         "generation: set cfg_scale > 0 (and optionally "
                         "guidance='fused'|'split'|'interleaved')")
    mode = knobs.guidance
    cm = knobs.cost_model or CostModel(t_fixed=1e-3, t_row=1e-3)
    modes = [mode] if mode != "none" else ["fused", "split"]
    candidates = []
    for m in modes:
        if m == "fused":
            base = stadi_planner(speeds, knobs, p_total)
            gp = guide_lib.GuidancePlan("fused", scale)
        else:
            if len(speeds) < 2:
                if mode != "none":       # forced split on one device
                    guide_lib.guidance_groups(speeds)   # raises with context
                continue
            gp = guide_lib.split_plan(speeds, m, scale,
                                      uncond_refresh=knobs.uncond_refresh)
            base = stadi_planner(gp.pair_speeds(speeds), knobs, p_total)
        cand = dataclasses.replace(base, planner="stadi_guidance",
                                   speeds=list(speeds), guidance=gp)
        cost = _guided_plan_cost(cand, speeds, p_total, cm,
                                 knobs.kv_row_bytes, knobs.latent_bytes)
        candidates.append(dataclasses.replace(cand,
                                              modeled_interval_cost=cost))
    return min(candidates, key=lambda c: c.modeled_interval_cost)


def _seq_plan_cost(plan: ExecutionPlan, groups, p_total: int, cm,
                   kv_row: float, latent_bytes: float, refresh: int) -> float:
    """Modeled seconds of one adaptive interval under the ring-contention
    cost model of :func:`repro_torch.core.simulate._simulate_seq`, averaged
    over the "ring" policy's refresh cadence (1 full boundary and E-1
    degraded ones per E). ``groups`` is the member-speed grouping of a
    multi-shard candidate (None for the pure patch-parallel candidate). With
    no byte provenance (kv_row == 0) the wire terms vanish and the score is
    the compute makespan, where the t_ctx attention term still rewards head
    scattering on attention-bound profiles."""
    t = plan.temporal
    R = t.lcm
    row_bytes = latent_bytes / max(p_total, 1)
    seq = plan.seq
    if seq is not None and len(seq.segments) > 1:
        headf, segf = seq.head_fracs, seq.seg_fracs
        hops, seg_pad = len(seq.segments) - 1, max(seq.seg_fracs)
    else:
        headf, segf, hops, seg_pad = [1.0], [1.0], 0, 1.0
    compute = ring_t = async_b = 0.0
    for i in plan.active:
        sub = R // t.ratios[i]
        rows = plan.patches[i]
        members = groups[i] if groups is not None else [plan.speeds[i]]
        wt = max((cm.t_fixed + cm.t_row * rows * segf[j]) / max(v, 1e-9)
                 + cm.attn_time(p_total, headf[j], v)
                 for j, v in enumerate(members))
        compute = max(compute, sub * wt)
        ring_t = max(ring_t, sub * hops * (kv_row * rows * seg_pad
                                           / cm.link_bw + cm.link_latency))
        async_b = max(async_b, kv_row * rows)
    gather_rows = comm_lib.uneven_all_gather_rows(
        [plan.patches[i] for i in plan.active])
    gather_t = gather_rows * row_bytes / cm.link_bw
    full = max(compute, async_b / cm.link_bw, ring_t) \
        + gather_t + cm.link_latency
    degraded = max(compute, ring_t)
    E = max(refresh, 1)
    return (full + (E - 1) * degraded) / E


@register_planner("stadi_seq")
def stadi_seq_planner(speeds, knobs, p_total) -> ExecutionPlan:
    """Joint (steps, patches, seq shards) search (DESIGN.md §13).

    Candidates: the pure patch-parallel STADI plan (seq_shards == 1) and, for
    each shard count S, a sequence-sharded plan whose workers are device
    groups of S members (column-dealt by :func:`repro_torch.core.seqpar.
    seq_group_speeds`), with the STADI allocator run over the per-group
    aggregate speeds and the head/segment partitions sized over the
    per-shard-row aggregates. All are scored by :func:`_seq_plan_cost` and
    the cheapest wins.

    ``knobs.seq_shards > 0`` pins S (1 = force pure patch); 0 = auto.
    ``knobs.n_heads`` (which StadiPipeline fills in from the model config)
    is required for S > 1.
    """
    from repro_torch.core import seqpar as seqpar_lib
    n = len(speeds)
    forced = getattr(knobs, "seq_shards", 0) or 0
    n_heads = getattr(knobs, "n_heads", None)
    cm = getattr(knobs, "cost_model", None) or CostModel(t_fixed=1e-3,
                                                         t_row=1e-3)
    kv_row = getattr(knobs, "kv_row_bytes", 0)
    latent_bytes = getattr(knobs, "latent_bytes", 0)
    refresh = getattr(knobs, "exchange_refresh", 2)
    candidates = []
    if forced in (0, 1):
        base = stadi_planner(speeds, knobs, p_total)
        cand = dataclasses.replace(base, planner="stadi_seq")
        candidates.append(dataclasses.replace(
            cand, modeled_interval_cost=_seq_plan_cost(
                cand, None, p_total, cm, kv_row, latent_bytes, refresh)))
    if n_heads is None and forced > 1:
        raise ValueError("stadi_seq needs knobs.n_heads (the attention "
                         "head count) to scatter heads; StadiPipeline "
                         "fills it in from the model config")
    if forced == 1:                       # pinned pure patch: no seq search
        return candidates[0]
    s_options = ([forced] if forced > 1 else
                 range(2, min(n, n_heads or 1) + 1))
    for S in s_options:
        if S < 2 or S > min(n, n_heads or 0) or n // S < 1 or S > p_total:
            continue
        groups, shard_speeds = seqpar_lib.seq_group_speeds(speeds, S)
        base = stadi_planner([sum(g) for g in groups], knobs, p_total)
        seq = seqpar_lib.make_seq_plan(n_heads, p_total, S, shard_speeds)
        cand = dataclasses.replace(base, planner="stadi_seq",
                                   speeds=list(speeds), seq=seq)
        candidates.append(dataclasses.replace(
            cand, modeled_interval_cost=_seq_plan_cost(
                cand, groups, p_total, cm, kv_row, latent_bytes, refresh)))
    if not candidates:
        raise ValueError(
            f"seq_shards={forced} is infeasible: need 1 <= S <= "
            f"min(n_devices={n}, n_heads={n_heads}, p_total={p_total})")
    return min(candidates, key=lambda c: c.modeled_interval_cost)
