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
    "stadi_pipefuse"  joint (steps, patches, stage split) search
    "stadi_guidance"  joint (steps, patches, CFG placement) search
    "stadi_seq" joint (steps, patches, sequence shards) search
    "stadi_video"  joint (steps, patches, frame placement) search
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
        (the makespan, stadi_pipefuse, stadi_guidance and stadi_seq
        planners fill this in)
    stages: the displaced stage chain (DESIGN.md §11): DiT blocks per
        stage, the chain on the ``len(stages)`` fastest devices in speed
        order (None = depth-unpartitioned); ``temporal``/``patches`` then
        describe patch micro-batches streaming through the chain
    guidance: the :class:`~repro_torch.core.guidance.GuidancePlan` of a
        guided run (None = unguided)
    seq: the :class:`~repro_torch.core.seqpar.SeqPlan` of a
        sequence-sharded run (None = attention-unsharded)
    frames: the :class:`~repro_torch.core.frames.FramePlan` of a
        multi-frame run (None / single-frame = the image path). With
        ``len(groups) > 1`` the plan is frame-parallel: ``temporal`` and
        ``patches`` describe the patch-worker COLUMNS every member row
        shares (:func:`repro_torch.core.frames.frame_group_layout`); ``speeds``
        stays the raw device speeds.
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
    ``tiers``, ``granularity`` and ``min_patch``; ``stadi_pipefuse`` also
    reads ``num_stages``, ``micro_patches``, ``depth`` and ``cost_model``,
    ``stadi_guidance`` ``cfg_scale``, ``guidance``, ``uncond_refresh``, ``cost_model``,
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


def _patch_plan_cost(plan: ExecutionPlan, p_total: int,
                     fixed: float = 0.05) -> float:
    """Normalized per-fine-step makespan of a pure patch-parallel plan: a
    full-depth full-image step at v=1 costs ``fixed + 1`` work units, and a
    device with interval ratio r amortizes its step over r fine steps (the
    model :func:`repro_torch.core.schedule.makespan_optimal_allocation`
    minimizes)."""
    cost = 0.0
    for i in plan.active:
        v, r = plan.speeds[i], plan.temporal.ratios[i]
        cost = max(cost, (fixed + plan.patches[i] / p_total) / v / r)
    return cost


def _pipefuse_plan_cost(stages: Sequence[int], chain_speeds: Sequence[float],
                        n_micro: int, fixed: float = 0.05) -> float:
    """Normalized per-fine-step steady-state cost of a displaced pipeline:
    stage d runs its block share of each of the ``n_micro`` micro-tasks per
    fine step, so the bottleneck stage sets the rate. The per-step fixed
    overhead splits with the blocks, where patch parallelism pays it whole
    on every device (DESIGN.md §11)."""
    L = sum(stages)
    return max(b / L * (n_micro * fixed + 1.0) / v
               for b, v in zip(stages, chain_speeds))


@register_planner("stadi_pipefuse")
def stadi_pipefuse_planner(speeds, knobs, p_total) -> ExecutionPlan:
    """Joint (steps, patches, stage split) search (DESIGN.md §11).

    Candidates: the pure patch-parallel STADI plan (one stage) and, for
    each stage count S, a displaced pipeline on the S fastest devices with
    blocks sized by :func:`repro_torch.core.hetero.stage_partition` and
    patch micro-batches split uniformly. All are scored with the same
    normalized interval-makespan model and the cheapest wins.
    ``knobs.num_stages > 0`` pins S (1 = force pure patch); 0 = auto.
    ``knobs.depth`` (the DiT block count, which StadiPipeline fills in) is
    required for S > 1. ``knobs.micro_patches > 0`` pins the micro-batch
    count; 0 = auto (S or 2S, whichever models cheaper).
    """
    from repro_torch.core import hetero
    n = len(speeds)
    forced_s = getattr(knobs, "num_stages", 0)
    depth = getattr(knobs, "depth", None)
    # normalized per-step fixed overhead: from the configured cost model
    # (t_fixed in units of the full-image row work), else the makespan
    # planner's default
    cm = getattr(knobs, "cost_model", None)
    fixed = (cm.t_fixed / max(cm.t_row * p_total, 1e-12)
             if cm is not None else 0.05)
    stadi = stadi_planner(speeds, knobs, p_total)
    candidates = [dataclasses.replace(
        stadi, planner="stadi_pipefuse",
        modeled_interval_cost=_patch_plan_cost(stadi, p_total, fixed))]
    if depth is None and forced_s > 1:
        raise ValueError("stadi_pipefuse needs knobs.depth (the DiT block "
                         "count) to partition stages; StadiPipeline fills "
                         "it in from the model config")
    s_options = ([forced_s] if forced_s > 0 else
                 range(2, min(n, depth or 1) + 1))
    by_speed = sorted(range(n), key=lambda d: (-speeds[d], d))
    forced_m = getattr(knobs, "micro_patches", 0)
    for S in s_options:
        if S < 2 or S > min(n, depth):
            continue
        chain = [speeds[d] for d in by_speed[:S]]
        stages = hetero.stage_partition(depth, chain)
        for M in ([forced_m] if forced_m > 0 else
                  sorted({S, min(2 * S, p_total)})):
            if M > p_total:
                continue
            temporal = _uniform_temporal(M, knobs.m_base, knobs.m_warmup)
            patches = _equal_patches(temporal, p_total)
            candidates.append(ExecutionPlan(
                temporal, patches, "stadi_pipefuse", list(speeds),
                modeled_interval_cost=_pipefuse_plan_cost(stages, chain, M,
                                                          fixed),
                stages=stages))
    if forced_s > 1 and len(candidates) == 1:
        raise ValueError(
            f"num_stages={forced_s} is infeasible: need 2 <= S <= "
            f"min(n_devices={n}, depth={depth})")
    best = min(candidates, key=lambda c: c.modeled_interval_cost)
    if forced_s > 1:                     # pinned: drop the patch fallback
        best = min(candidates[1:], key=lambda c: c.modeled_interval_cost)
    return best


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


def _frame_plan_cost(plan: ExecutionPlan, rows, p_total: int, cm,
                     kv_row: float, latent_bytes: float,
                     refresh: int) -> float:
    """Modeled seconds of one adaptive interval under the frame cost model
    of :func:`repro_torch.core.simulate._simulate_frames`, averaged over the
    stale_async refresh cadence (1 full boundary + E-1 degraded per E).
    ``rows`` is the member-speed layout of a frame-parallel candidate
    (``frame_group_layout`` rows, column-aligned with ``plan.patches``);
    None for the frame-sequential candidate. Frame f > 0 attends over the 2N
    (own ⊕ previous frame) context, so the attention term charges ``p_total
    * (2 * frames_in_row - [row owns frame 0])`` context rows per substep. A
    full boundary wires every frame's K/V and latent gather, and a
    multi-row placement pays the (G-1) cross-row previous-frame K/V
    handoffs. Without byte provenance (kv_row == 0) the score is the compute
    makespan."""
    fplan = plan.frames
    G = fplan.n_groups
    t = plan.temporal
    R = t.lcm
    row_bytes = latent_bytes / max(p_total, 1)
    # fused CFG x frames: row work, context reads and published K/V double,
    # the fixed overhead is shared
    mult = 2 if plan.guidance is not None else 1
    kv_row = kv_row * mult
    # frame 0 sits in the first row (bounds are contiguous from frame 0)
    ctx = [mult * p_total * (2 * fplan.groups[g] - (1 if g == 0 else 0))
           for g in range(G)]
    compute = async_b = 0.0
    for i in plan.active:
        sub = R // t.ratios[i]
        rows_i = plan.patches[i]
        members = ([(rows[g][i], g) for g in range(G)] if rows is not None
                   else [(plan.speeds[i], 0)])
        wt = max(fplan.groups[g] * (cm.t_fixed + cm.t_row * rows_i * mult)
                 / max(v, 1e-9) + cm.attn_time(ctx[g], 1.0, v)
                 for v, g in members)
        compute = max(compute, sub * wt)
        async_b = max(async_b, max(kv_row * rows_i * fplan.groups[g]
                                   for _, g in members))
    gather_rows = comm_lib.uneven_all_gather_rows(
        [plan.patches[i] for i in plan.active])
    gather_t = gather_rows * row_bytes * fplan.num_frames / cm.link_bw
    handoff_t = (G - 1) * kv_row * p_total / cm.link_bw
    full = max(compute, async_b / cm.link_bw) \
        + gather_t + handoff_t + cm.link_latency
    degraded = compute
    E = max(refresh, 1)
    return (full + (E - 1) * degraded) / E


@register_planner("stadi_video")
def stadi_video_planner(speeds, knobs, p_total) -> ExecutionPlan:
    """Joint (steps, patches, frame placement) search (DESIGN.md §16).

    Candidates: the frame-SEQUENTIAL placement (the plain STADI plan over
    all devices, every worker stepping all ``num_frames`` frames,
    ``FramePlan(F, (F,))``) and, for each group count G, a frame-PARALLEL
    placement: the cluster dealt row-wise into G member rows
    (:func:`repro_torch.core.frames.frame_group_layout`), the frames split
    speed-proportionally over the rows
    (:func:`repro_torch.core.frames.frame_partition`), and the STADI
    allocator run over the per-column speeds ``min_g rows[g][w] /
    frames[g]`` so one patch split fits every row. Each candidate is scored
    by :func:`_frame_plan_cost` and the cheapest wins.

    ``knobs.frame_groups > 0`` pins G (1 = frame-sequential); 0 = auto.
    ``knobs.num_frames > 1`` is required. ``knobs.cfg_scale > 0`` plans
    guided video: every candidate carries a FUSED GuidancePlan, the only
    mode that composes with the frame axis; a split or interleaved
    ``knobs.guidance`` raises.
    """
    from repro_torch.core import frames as frames_lib
    n = len(speeds)
    F = getattr(knobs, "num_frames", 1)
    if F < 2:
        raise ValueError("the stadi_video planner plans MULTI-frame "
                         "generation: set num_frames > 1 (single-frame "
                         "image plans come from planner='stadi')")
    forced = getattr(knobs, "frame_groups", 0) or 0
    cm = getattr(knobs, "cost_model", None) or CostModel(t_fixed=1e-3,
                                                         t_row=1e-3)
    kv_row = getattr(knobs, "kv_row_bytes", 0)
    latent_bytes = getattr(knobs, "latent_bytes", 0)
    refresh = getattr(knobs, "exchange_refresh", 2)
    scale = getattr(knobs, "cfg_scale", 0.0)
    gp = None
    if scale > 0.0:
        gmode = getattr(knobs, "guidance", "none")
        if gmode not in ("none", "fused"):
            raise ValueError(
                f"guidance={gmode!r} is not composed with the frame axis: "
                "guided video runs FUSED classifier-free guidance only "
                "(branch-vmapped per member — DESIGN.md §17)")
        gp = guide_lib.GuidancePlan("fused", scale)
    candidates = []
    if forced in (0, 1):
        base = stadi_planner(speeds, knobs, p_total)
        cand = dataclasses.replace(base, planner="stadi_video",
                                   frames=frames_lib.FramePlan(F, (F,)),
                                   guidance=gp)
        candidates.append(dataclasses.replace(
            cand, modeled_interval_cost=_frame_plan_cost(
                cand, None, p_total, cm, kv_row, latent_bytes, refresh)))
    if forced == 1:                       # pinned frame-sequential
        return candidates[0]
    g_options = [forced] if forced > 1 else range(2, min(n, F) + 1)
    for G in g_options:
        if G < 2 or G > min(n, F):
            continue
        rows, row_speeds = frames_lib.frame_group_layout(speeds, G)
        groups = frames_lib.frame_partition(F, G, row_speeds)
        fplan = frames_lib.FramePlan(F, tuple(groups))
        n_cols = len(rows[0])
        col_speeds = [min(rows[g][w] / groups[g] for g in range(G))
                      for w in range(n_cols)]
        base = stadi_planner(col_speeds, knobs, p_total)
        cand = dataclasses.replace(base, planner="stadi_video",
                                   speeds=list(speeds), frames=fplan,
                                   guidance=gp)
        candidates.append(dataclasses.replace(
            cand, modeled_interval_cost=_frame_plan_cost(
                cand, rows, p_total, cm, kv_row, latent_bytes, refresh)))
    if not candidates:
        raise ValueError(
            f"frame_groups={forced} is infeasible: need 1 <= G <= "
            f"min(n_devices={n}, num_frames={F})")
    return min(candidates, key=lambda c: c.modeled_interval_cost)
