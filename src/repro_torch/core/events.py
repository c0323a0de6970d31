"""Schedule IR of the port: ONE generator lowers (TemporalPlan, patches,
exchange policy) into a typed stream of interval events, and every executor
interprets that stream (reference: ``repro.core.events``, DESIGN.md §10).

This port lowers the image axes — steps x patches under a boundary-exchange
policy — and the depth, guidance, sequence and frame axes:

    stream   := Warmup*  adaptive*
    adaptive := StageShift?  GuidanceExchange?  SeqShard?  FrameShard?
                ComputeInterval  Exchange  Replan?

    Warmup(m)             one synchronous full-image fine step
    StageShift(m, stages) the displaced stage chain (DESIGN.md §11) refills:
                          stage contexts reset to the published buffers.
                          Emitted entering the adaptive phase and after
                          every draining ("full") boundary, only when
                          lowering with a ``stages`` partition of depth > 1
    ComputeInterval(m0,R) R fine steps of stale-KV patch compute
                          (per-worker substeps = R / ratio)
    Exchange(m, kind)     the interval boundary; ``kind`` comes from the
                          :class:`repro_torch.core.comm.BoundaryExchange`
                          policy: "full", "skip" or "predict"
    Replan(m, plan)       an online re-allocation took effect at boundary m
    GuidanceExchange(m)   split/interleaved CFG: the coming interval combines
                          eps across the cond/uncond device groups; ``fresh``
                          says whether the uncond branch is recomputed
    SeqShard(m)           a seq-sharded plan: every attention of the coming
                          interval scatters its heads over the shards and
                          runs ``hops`` ring hops of K/V segments
    FrameShard(m)         a multi-frame plan (DESIGN.md §16): the frames
                          each group-member row evaluates in the coming
                          interval; every frame f > 0 attends over its own
                          published context concatenated with frame f-1's

Replying to an :class:`Exchange` with ``gen.send((plan, patches))``
re-allocates the remaining fine steps, exactly as in the reference. The
trace records keep every field of the reference so that records from the
two packages compare equal.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

from repro_torch.core import comm as comm_lib
from repro_torch.core.schedule import TemporalPlan


# ----------------------------------------------------------------------
# trace records (replayed by the latency simulator)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class IntervalEvent:
    """One executed interval: per-worker (sub-steps, patch rows) plus the
    boundary-exchange kind that followed it. ``fill`` marks an interval that
    begins with a stage-chain (re)fill (the staged cost model charges the
    pipeline bubble there), ``uncond_fresh`` records the guidance verdict
    and ``seq_hops`` the ring hops of every attention; ``frames`` is the
    latent frames evaluated per substep (1 = image)."""
    fine_step: int                       # first fine step of the interval
    substeps: List[int]                  # steps executed by each worker
    patches: List[int]                   # token-rows per worker
    synchronous: bool = False            # warmup intervals sync every layer
    exchange: str = "full"               # boundary kind after this interval
    fill: bool = False
    uncond_fresh: bool = True
    seq_hops: int = 0
    frames: int = 1


@dataclasses.dataclass
class ExecutionTrace:
    events: List[IntervalEvent]
    plan: Optional[TemporalPlan]
    patches: List[int]
    n_tokens: int                        # full image tokens (comm sizing)
    latent_bytes: int
    kv_bytes_per_worker: List[int]
    stages: Optional[List[int]] = None
    act_row_bytes: int = 0
    guidance: Optional[object] = None
    seq: Optional[object] = None
    frames: Optional[object] = None
    cond_tokens: int = 0


# ----------------------------------------------------------------------
# the IR event types
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Warmup:
    """One synchronous fine step: every worker runs the full-image forward."""
    fine_step: int
    substeps: Tuple[int, ...]            # 1 for each active worker, else 0
    patches: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ComputeInterval:
    """R = ``length`` fine steps of patch compute against stale buffers."""
    fine_step: int                       # first fine step of the interval
    length: int                          # fine steps in the interval (lcm)
    substeps: Tuple[int, ...]            # length // ratio_i per active worker
    ratios: Tuple[int, ...]
    patches: Tuple[int, ...]

    @property
    def workers(self) -> List[int]:
        return [i for i, s in enumerate(self.substeps) if s > 0]


@dataclasses.dataclass(frozen=True)
class Exchange:
    """The boundary after a compute interval. ``kind`` is the policy verdict;
    the final boundary of a run is always "full" (the image must assemble)."""
    fine_step: int                       # first fine step AFTER the interval
    kind: str                            # "full" | "skip" | "predict"
    index: int                           # 0-based boundary counter
    substeps: Tuple[int, ...]            # of the interval that just ended
    patches: Tuple[int, ...]
    last: bool


@dataclasses.dataclass(frozen=True)
class StageShift:
    """The displaced stage chain (re)fills (DESIGN.md §11): every stage's
    context resets to the last published buffers. Emitted once when the
    adaptive phase begins and again after every draining ("full")
    exchange; "skip"/"predict" boundaries keep the pipe full, which is how
    the stale-async policies compose with depth pipelining."""
    fine_step: int                       # first fine step of the refilled pipe
    stages: Tuple[int, ...]              # DiT blocks per stage (chain order)


@dataclasses.dataclass(frozen=True)
class GuidanceExchange:
    """Cross-branch epsilon reconciliation (DESIGN.md §12), emitted before
    each adaptive interval of a split/interleaved guidance plan. ``fresh`` is
    False on interleaved reuse intervals: straggler pairs reuse the guidance
    delta cached at the last refresh interval (their uncond device idles);
    other pairs always compute fresh."""
    fine_step: int                       # first fine step of the interval
    mode: str                            # "split" | "interleaved"
    fresh: bool                          # uncond branch recomputed?
    index: int                           # 0-based adaptive interval counter


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """Sequence-parallel attention staging (DESIGN.md §13), emitted before
    each adaptive interval of a seq-sharded plan: every attention of the
    coming interval scatters its heads over ``len(heads)`` shards and
    assembles the context through ``hops`` ring hops of the segments. It
    carries no numerics: the "ring" policy's degraded boundaries leave the
    cross-worker buffers stale while the ring keeps each worker's own
    context fresh."""
    fine_step: int                       # first fine step of the interval
    heads: Tuple[int, ...]               # attention heads per seq shard
    segments: Tuple[int, ...]            # ring segment token-rows per shard
    index: int                           # 0-based adaptive interval counter

    @property
    def hops(self) -> int:
        return len(self.segments) - 1


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """Multi-frame staging (DESIGN.md §16), emitted before each adaptive
    interval of a multi-frame plan: ``frames`` is the number of latent
    frames each group-member row evaluates this interval. Every frame
    ``f > 0`` attends over its own published context concatenated with frame
    ``f-1``'s, a 2N-token context that ages under the same full/skip/predict
    boundary policy as the within-frame halo; frame 0's context is the
    image's. It carries no numerics."""
    fine_step: int                       # first fine step of the interval
    frames: Tuple[int, ...]              # latent frames per group-member row
    index: int                           # 0-based adaptive interval counter

    @property
    def num_frames(self) -> int:
        return sum(self.frames)


@dataclasses.dataclass(frozen=True)
class Replan:
    """An online re-allocation (sent into the generator) took effect."""
    fine_step: int
    plan: TemporalPlan
    patches: Tuple[int, ...]


def active_workers(plan: TemporalPlan, patches: Sequence[int]) -> List[int]:
    """The workers that actually execute: planned active AND own >=1 row."""
    return [i for i in plan.active if patches[i] > 0]


# ----------------------------------------------------------------------
# lowering
# ----------------------------------------------------------------------

def lower(plan: TemporalPlan, patches: Sequence[int],
          policy: Optional[comm_lib.BoundaryExchange] = None,
          stages: Optional[Sequence[int]] = None,
          guidance=None, seq_shards=None, frames=None) -> Iterator:
    """Lower (plan, patches, exchange policy[, stages][, guidance][, seq
    shards][, frames]) into events (see the module docstring). A coroutine-style
    generator: reply to an :class:`Exchange` with ``gen.send((new_plan,
    new_patches))`` to re-allocate the remaining fine steps (the new plan's
    interval LCM must divide them); the generator then emits a
    :class:`Replan` and continues.

    ``stages`` (blocks per stage): with more than one stage a
    :class:`StageShift` is emitted before the first adaptive interval and
    after every draining ("full") boundary but the last.

    ``guidance`` (a :class:`~repro_torch.core.guidance.GuidancePlan`): split
    and interleaved plans emit a :class:`GuidanceExchange` before every
    adaptive interval with the uncond-recompute verdict; fused guidance
    emits nothing (the combine is worker-local).

    ``seq_shards`` (a :class:`~repro_torch.core.seqpar.SeqPlan`): a plan with
    more than one shard emits a :class:`SeqShard` before every adaptive
    interval; a single-shard plan emits nothing, so its stream is the
    unsharded one.

    ``frames`` (a :class:`~repro_torch.core.frames.FramePlan`): a plan with
    more than one frame emits a :class:`FrameShard` before every adaptive
    interval; a single-frame plan emits nothing."""
    policy = policy or comm_lib.get_exchange("sync")
    patches = list(patches)
    n = len(patches)
    stages = tuple(stages) if stages else ()
    pipelined = len(stages) > 1
    guided_exchange = guidance is not None and guidance.mode != "fused"
    seq_sharded = seq_shards is not None and len(seq_shards.segments) > 1
    framed = frames is not None and frames.num_frames > 1
    # fine steps count in ABSOLUTE coordinates of the original plan; a
    # replanned TemporalPlan covers the remaining steps (its m_base is the
    # remaining count) and only contributes ratios/activity from then on
    m_base = plan.m_base
    workers = active_workers(plan, patches)
    for m in range(plan.m_warmup):
        yield Warmup(m, tuple(1 if i in workers else 0 for i in range(n)),
                     tuple(patches))
    m0 = plan.m_warmup
    boundary = 0
    refill = pipelined                   # the pipe fills entering adaptive
    while m0 + plan.lcm <= m_base:
        if refill:
            yield StageShift(m0, stages)
            refill = False
        if guided_exchange:
            yield GuidanceExchange(m0, guidance.mode,
                                   guidance.uncond_fresh(boundary), boundary)
        if seq_sharded:
            yield SeqShard(m0, tuple(seq_shards.heads),
                           tuple(seq_shards.segments), boundary)
        if framed:
            yield FrameShard(m0, tuple(frames.groups), boundary)
        R = plan.lcm
        workers = active_workers(plan, patches)
        subs = tuple(R // plan.ratios[i] if i in workers else 0
                     for i in range(n))
        yield ComputeInterval(m0, R, subs, tuple(plan.ratios), tuple(patches))
        m0 += R
        last = m0 + plan.lcm > m_base
        kind = "full" if last else policy.kind(boundary)
        upd = yield Exchange(m0, kind, boundary, subs, tuple(patches), last)
        if pipelined and kind == "full" and not last:
            refill = True                # a sync boundary drains the pipe
        boundary += 1
        if upd is not None:
            plan, patches = upd
            patches = list(patches)
            if (m_base - m0) % plan.lcm:
                raise ValueError(
                    f"replanned LCM {plan.lcm} must divide the remaining "
                    f"{m_base - m0} fine steps")
            yield Replan(m0, plan, tuple(patches))


# ----------------------------------------------------------------------
# replay: event stream -> trace records / full ExecutionTrace
# ----------------------------------------------------------------------

def record(interval: ComputeInterval, kind: str, fill: bool = False,
           uncond_fresh: bool = True, seq_hops: int = 0,
           frames: int = 1) -> IntervalEvent:
    """The trace record for one adaptive interval + its boundary kind."""
    return IntervalEvent(interval.fine_step, list(interval.substeps),
                         list(interval.patches), exchange=kind, fill=fill,
                         uncond_fresh=uncond_fresh, seq_hops=seq_hops,
                         frames=frames)


def warmup_record(ev: Warmup, frames: int = 1) -> IntervalEvent:
    return IntervalEvent(ev.fine_step, list(ev.substeps), list(ev.patches),
                         synchronous=True, frames=frames)


def replay(plan: TemporalPlan, patches: Sequence[int],
           policy: Optional[comm_lib.BoundaryExchange] = None,
           stages: Optional[Sequence[int]] = None,
           guidance=None, seq_shards=None,
           frames=None) -> List[IntervalEvent]:
    """Trace records of the whole schedule without executing any numerics —
    the latency-only path (`simulate.build_trace`) and the numerics paths
    (`patch_parallel.run_schedule`, `pipefuse.run_pipefuse`) all derive
    their records from :func:`lower`, so they are structurally identical by
    construction."""
    out: List[IntervalEvent] = []
    pending: Optional[ComputeInterval] = None
    fill = False
    fresh = True
    hops = 0
    n_frames = frames.num_frames if frames is not None else 1
    for ev in lower(plan, patches, policy, stages, guidance=guidance,
                    seq_shards=seq_shards, frames=frames):
        if isinstance(ev, Warmup):
            out.append(warmup_record(ev, frames=n_frames))
        elif isinstance(ev, StageShift):
            fill = True
        elif isinstance(ev, GuidanceExchange):
            fresh = ev.fresh
        elif isinstance(ev, SeqShard):
            hops = ev.hops
        elif isinstance(ev, ComputeInterval):
            pending = ev
        elif isinstance(ev, Exchange):
            out.append(record(pending, ev.kind, fill=fill,
                              uncond_fresh=fresh, seq_hops=hops,
                              frames=n_frames))
            fill = False
            fresh = True
    return out


def make_trace(records: List[IntervalEvent], plan: TemporalPlan,
               patches: Sequence[int], cfg, batch: int,
               stages: Optional[Sequence[int]] = None,
               guidance=None, seq=None, frames=None,
               cond_tokens: Optional[int] = None) -> ExecutionTrace:
    """Byte-size provenance shared by every trace producer (K/V is priced
    at 2 bytes per element, the latent at 4, as in the reference). Byte
    sizes are per frame: the frame cost model multiplies them by the frames
    each member row owns. ``cond_tokens`` (the prompt bucket the
    cross-attention reads) defaults to the model's ``cond_seq_len`` when it
    has ``cross_attn``, else 0; serving passes a lane group's own bucket."""
    H = cfg.latent_size
    lat_bytes = int(batch * H * H * cfg.channels * 4)
    kv_bytes = [int(2 * cfg.n_layers * batch * pr * cfg.tokens_per_side
                    * cfg.d_model * 2) for pr in patches]
    act_row = int(batch * cfg.tokens_per_side * cfg.d_model * 4)
    if cond_tokens is None:
        cond_tokens = (cfg.cond_seq_len
                       if getattr(cfg, "cross_attn", False) else 0)
    return ExecutionTrace(records, plan, list(patches), cfg.n_tokens,
                          lat_bytes, kv_bytes,
                          stages=list(stages) if stages else None,
                          act_row_bytes=act_row, guidance=guidance, seq=seq,
                          frames=frames, cond_tokens=int(cond_tokens))
