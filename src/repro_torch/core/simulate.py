"""Heterogeneous-cluster latency model (reference: ``repro.core.simulate``).

Heterogeneous wall-clock is modeled by replaying an :class:`ExecutionTrace`
against per-device effective speeds with a per-step cost model

    t_i(P) = (t_fixed + t_row * P) / v_i          [seconds]

The t_fixed term is the paper's Fig. 9 observation that single-step delay is
not linear in the patch size. Communication depends on each boundary's
exchange kind: "full" charges the uneven latent all-gather (per-worker padded
slab rows) plus link latency, with async KV publication masked by compute and
only the excess charged; "skip" and "predict" move no bytes (DESIGN.md §10).

The trace is built by replaying the SAME event stream the emulated engine
interprets (:func:`repro_torch.core.events.replay`). Traces are priced
unguided, staged (the displaced stage chain of DESIGN.md §11), guided (the
fabric-contention model of DESIGN.md §12), sequence-sharded (the
ring-contention model of DESIGN.md §13) or multi-frame (the frame cost
model of DESIGN.md §16).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import comm as comm_lib
from repro_torch.core import events as ir
from repro_torch.core.events import ExecutionTrace


def build_trace(plan, patches: Sequence[int], cfg, batch: int = 1,
                exchange: str = "sync", exchange_refresh: int = 2,
                stages: Optional[Sequence[int]] = None,
                guidance=None, seq=None, frames=None,
                cond_tokens: Optional[int] = None) -> ExecutionTrace:
    """Schedule trace without running numerics (latency-only replay of
    :func:`repro_torch.core.events.lower` for (plan, patches, policy[,
    stages][, guidance][, seq][, frames])); a staged trace carries its
    pipeline-fill provenance, a guided one its uncond-refresh provenance, a
    sequence-sharded one (``seq``, a SeqPlan) its ring hops, a multi-frame
    one (``frames``, a FramePlan) its frame count, with byte sizes per
    frame; ``cond_tokens`` is the prompt bucket its cross-attention reads
    (see :func:`repro_torch.core.events.make_trace`)."""
    policy = comm_lib.get_exchange(exchange, exchange_refresh)
    records = ir.replay(plan, patches, policy, stages=stages,
                        guidance=guidance, seq_shards=seq, frames=frames)
    return ir.make_trace(records, plan, list(patches), cfg, batch,
                         stages=stages, guidance=guidance, seq=seq,
                         frames=frames, cond_tokens=cond_tokens)


@dataclasses.dataclass
class CostModel:
    t_fixed: float            # per-step fixed overhead (s) at v=1
    t_row: float              # per token-row marginal cost (s) at v=1
    link_bw: float = 25e9     # bytes/s (PCIe4 x16 ~ paper's testbed)
    link_latency: float = 30e-6
    # per context-token-row x full-head attention K/V read cost (s) at v=1
    # (DESIGN.md §13); 0.0 reproduces the model without the context term
    t_ctx: float = 0.0
    # per query-row x prompt-token cross-attention read cost (s) at v=1
    # (DESIGN.md §17); 0.0 for class-conditional models
    t_xattn: float = 0.0

    def step_time(self, rows: int, v: float) -> float:
        return (self.t_fixed + self.t_row * rows) / max(v, 1e-9)

    def attn_time(self, ctx_rows: int, heads_frac: float, v: float) -> float:
        """Per-step attention context-read time: proportional to context
        rows x resident head fraction, independent of query rows."""
        return self.t_ctx * ctx_rows * heads_frac / max(v, 1e-9)

    def xattn_time(self, rows: int, cond_tokens: int, v: float) -> float:
        """Per-eval prompt cross-attention read time (DESIGN.md §17)."""
        return self.t_xattn * rows * cond_tokens / max(v, 1e-9)


def fit_cost_model(rows: Sequence[int], times: Sequence[float], **kw) -> CostModel:
    """Least-squares fit t = t_fixed + t_row * rows."""
    n = len(rows)
    sx = sum(rows); sy = sum(times)
    sxx = sum(r * r for r in rows); sxy = sum(r * t for r, t in zip(rows, times))
    denom = n * sxx - sx * sx
    t_row = (n * sxy - sx * sy) / denom if denom else 0.0
    t_fixed = max((sy - t_row * sx) / n, 1e-6)
    return CostModel(t_fixed=t_fixed, t_row=max(t_row, 1e-9), **kw)


def _kv_bytes_per_row(trace: ExecutionTrace) -> float:
    """Staged-K/V wire bytes per token row, derived from the trace's initial
    allocation so post-replan events are charged for their ACTUAL slabs."""
    for b, p in zip(trace.kv_bytes_per_worker, trace.patches):
        if p > 0:
            return b / p
    return 0.0


# ----------------------------------------------------------------------
# displaced stage-chain costing (DESIGN.md §11)
# ----------------------------------------------------------------------
#
# In a staged trace the "workers" are patch micro-batches that ALL stream
# through every stage device. Stage d (chain order, on the d-th fastest
# device) runs its block share of every micro-task; steady state is bound by
# the slowest stage and the pipeline bubble is charged only on fill
# intervals (the IR's StageShift). Stage handoffs are point-to-point
# activation slabs overlapped with compute, so they enter as a bandwidth
# bound rather than a per-boundary stall; K/V never crosses stages.

def chain_speeds(speeds: Sequence[float], n_stages: int) -> List[float]:
    """The stage chain runs on the ``n_stages`` fastest devices, in speed
    order (stage 0 = fastest) — the placement convention the planner, the
    simulator and the serving engine share."""
    return sorted(speeds, reverse=True)[:n_stages]


def pipefuse_stage_seconds(stages: Sequence[int], chain: Sequence[float],
                           cm: CostModel,
                           tasks: Sequence[Tuple[int, float]]) -> List[float]:
    """Per-stage busy seconds for a stream of micro-tasks ``(substeps,
    effective_rows)``: the per-step fixed overhead and the row work are both
    depth-proportional, so stage d pays its block fraction of each."""
    L = sum(stages)
    work = sum(s * (cm.t_fixed + cm.t_row * r) for s, r in tasks)
    return [b / L * work / max(v, 1e-9) for b, v in zip(stages, chain)]


def pipefuse_fill_bubble(stages: Sequence[int], chain: Sequence[float],
                         cm: CostModel, rows: float) -> float:
    """Pipeline-fill bubble: the first micro-task traverses the whole chain
    before steady state; all but its bottleneck-stage share is startup
    latency (plus one link latency per handoff)."""
    L = sum(stages)
    per = [b / L * (cm.t_fixed + cm.t_row * rows) / max(v, 1e-9)
           for b, v in zip(stages, chain)]
    return sum(per) - max(per) + (len(stages) - 1) * cm.link_latency


def pipefuse_warmup_seconds(stages: Sequence[int], chain: Sequence[float],
                            cm: CostModel, rows: float,
                            act_row_bytes: float) -> float:
    """One synchronous full-image task, sequential through the chain."""
    per = pipefuse_stage_seconds(stages, chain, cm, [(1, rows)])
    hop = act_row_bytes * rows / cm.link_bw + cm.link_latency
    return sum(per) + (len(stages) - 1) * hop


def pipefuse_interval_seconds(stages: Sequence[int], chain: Sequence[float],
                              cm: CostModel,
                              tasks: Sequence[Tuple[int, float]],
                              fill: bool, kind: str, latent_bytes: float,
                              act_row_bytes: float) -> float:
    """Modeled seconds of one adaptive interval through the stage chain —
    the one place the staged interval cost lives (the trace replay and the
    serving engine's round costing both call it). Steady state is
    bottleneck-bound and competes with the activation stream's bandwidth;
    fill intervals pay the bubble; "full" boundaries drain and add the
    latent handoff back to stage 0."""
    busy = pipefuse_stage_seconds(stages, chain, cm, tasks)
    handoff = sum(s * act_row_bytes * r for s, r in tasks) / cm.link_bw \
        if len(stages) > 1 else 0.0
    total = max(max(busy), handoff)
    if fill:
        total += pipefuse_fill_bubble(stages, chain, cm, tasks[0][1])
    if kind == "full":
        total += latent_bytes / cm.link_bw + cm.link_latency
    return total


def _simulate_staged(trace: ExecutionTrace, speeds: Sequence[float],
                     cm: CostModel) -> float:
    stages = trace.stages
    if trace.cond_tokens:
        # prompt cross-attention is per-row work spread over the depth like
        # t_row, so it folds into the row rate
        cm = dataclasses.replace(
            cm, t_row=cm.t_row + cm.t_xattn * trace.cond_tokens)
    chain = chain_speeds(speeds, len(stages))
    total = 0.0
    rows_total = max(sum(trace.patches), 1)
    # guided staged runs: both CFG branches stream through the chain as one
    # micro-task, so every task carries 2x the row work (the fixed overhead
    # is shared); each stage's doubled context never crosses devices
    mult = 2 if trace.guidance is not None else 1
    for ev in trace.events:
        tasks = [(sub, rows * mult) for sub, rows
                 in zip(ev.substeps, ev.patches) if sub > 0 and rows > 0]
        if not tasks:
            continue
        if ev.synchronous:
            total += pipefuse_warmup_seconds(stages, chain, cm,
                                             rows_total * mult,
                                             trace.act_row_bytes)
        else:
            total += pipefuse_interval_seconds(
                stages, chain, cm, tasks, ev.fill, ev.exchange,
                trace.latent_bytes, trace.act_row_bytes)
    return total


# ----------------------------------------------------------------------
# classifier-free guidance costing (DESIGN.md §12)
# ----------------------------------------------------------------------
#
# The binding constraint CFG adds is fabric contention: fused guidance
# doubles every staged-K/V payload and broadcasts both branches over one
# fabric domain; split guidance maps the two branch groups onto disjoint
# domains that broadcast concurrently, and only the per-substep epsilon
# combine (latent-sized) crosses between them. Interleaved guidance also
# idles straggler pairs' uncond devices on non-refresh intervals.

def _guided_eps_seconds(ev, g, cm: CostModel, row_bytes: float,
                        pairs: List[int], fresh: bool) -> float:
    """Cross-group epsilon traffic of one interval: each pair exchanges its
    slab's eps both ways at every substep it executes — none for reusing
    (straggler) workers on interleaved reuse intervals."""
    subs = {i: (ev.substeps[i] if fresh or not g.worker_reuses(i) else 0)
            for i in pairs}
    bytes_ = sum(2 * subs[i] * ev.patches[i] * row_bytes for i in pairs)
    hops = max(subs.values(), default=0)
    return bytes_ / cm.link_bw + hops * cm.link_latency


def _simulate_guided(trace: ExecutionTrace, speeds: Sequence[float],
                     cm: CostModel) -> float:
    g = trace.guidance
    kv_row = _kv_bytes_per_row(trace)
    rows_total = max(sum(trace.patches), 1)
    row_bytes = trace.latent_bytes / rows_total
    # prompt-token read: per-row like t_row, paid by each branch a device
    # evaluates (2x fused, 1x per split/interleaved device)
    t_row_eff = cm.t_row + cm.t_xattn * trace.cond_tokens
    total = 0.0
    for ev in trace.events:
        parts = [i for i, (sub, rows) in
                 enumerate(zip(ev.substeps, ev.patches))
                 if sub > 0 and rows > 0]
        if not parts:
            continue
        fresh = ev.uncond_fresh
        compute = 0.0
        for i in parts:
            step_t = cm.t_fixed + t_row_eff * ev.patches[i] \
                * (2.0 if g.mode == "fused" else 1.0)
            if g.mode == "fused":
                t = ev.substeps[i] * step_t / max(speeds[i], 1e-9)
            else:                        # worker i is a device PAIR
                vc = speeds[g.cond_devices[i]]
                vu = speeds[g.uncond_devices[i]]
                if fresh or not g.worker_reuses(i):
                    t = ev.substeps[i] * step_t / max(min(vc, vu), 1e-9)
                else:                    # reuse: uncond idles, cond runs
                    t = ev.substeps[i] * step_t / max(vc, 1e-9)
            compute = max(compute, t)
        eps_t = 0.0
        if g.mode != "fused":
            eps_t = _guided_eps_seconds(ev, g, cm, row_bytes, parts, fresh)
        gather_rows = comm_lib.uneven_all_gather_rows(
            [ev.patches[i] for i in parts])
        kind = "full" if ev.synchronous else ev.exchange
        if kind != "full" or len(parts) <= 1:
            total += compute + eps_t     # no broadcast, no gather
            continue
        # "full" boundary: each branch domain broadcasts its staged K/V —
        # fused serializes both branches on one fabric, split runs the two
        # domains concurrently (one branch's worth of bytes)
        branch_factor = 2.0 if g.mode == "fused" else 1.0
        kv_bytes = branch_factor * sum(kv_row * ev.patches[i] for i in parts)
        comm = gather_rows * row_bytes / cm.link_bw + cm.link_latency
        total += max(compute, kv_bytes / cm.link_bw) + comm + eps_t
    return total


# ----------------------------------------------------------------------
# sequence-parallel ring-contention costing (DESIGN.md §13)
# ----------------------------------------------------------------------
#
# In a seq-sharded trace the "workers" are device GROUPS of S members (the
# column-dealt placement of seqpar.seq_group_speeds). Member j computes its
# ring-segment share of the worker's query rows and reads the full context
# with its head fraction only, so the t_ctx term divides by headf[j]. What
# seq adds back is the ring: S-1 hops per attention, each forwarding one K/V
# segment padded to the largest, overlapped with compute like DistriFusion's
# async halos (only the per-hop link latency is unavoidable).

def _simulate_seq(trace: ExecutionTrace, speeds: Sequence[float],
                  cm: CostModel) -> float:
    """Makespan of a sequence-sharded trace: member-level compute split
    (segments x heads) plus per-substep ring hops."""
    from repro_torch.core import seqpar as seqpar_lib

    seq = trace.seq
    S = len(seq.segments)
    groups, _ = seqpar_lib.seq_group_speeds(speeds, S)
    headf, segf = seq.head_fracs, seq.seg_fracs
    seg_pad = max(segf)
    kv_row = _kv_bytes_per_row(trace)
    total = 0.0
    for ev in trace.events:
        parts: List[int] = []
        total_rows = max(sum(ev.patches), 1)
        row_bytes = trace.latent_bytes / total_rows
        compute = 0.0
        ring_t = 0.0
        # synchronous warm-up steps ring too; adaptive intervals carry the
        # IR's hop count
        hops = (S - 1) if ev.synchronous else ev.seq_hops
        for i, (sub, rows) in enumerate(zip(ev.substeps, ev.patches)):
            if sub == 0 or rows == 0:
                continue
            parts.append(i)
            g = groups[i] if i < len(groups) else groups[-1]
            wt = max((cm.t_fixed
                      + (cm.t_row + cm.t_xattn * trace.cond_tokens)
                      * rows * segf[j])
                     / max(v, 1e-9) + cm.attn_time(total_rows, headf[j], v)
                     for j, v in enumerate(g))
            compute = max(compute, sub * wt)
            hop_bytes = kv_row * rows * seg_pad
            ring_t = max(ring_t, sub * hops *
                         (hop_bytes / cm.link_bw + cm.link_latency))
        if not parts:
            continue
        gather_rows = comm_lib.uneven_all_gather_rows(
            [ev.patches[i] for i in parts])
        kind = "full" if ev.synchronous else ev.exchange
        if kind != "full" or len(parts) <= 1:
            # degraded boundary: the hops overlap compute, pay the excess
            total += max(compute, ring_t)
            continue
        comm = gather_rows * row_bytes / cm.link_bw + cm.link_latency
        async_bytes = max(kv_row * ev.patches[i] for i in parts)
        total += max(compute, async_bytes / cm.link_bw, ring_t) + comm
    return total


# ----------------------------------------------------------------------
# frame-axis costing (DESIGN.md §16)
# ----------------------------------------------------------------------
#
# In a multi-frame trace the "workers" are patch-worker COLUMNS shared by
# every member row of the row-dealt frame placement (frames.
# frame_group_layout); member (g, w) steps its row's frame chunk over the
# column's token rows each fine step. Frame f > 0 attends over the 2N (own ⊕
# previous frame) context, so the t_ctx term charges about 2x the context
# rows per owned frame. Trace byte sizes are per frame; a "full" boundary
# wires every frame's K/V and latent slabs, and a multi-row placement adds
# the (G-1) cross-row previous-frame K/V handoffs.

def _simulate_frames(trace: ExecutionTrace, speeds: Sequence[float],
                     cm: CostModel) -> float:
    """Makespan of a multi-frame trace: per-member frame-chunk compute with
    the cross-frame context term plus per-frame boundary wire. Fused
    guidance composes: row work, context reads and published K/V double,
    the fixed overhead is shared (the fused convention of
    :func:`_simulate_guided`)."""
    from repro_torch.core import frames as frames_lib

    fplan = trace.frames
    F = fplan.num_frames
    G = fplan.n_groups
    mult = 2 if trace.guidance is not None else 1
    t_row_eff = cm.t_row + cm.t_xattn * trace.cond_tokens
    if G > 1:
        rows_layout, _ = frames_lib.frame_group_layout(speeds, G)
        n_cols = len(rows_layout[0])
    else:
        rows_layout, n_cols = None, len(speeds)
    kv_row = _kv_bytes_per_row(trace) * mult
    total = 0.0
    for ev in trace.events:
        parts: List[int] = []
        total_rows = max(sum(ev.patches), 1)
        row_bytes = trace.latent_bytes / total_rows
        # context rows a member row reads per fine step: 2N per owned
        # frame, minus the previous-frame half frame 0 does not have
        ctx = [mult * total_rows
               * (2 * fplan.groups[g] - (1 if g == 0 else 0))
               for g in range(G)]
        compute = async_b = 0.0
        for i, (sub, rows) in enumerate(zip(ev.substeps, ev.patches)):
            if sub == 0 or rows == 0:
                continue
            parts.append(i)
            members = ([(rows_layout[g][min(i, n_cols - 1)], g)
                        for g in range(G)] if rows_layout is not None
                       else [(speeds[i], 0)])
            wt = max(fplan.groups[g]
                     * (cm.t_fixed + t_row_eff * rows * mult)
                     / max(v, 1e-9) + cm.attn_time(ctx[g], 1.0, v)
                     for v, g in members)
            compute = max(compute, sub * wt)
            async_b = max(async_b, max(kv_row * rows * fplan.groups[g]
                                       for _, g in members))
        if not parts:
            continue
        gather_rows = comm_lib.uneven_all_gather_rows(
            [ev.patches[i] for i in parts])
        handoff = (G - 1) * kv_row * total_rows / cm.link_bw
        if ev.synchronous:
            # warm-up: per-step per-frame activation sync + latent slabs
            comm_bytes = gather_rows * row_bytes * F
            if len(parts) > 1:
                comm_bytes += F * sum(kv_row * ev.patches[i] for i in parts)
                total += compute + comm_bytes / cm.link_bw \
                    + handoff + cm.link_latency
            else:
                total += compute + handoff
            continue
        if ev.exchange != "full" or len(parts) <= 1:
            total += compute             # degraded boundary: nothing moves
            continue
        comm = gather_rows * row_bytes * F / cm.link_bw + cm.link_latency
        total += max(compute, async_b / cm.link_bw) + comm + handoff
    return total


def simulate_trace(trace: ExecutionTrace, speeds: Sequence[float],
                   cm: CostModel) -> float:
    """End-to-end makespan (s) of a schedule on devices with given speeds."""
    if trace.stages and len(trace.stages) > 1:
        return _simulate_staged(trace, speeds, cm)
    if trace.seq is not None and len(trace.seq.segments) > 1:
        return _simulate_seq(trace, speeds, cm)
    # frames dispatch before guidance: a guided multi-frame trace is a frame
    # trace whose members evaluate both branches
    if trace.frames is not None and trace.frames.num_frames > 1:
        return _simulate_frames(trace, speeds, cm)
    if trace.guidance is not None:
        return _simulate_guided(trace, speeds, cm)
    total = 0.0
    kv_row = _kv_bytes_per_row(trace)
    for ev in trace.events:
        compute = 0.0
        parts: List[int] = []            # workers that actually exchanged
        total_rows = max(sum(ev.patches), 1)
        for i, (sub, rows) in enumerate(zip(ev.substeps, ev.patches)):
            if sub == 0 or rows == 0:
                continue
            parts.append(i)
            # every patch worker reads the FULL context's K/V with all heads
            step_t = cm.step_time(rows, speeds[i]) \
                + cm.attn_time(total_rows, 1.0, speeds[i]) \
                + cm.xattn_time(rows, trace.cond_tokens, speeds[i])
            compute = max(compute, sub * step_t)
        row_bytes = trace.latent_bytes / total_rows
        # uneven all-gather of x: per-worker padded slab wire bytes — a lone
        # worker (or an all-skip boundary) moves nothing
        gather_rows = comm_lib.uneven_all_gather_rows(
            [ev.patches[i] for i in parts])
        if ev.synchronous:
            # warmup: per-step activation sync (staged K/V) + latent slabs
            comm_bytes = gather_rows * row_bytes
            if len(parts) > 1:
                comm_bytes += sum(kv_row * ev.patches[i] for i in parts)
                total += compute + comm_bytes / cm.link_bw + cm.link_latency
            else:
                total += compute
            continue
        if ev.exchange != "full" or len(parts) <= 1:
            # stale/predictive boundary (or nothing to exchange): pure
            # compute — no gather, no KV broadcast, no link latency
            total += compute
            continue
        comm = gather_rows * row_bytes / cm.link_bw + cm.link_latency
        # async KV publication is masked by compute; charge only the excess
        async_bytes = max(kv_row * ev.patches[i] for i in parts)
        total += max(compute, async_bytes / cm.link_bw) + comm
    return total


def simulate_tensor_parallel(n_steps: int, n_devices: int, n_layers: int,
                             full_rows: int, speeds: Sequence[float],
                             cm: CostModel, act_bytes_per_layer: int) -> float:
    """Baseline TP (paper §V-A; :mod:`repro_torch.core.tensor_parallel`):
    every layer's work split 1/N across devices with a synchronous
    all-reduce per layer => straggler-bound per layer. The float operations
    are the reference's, in its order, so the two agree exactly."""
    per_layer_compute = max(
        cm.step_time(full_rows, v) / (n_layers * n_devices) for v in speeds)
    # ring all-reduce ~ 2*(N-1)/N * bytes / bw
    ar = 2 * (n_devices - 1) / n_devices * act_bytes_per_layer / cm.link_bw \
        + cm.link_latency
    per_step = n_layers * (per_layer_compute + ar) + cm.t_fixed / min(speeds)
    return n_steps * per_step


def uniform_pp_latency(n_steps: int, rows_total: int, speeds: Sequence[float],
                       cm: CostModel, latent_bytes: int) -> float:
    """Closed-form patch-parallelism latency (equal patches, equal steps)."""
    n = len(speeds)
    rows = rows_total / n
    per_step = max(cm.step_time(rows, v) for v in speeds)
    comm = latent_bytes / cm.link_bw + cm.link_latency
    return n_steps * (per_step + comm)
