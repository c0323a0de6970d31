"""Video / multi-frame diffusion as the frame axis of a STADI schedule — the
port of ``repro.core.frames`` (DESIGN.md §16).

A video latent is ``[B, F, H, W, C]``: F frames denoised jointly. Each frame
keeps its own DistriFusion published K/V. Every frame ``f > 0`` attends over
its own published context concatenated with frame ``f-1``'s: a 2N-token
context whose first N rows take the fresh rows of the patch, read by kernel
K1 like any other stale context (its stale length is free). The previous
frame's half ages under the same full/skip/predict boundary policy as the
within-frame halo, so stale_async and predictive compose with frames.

Two placements, one numerics:

  * frame-SEQUENTIAL (``n_groups == 1``): every patch worker evaluates all F
    frames of its rows each substep.
  * frame-PARALLEL (``n_groups > 1``): the speed-sorted devices are dealt
    into ``n_groups`` member ROWS of ``n // n_groups`` patch-worker columns
    (:func:`frame_group_layout`); row ``g`` owns the contiguous,
    speed-proportional frame chunk ``bounds[g]`` (:func:`frame_partition`).
    The previous-frame K/V of each chunk's first frame crosses a row
    boundary.

Frame evals within a fine step follow SNAPSHOT semantics: every frame's
substep reads the published buffers of the LAST boundary, and publishes land
at the next one. The numerics therefore do not depend on ``n_groups``, and
frame 0, which never sees a previous frame, runs the very step functions of
:mod:`repro_torch.core.patch_parallel`: its trajectory is bitwise the image
path's. :func:`run_frames` is the emulated executor; the multi-rank one is
:func:`repro_torch.core.spmd.run_spmd_frames`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import buffers as buf_lib
from repro_torch.core import comm as comm_lib
from repro_torch.core import events as ir
from repro_torch.core import hetero
from repro_torch.core import patch_parallel as pp
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.schedule import patch_bounds
from repro_torch.kernels import ops as kops
from repro_torch.models.diffusion import dit


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """The frame-axis allocation every consumer shares.

    num_frames: latent frames F (1 = image; the whole axis degenerates)
    groups:     frames per group-member row, sum == F. ``(F,)`` is the
                frame-sequential placement; ``len(groups) > 1`` deals the
                cluster into member rows x patch-worker columns. Row ``g``
                owns the contiguous frame chunk ``bounds[g]``, so exactly
                one previous-frame context crosses each row boundary.
    """
    num_frames: int
    groups: Tuple[int, ...]

    def __post_init__(self):
        if self.num_frames < 1:
            raise ValueError(f"need at least one frame, got {self.num_frames}")
        if not self.groups:
            raise ValueError("frame plan needs at least one group")
        if any(g < 1 for g in self.groups):
            raise ValueError(f"every frame group needs >= 1 frame, got "
                             f"{list(self.groups)}")
        if sum(self.groups) != self.num_frames:
            raise ValueError(f"frame groups {list(self.groups)} sum to "
                             f"{sum(self.groups)}, plan has "
                             f"{self.num_frames} frames")

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def framed(self) -> bool:
        """True when the frame axis is non-degenerate (events are emitted)."""
        return self.num_frames > 1

    @property
    def bounds(self) -> List[Tuple[int, int]]:
        """Contiguous [lo, hi) frame ids per group-member row."""
        lo = 0
        out = []
        for g in self.groups:
            out.append((lo, lo + g))
            lo += g
        return out

    def row_of(self, frame: int) -> int:
        """The group-member row that owns ``frame``."""
        for g, (lo, hi) in enumerate(self.bounds):
            if lo <= frame < hi:
                return g
        raise IndexError(f"frame {frame} is outside the plan's "
                         f"{self.num_frames} frames")


def frame_partition(num_frames: int, n_groups: int,
                    speeds: Optional[Sequence[float]] = None) -> List[int]:
    """Frames per group-member row, speed-proportional with every row keeping
    at least one frame: the frame analogue of the depth allocator
    (:func:`repro_torch.core.hetero.stage_partition`, same largest-remainder
    rounding). ``speeds=None`` partitions uniformly."""
    if n_groups < 1:
        raise ValueError(f"need at least one frame group, got {n_groups}")
    if n_groups > num_frames:
        raise ValueError(f"frame_groups={n_groups} cannot split "
                         f"{num_frames} frames (>= 1 frame per group)")
    sp = list(speeds)[:n_groups] if speeds else [1.0] * n_groups
    if len(sp) < n_groups:
        sp = sp + [sp[-1]] * (n_groups - len(sp))
    return hetero.stage_partition(num_frames, sp)


def make_frame_plan(num_frames: int, n_groups: int = 1,
                    speeds: Optional[Sequence[float]] = None) -> FramePlan:
    """The FramePlan for ``n_groups`` member rows; ``speeds`` are per-ROW
    aggregate speeds (see :func:`frame_group_layout`), None = uniform."""
    return FramePlan(num_frames,
                     tuple(frame_partition(num_frames, n_groups, speeds)))


def frame_group_layout(speeds: Sequence[float], n_groups: int
                       ) -> Tuple[List[List[float]], List[float]]:
    """Device placement of a frame-parallel plan, the one grouping the
    planner, the frame cost model and ``spmd_frames`` share: the
    speed-sorted devices dealt ROW-wise into ``n_groups`` contiguous blocks
    of ``n // n_groups`` patch-worker columns, so row ``g`` is the g-th
    fastest block and one frame partition fits every column. Leftover
    devices (n % n_groups) idle. Returns (rows, row_speeds): ``rows[g]`` the
    member speeds of row g (column order, fastest first), ``row_speeds[g]``
    their sum."""
    n = len(speeds)
    if n_groups < 1:
        raise ValueError(f"need at least one frame group, got {n_groups}")
    n_cols = n // n_groups
    if n_cols < 1:
        raise ValueError(
            f"frame_groups={n_groups} needs at least {n_groups} devices, "
            f"the cluster has {n}")
    order = sorted(speeds, reverse=True)
    rows = [[order[g * n_cols + w] for w in range(n_cols)]
            for g in range(n_groups)]
    return rows, [sum(r) for r in rows]


def validate_frames(frames: FramePlan, x_T) -> None:
    """Fail fast when a video latent does not match the frame plan."""
    if x_T.ndim != 5:
        raise ValueError(
            f"multi-frame generation needs a [B, F, H, W, C] latent, got "
            f"shape {tuple(x_T.shape)}")
    if x_T.shape[1] != frames.num_frames:
        raise ValueError(
            f"latent carries {x_T.shape[1]} frames, the frame plan expects "
            f"{frames.num_frames}")


def ctx(own, prev, tok_axis: int = 2) -> Tuple:
    """The 2N-token cross-frame context: own published (k, v) ⊕ the previous
    frame's along the token axis (3 when the buffers carry the leading CFG
    branch axis), new tensors."""
    return (torch.cat([own[0], prev[0]], dim=tok_axis),
            torch.cat([own[1], prev[1]], dim=tok_axis))


def frame_eval(params, cfg, x, t, cond, row_start: int, frame: int,
               buffers=None, return_kv: bool = True, scale=None):
    """One denoiser eval of frame ``frame > 0`` (frame-conditioned; buffers
    None or its 2N-token context): unguided, or with ``scale`` both branches
    in one forward combined by kernel K3 (:func:`patch_parallel.
    _guided_step`'s form). Returns (eps, fresh (k, v) or None)."""
    if scale is None:
        return dit.forward_patch(params, cfg, x, t, cond, row_start,
                                 buffers=buffers, return_kv=return_kv,
                                 frame=frame)
    eps2, kvs = dit.forward_patch_cfg(params, cfg, x, t, cond, row_start,
                                      buffers=buffers, return_kv=return_kv,
                                      frame=frame)
    return kops.cfg_epilogue(eps2[0], eps2[1], scale, with_delta=False), kvs


def run_frames(params, cfg, sched, x_T, cond, plan, patches,
               interval_hook=None, exchange: str = "sync",
               exchange_refresh: int = 2,
               frames: Optional[FramePlan] = None,
               guidance=None) -> pp.RunResult:
    """Emulated multi-frame executor (reference ``run_frames``).

    Interprets the same IR stream as ``run_schedule``, including the
    :class:`~repro_torch.core.events.FrameShard` events of a multi-frame
    plan, holding one published K/V state PER FRAME. Every substep of frame
    f > 0 attends over ``concat(pub[f], pub[f-1])`` of the last boundary, so
    the numerics are independent of ``frames.groups``.

    ``frames=None`` or a single-frame plan delegates to
    :func:`repro_torch.core.patch_parallel.run_schedule` (a leading frame
    axis of 1 is squeezed and restored). Frame 0 of a multi-frame run makes
    the image path's calls and is bitwise its trajectory.

    ``guidance``: an optional FUSED GuidancePlan. Every frame eval runs both
    branches in one forward (K1 at batch 2 over the branch-stacked context)
    and combines them with K3; split and interleaved guidance raise.
    """
    guided = guidance is not None
    if guided:
        if guidance.mode != "fused":
            raise ValueError(
                f"guidance mode {guidance.mode!r} is not composed with the "
                "frame axis: guided video runs FUSED classifier-free "
                "guidance only (branch-vmapped per member — DESIGN.md §17)")
        if cond is None:
            raise ValueError("guided generation needs a condition")
        if interval_hook is not None:
            raise ValueError("online rebalancing is not supported with "
                             "guidance (the branch pairing is static)")
    if frames is None or frames.num_frames == 1:
        x = x_T[:, 0] if x_T.ndim == 5 else x_T
        res = pp.run_schedule(params, cfg, sched, x, cond, plan, patches,
                              interval_hook=interval_hook, exchange=exchange,
                              exchange_refresh=exchange_refresh,
                              guidance=guidance)
        if x_T.ndim == 5:
            res = pp.RunResult(res.image[:, None], res.trace)
        res.trace.frames = frames
        return res
    validate_frames(frames, x_T)

    F = frames.num_frames
    p = cfg.patch_size
    M_base = plan.m_base
    plan0, patches0 = plan, list(patches)
    ts = sampler_lib.ddim_timesteps(sched.T, M_base).tolist()
    policy = comm_lib.get_exchange(exchange, exchange_refresh)
    tok_axis = 3 if guided else 2        # buffers gain a leading branch axis
    scale = guidance.scale if guided else None

    B = x_T.shape[0]
    xs = [x_T[:, f].clone(memory_format=torch.contiguous_format)
          for f in range(F)]
    records: List[ir.IntervalEvent] = []
    published: List[Optional[buf_lib.Published]] = [None] * F
    prev_published: List[Optional[buf_lib.Published]] = [None] * F
    read_pub: List[Optional[buf_lib.Published]] = [None] * F
    pending = [dict() for _ in range(F)]
    new_slabs = [dict() for _ in range(F)]
    interval: Optional[ir.ComputeInterval] = None

    def frame_full(f, m):
        """One full-image eval of frame f at fine step m (warm-up and the
        M_w == 0 bootstrap). Returns (eps, kvs)."""
        if f == 0:                       # the image path's full step
            if guided:
                eps, _, kvs = pp._guided_step(params, cfg, xs[0], ts[m], cond,
                                              0, scale)
                return eps, kvs
            return dit.forward_patch(params, cfg, xs[0], ts[m], cond, 0)
        buffers = (None if published[f] is None
                   else ctx((published[f].k, published[f].v),
                            (published[f - 1].k, published[f - 1].v),
                            tok_axis))
        return frame_eval(params, cfg, xs[f], ts[m], cond, 0, f,
                          buffers=buffers, scale=scale)

    gen = ir.lower(plan, patches, policy, guidance=guidance, frames=frames)
    send = None
    while True:
        try:
            ev = gen.send(send)
        except StopIteration:
            break
        send = None

        if isinstance(ev, ir.Warmup):
            # snapshot: every frame reads the previous step's published K/V,
            # then all publish at once
            kv_new = []
            for f in range(F):
                eps, kvs = frame_full(f, ev.fine_step)
                xs[f] = sampler_lib.ddim_step(sched, xs[f], eps,
                                              ts[ev.fine_step],
                                              ts[ev.fine_step + 1])
                kv_new.append(kvs)
            for f in range(F):
                published[f] = buf_lib.Published(kv_new[f][0], kv_new[f][1],
                                                 ev.fine_step)
                read_pub[f] = published[f]
            records.append(ir.warmup_record(ev, frames=F))

        elif isinstance(ev, ir.FrameShard):
            pass                         # placement only; numerics invariant

        elif isinstance(ev, ir.ComputeInterval):
            if published[0] is None:     # M_w == 0: bootstrap buffers once
                kv_new = [frame_full(f, 0)[1] for f in range(F)]
                for f in range(F):
                    published[f] = buf_lib.Published(kv_new[f][0],
                                                     kv_new[f][1], -1)
                    read_pub[f] = published[f]
            interval = ev
            bounds_tok = patch_bounds(ev.patches)
            pending = [dict() for _ in range(F)]
            new_slabs = [dict() for _ in range(F)]
            for f in range(F):
                # frame f's 2N context, built once an interval and dropped
                # after its frame
                bufs = (None if f == 0 else
                        ctx((read_pub[f].k, read_pub[f].v),
                            (read_pub[f - 1].k, read_pub[f - 1].v), tok_axis))
                for i in ev.workers:
                    r = ev.ratios[i]
                    row0, row1 = bounds_tok[i]
                    x_loc = xs[f][:, row0 * p:row1 * p]
                    for s in range(ev.substeps[i]):
                        t_from = ts[ev.fine_step + s * r]
                        t_to = ts[ev.fine_step + (s + 1) * r]
                        if f == 0 and guided:    # the guided image substep
                            eps, kvs = pp.guided_substep(
                                params, cfg, x_loc, t_from, cond, row0,
                                read_pub[0], published[0], guidance, True,
                                {}, i, first=(s == 0))
                        elif f == 0:             # the image substep
                            eps, kvs = dit.forward_patch(
                                params, cfg, x_loc, t_from, cond, row0,
                                buffers=(read_pub[0].k, read_pub[0].v),
                                return_kv=(s == 0))
                        else:
                            eps, kvs = frame_eval(
                                params, cfg, x_loc, t_from, cond, row0, f,
                                buffers=bufs, return_kv=(s == 0),
                                scale=scale)
                        x_loc = sampler_lib.ddim_step(sched, x_loc, eps,
                                                      t_from, t_to)
                        if s == 0:
                            buf_lib.publish_local(pending[f], i, kvs[0],
                                                  kvs[1],
                                                  row0 * cfg.tokens_per_side)
                    new_slabs[f][i] = x_loc
                del bufs

        elif isinstance(ev, ir.Exchange):
            bounds_tok = patch_bounds(ev.patches)
            for f in range(F):
                for i in interval.workers:
                    row0, row1 = bounds_tok[i]
                    xs[f][:, row0 * p:row1 * p] = new_slabs[f][i]
                if ev.kind == "full":
                    prev_published[f] = published[f]
                    published[f] = buf_lib.merge(published[f], pending[f],
                                                 ev.fine_step, axis=tok_axis)
                    read_pub[f] = published[f]
                elif ev.kind == "skip":
                    read_pub[f] = published[f]
                elif ev.kind == "predict":
                    read_pub[f] = buf_lib.extrapolate(prev_published[f],
                                                      published[f],
                                                      ev.fine_step)
            rec = ir.record(interval, ev.kind, frames=F)
            records.append(rec)
            if interval_hook is not None and ev.fine_step < M_base:
                send = interval_hook(ev.fine_step, rec)

    trace = ir.make_trace(records, plan0, patches0, cfg, int(B),
                          guidance=guidance, frames=frames)
    return pp.RunResult(torch.stack(xs, dim=1), trace)


def max_frame_staleness(records) -> int:
    """Worst-case age, in adaptive intervals, of the previous-frame K/V any
    substep attended over: under snapshot semantics even a just-merged
    context is one interval old when the next interval reads it, and every
    degraded ("skip"/"predict") boundary ages it one interval more, so the
    bound is ``refresh_every`` under stale_async. Warm-up steps republish
    every fine step and single-frame records contribute 0."""
    age = 0
    worst = 0
    for ev in records:
        if ev.synchronous:
            age = 0
            continue
        age += 1
        if ev.frames > 1:
            worst = max(worst, age)
        if ev.exchange == "full":
            age = 0
    return worst
