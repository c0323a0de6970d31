"""Multi-rank execution of a STADI schedule on ``torch.distributed`` — the
port of ``repro.core.spmd`` (``run_spmd``, ``run_spmd_guidance``,
``run_spmd_seq``, ``run_spmd_pipefuse``, ``run_spmd_frames`` and the
serving engine's ``make_interval_step``).

One process per rank, each owning one row-slab of the latent padded to the
largest patch (``Pmax`` rows), as the reference's ``shard_map`` body does on
each device of its mesh. Every rank interprets the same IR event stream of
:func:`repro_torch.core.events.lower`:

    Warmup           the full-image forward, on every rank (kernel K1)
    ComputeInterval  R fine steps on the rank's padded slab against the
                     scratch-padded published K/V (kernel K2 in every
                     block), publishing the first substep's fresh K/V
    Exchange "full"  uneven all-gathers (:mod:`repro_torch.core.comm`)
                     rebuild the latent and merge every rank's fresh K/V
                     valid prefix; "skip" keeps the buffers stale;
                     "predict" extrapolates them from the last two "full"

The reference runs a slow device's inactive substeps in lockstep and
discards them (``jnp.where(active, ...)``), its SPMD stand-in for per-GPU
step skipping; here each rank runs its own program, so a rank simply skips
the forward of an inactive substep. Only substep 0, always active,
publishes K/V, so the image is the same.

Guidance (DESIGN.md §12): fused guidance (``run_spmd``) folds both branches
into the batch of every forward (:func:`dit.forward_patch_cfg`, so K2 runs
at batch 2B) and combines them with kernel K3. Split guidance
(``run_spmd_guidance``) runs on ``2 * n_pairs`` ranks: ranks ``[0, n)`` the
conditional branch, ``[n, 2n)`` the unconditional one, each branch with its
own patch-worker group and K/V that never crosses branches; the only
cross-branch traffic is the per-eval float32 ``all_reduce`` of
``coeff * eps`` over each cond/uncond partner pair, ``coeff = (w, 1 - w)``.

Sequence parallelism (DESIGN.md §13, ``run_spmd_seq``) runs on ``S * N``
ranks, rank ``s * N + d`` being seq member s of patch worker d (the
reference's ``("seq", "dev")`` mesh order). Each seq row runs the body
above over its N workers, gathering and merging over its dev subgroup (the
published K/V stays replicated over seq); every buffered attention read
goes through the seq subgroup of the rank's dev column instead of K2: the
Ulysses head scatter, S ring hops of K/V segments, each attended by kernel
K4 and merged with an fp32 online log-sum-exp, and the regather.

The displaced stage chain (DESIGN.md §11, ``run_spmd_pipefuse``) runs one
rank per STAGE: rank s holds the displaced K/V context of its own blocks,
which never crosses ranks, and runs its blocks when a micro-task reaches it
(:func:`repro_torch.core.comm.stage_handoff` brings the hidden state from
rank s - 1); the last stage's eps goes to every rank for the replicated DDIM
update.

The frame axis (DESIGN.md §16, ``run_spmd_frames``) runs on ``G * W``
ranks, rank ``g * W + w`` being patch-worker column w of member row g. Row g
owns the contiguous frame chunk ``frames.bounds[g]`` and runs the body above
for each of its frames, gathering over its row subgroup; the previous
frame's K/V crosses a row boundary from column w of row g - 1 to column w of
row g (:func:`repro_torch.core.comm.stage_handoff`).

``make_interval_step`` is the serving engine's round-granular form of
``run_spmd``: one adaptive interval of a lane cohort per call, the state
carried between calls by the caller.

Every rank must call these functions together inside an initialized
default process group (:mod:`repro_torch.launch.ranks` starts one); each
returns the full final image on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.diffusion import DiTConfig
from repro_torch.core import buffers as buf_lib
from repro_torch.core import comm as comm_lib
from repro_torch.core import events as ir
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.pipefuse import (refuse_prompt, stage_blocks,
                                       stage_bounds)
from repro_torch.core.sampler import NoiseSchedule
from repro_torch.core.schedule import TemporalPlan, patch_bounds
from repro_torch.kernels import ops as kops
from repro_torch.models.diffusion import dit


@dataclasses.dataclass(frozen=True)
class Layout:
    """The static slab layout every rank shares."""
    p: int                    # latent rows per token row (patch size)
    wp: int                   # tokens per token row
    Pmax: int                 # token rows of the largest patch
    Nl_max: int               # tokens of the padded slab
    row_starts: Tuple[int, ...]


def _static_layout(cfg: DiTConfig, patches: Sequence[int]) -> Layout:
    wp = cfg.tokens_per_side
    Pmax = max(patches)
    starts = np.concatenate([[0], np.cumsum(patches)[:-1]]).astype(int)
    return Layout(cfg.patch_size, wp, Pmax, Pmax * wp,
                  tuple(int(s) for s in starts))


def _require_process_group(backend: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"backend {backend!r} runs inside the ranks of a torch.distributed "
            "process group, and none is initialized: start the ranks with "
            "repro_torch.launch.ranks.spawn (or the stadi_infer CLI), or run "
            "backend 'emulated' in one process")


def _reslice(x_full, start: int, lay: Layout):
    """This rank's slab: rows from ``start`` on, padded to Pmax token rows
    (past the image's last row with zeros, as the reference pads)."""
    rows = lay.Pmax * lay.p
    x_pad = comm_lib.pad_to(x_full, x_full.shape[1] + rows, axis=1)
    return x_pad[:, start * lay.p:start * lay.p + rows].clone()


def _run_substeps(params, cfg: DiTConfig, sched: NoiseSchedule, ts, m_base,
                  R, my_slab, cond, read_k, read_v, my_start, my_tok,
                  my_ratio, m0, guidance_scale=None, eps_combine=None,
                  attend_fn=None, frame=None, ctx_tokens=None):
    """R fine steps on this rank's padded slab: a rank with interval ratio r
    runs every r-th substep and skips the others (the reference computes
    and discards them). Returns the slab and the FIRST substep's fresh K/V
    (Alg. 1 publishes it).

    ``guidance_scale`` makes each eval a fused CFG eval against
    branch-stacked buffers, combined by kernel K3; ``eps_combine``
    post-processes the raw local eps (split guidance's cross-branch
    all_reduce); ``attend_fn`` replaces every buffered attention read (the
    sequence-parallel ring read); ``frame`` and ``ctx_tokens`` make each
    eval a video frame's against its 2N context (:func:`run_spmd_frames`)."""
    fresh = None
    for s in range(0, R, my_ratio):
        t_from = ts[m0 + s]
        t_to = ts[min(m0 + s + my_ratio, m_base)]
        if guidance_scale is not None:
            eps2, kvs = dit.forward_patch_cfg(
                params, cfg, my_slab, t_from, cond, my_start,
                buffers=(read_k, read_v), return_kv=(s == 0),
                valid_tokens=my_tok)
            eps = kops.cfg_epilogue(eps2[0], eps2[1], guidance_scale,
                                    with_delta=False)
        else:
            eps, kvs = dit.forward_patch(
                params, cfg, my_slab, t_from, cond, my_start,
                buffers=(read_k, read_v), return_kv=(s == 0),
                valid_tokens=my_tok, attend_fn=attend_fn, frame=frame,
                ctx_tokens=ctx_tokens)
        if eps_combine is not None:
            eps = eps_combine(eps)
        my_slab = sampler_lib.ddim_step(sched, my_slab, eps, t_from, t_to)
        if s == 0:
            fresh = kvs
    return my_slab, fresh


def _gather_and_merge(cfg: DiTConfig, patches, lay: Layout, my_slab, fresh,
                      pub, group=None, tok_axis: int = 2, merge_kv=True):
    """Interval boundary ("full"): padded uneven all-gathers rebuild the
    full latent and every rank's fresh K/V valid prefix. The prefixes tile
    the image's ``n_tokens`` rows in rank order, so the merged buffers are
    the gathered K/V followed by the old scratch tail — new tensors; the
    old ones stay as they were (prediction keeps them). ``merge_kv=False``
    is the "skip" kind: only the latent is gathered and ``pub`` comes back
    as it was."""
    x_full = comm_lib.uneven_all_gather_padded(
        my_slab, [n * lay.p for n in patches], group, axis=1)
    if not merge_kv:
        return x_full, pub
    sizes = [n * lay.wp for n in patches]
    merged = []
    for new, old in zip(fresh, pub):
        got = comm_lib.uneven_all_gather_padded(new, sizes, group,
                                                axis=tok_axis)
        tail = old.narrow(tok_axis, cfg.n_tokens,
                          old.shape[tok_axis] - cfg.n_tokens)
        merged.append(torch.cat([got.to(old.dtype), tail], dim=tok_axis))
    return x_full, tuple(merged)


def _execute(params, cfg: DiTConfig, sched: NoiseSchedule, x_full, cond,
             plan: TemporalPlan, patches: Sequence[int], evs, idx: int,
             group=None, guidance_scale=None, eps_combine=None,
             attend_fn=None):
    """The body every rank runs: interpret the IR events for patch worker
    ``idx`` of ``group``. ``guidance_scale`` = fused CFG (branch-stacked
    buffers); ``eps_combine`` = split CFG's cross-branch combine;
    ``attend_fn`` = the sequence-parallel buffered read. SeqShard events
    carry no numerics."""
    lay = _static_layout(cfg, patches)
    my_start = lay.row_starts[idx]
    my_tok = patches[idx] * lay.wp
    my_ratio = plan.ratios[idx] or 1
    ts = sampler_lib.ddim_timesteps(sched.T, plan.m_base).tolist()
    fused = guidance_scale is not None
    tok_axis = 3 if fused else 2

    def full_forward(x, t, want_eps=True):
        """Synchronous full-image eval: (eps or None, fresh K/V)."""
        if fused:
            eps2, kvs = dit.forward_patch_cfg(params, cfg, x, t, cond, 0)
            eps = (kops.cfg_epilogue(eps2[0], eps2[1], guidance_scale,
                                     with_delta=False) if want_eps else None)
            return eps, kvs
        eps, kvs = dit.forward_patch(params, cfg, x, t, cond, 0)
        if eps_combine is not None and want_eps:
            eps = eps_combine(eps)
        return eps, kvs

    def scratch_pad(kv):
        return comm_lib.pad_to(kv, cfg.n_tokens + lay.Nl_max, axis=tok_axis)

    pub = prev = read = None          # published, the one before, what is read
    my_slab = fresh = None
    m_prev = m_last = None            # fine steps of the last two "full"
    for ev in evs:
        if isinstance(ev, ir.Warmup):
            t_from, t_to = ts[ev.fine_step], ts[ev.fine_step + 1]
            eps, pub = full_forward(x_full, t_from)
            x_full = sampler_lib.ddim_step(sched, x_full, eps, t_from, t_to)
            m_last = ev.fine_step
        elif isinstance(ev, ir.ComputeInterval):
            if my_slab is None:       # entering the adaptive phase
                if pub is None:       # M_w == 0: bootstrap the buffers once
                    _, pub = full_forward(x_full, ts[0], want_eps=False)
                    m_last = -1
                pub = tuple(scratch_pad(kv) for kv in pub)
                read = pub
                my_slab = _reslice(x_full, my_start, lay)
            my_slab, fresh = _run_substeps(
                params, cfg, sched, ts, plan.m_base, ev.length, my_slab,
                cond, read[0], read[1], my_start, my_tok, my_ratio,
                ev.fine_step, guidance_scale=guidance_scale,
                eps_combine=eps_combine, attend_fn=attend_fn)
        elif isinstance(ev, ir.Exchange):
            if ev.kind == "full":
                prev = pub
                m_prev, m_last = m_last, ev.fine_step
                x_full, pub = _gather_and_merge(cfg, patches, lay, my_slab,
                                                fresh, pub, group, tok_axis)
                read = pub
                my_slab = _reslice(x_full, my_start, lay)
            elif ev.kind == "skip":
                read = pub            # stay stale
            elif ev.kind == "predict":
                f = (buf_lib.extrapolation_factor(m_prev, m_last,
                                                  ev.fine_step)
                     if m_prev is not None else 0.0)
                read = (tuple(buf_lib.extrapolate_arrays(a, b, f)
                              for a, b in zip(pub, prev)) if f else pub)
    return x_full


def run_spmd(params, cfg: DiTConfig, sched: NoiseSchedule, x_T, cond,
             plan: TemporalPlan, patches: Sequence[int],
             exchange: str = "sync", exchange_refresh: int = 2,
             guidance=None):
    """STADI across the ranks of the default process group, one rank per
    patch worker (reference ``repro.core.spmd.run_spmd``). Returns the final
    image [B,H,W,C] on every rank.

    ``guidance``: a FUSED GuidancePlan turns every eval into a
    branch-batched CFG eval (buffers branch-stacked on each rank);
    split/interleaved placement needs the branch groups of
    :func:`run_spmd_guidance` (the "spmd_guidance" backend)."""
    if guidance is not None and guidance.mode != "fused":
        raise ValueError(
            f"run_spmd executes fused guidance only; {guidance.mode!r} "
            "placement needs the guidance mesh axis of run_spmd_guidance "
            "(backend 'spmd_guidance')")
    if guidance is not None and cond is None:
        raise ValueError("guided generation needs a class condition")
    _require_process_group("spmd")
    N, world = len(patches), dist.get_world_size()
    if world != N:
        raise ValueError(f"run_spmd runs one rank per patch worker: "
                         f"{N} workers, {world} ranks")
    policy = comm_lib.get_exchange(exchange, exchange_refresh)
    evs = list(ir.lower(plan, patches, policy, guidance=guidance))
    return _execute(params, cfg, sched, x_T, cond, plan, patches, evs,
                    dist.get_rank(), guidance_scale=(
                        guidance.scale if guidance is not None else None))


def _world_check(what: str, n: int, unit: str) -> None:
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"{what} runs one rank per {unit}: {n} {unit}s, "
                         f"{world} ranks")


def make_interval_step(cfg: DiTConfig, sched: NoiseSchedule,
                       plan: TemporalPlan, patches: Sequence[int],
                       exchange_kind: str = "full"):
    """Round-granular multi-rank STADI: one adaptive interval a call
    (reference ``repro.core.spmd.make_interval_step``).

    Returns ``fn(params, x_full [G,H,W,C], cond [G], pub_k, pub_v
    [L,G,N,H,hd], m0) -> (x_full, pub_k, pub_v)``, which every rank calls
    together: the R = plan.lcm fine steps from fine step ``m0`` (an int) on
    the rank's padded slab with the same inactive-substep skipping, padded
    all-gathers and publish-at-first-substep rule as :func:`run_spmd`, so
    every buffered read is kernel K2. The carried state lives with the
    caller between calls, so the serving engine interleaves many cohorts
    of lanes across rounds (DESIGN.md §9); the buffers are scratch-padded on
    entry and sliced back to ``cfg.n_tokens`` on exit, new tensors.

    ``exchange_kind`` picks the boundary: "full" merges the fresh K/V,
    "skip" leaves the buffers as they were (predictive callers extrapolate
    the buffers themselves and call the "skip" form). Eager PyTorch has no
    program to compile, so unlike the reference nothing is cached per
    variant."""
    if exchange_kind not in ("full", "skip"):
        raise ValueError(f"make_interval_step runs 'full' or 'skip' "
                         f"boundaries, not {exchange_kind!r}")
    _require_process_group("spmd")
    _world_check("make_interval_step", len(patches), "patch worker")
    lay = _static_layout(cfg, patches)
    idx = dist.get_rank()
    my_start = lay.row_starts[idx]
    my_tok = patches[idx] * lay.wp
    my_ratio = plan.ratios[idx] or 1
    ts = sampler_lib.ddim_timesteps(sched.T, plan.m_base).tolist()
    R = plan.lcm
    n_pad = cfg.n_tokens + lay.Nl_max

    def fn(params, x_full, cond, pub_k, pub_v, m0: int):
        pub = tuple(comm_lib.pad_to(b, n_pad, axis=2) for b in (pub_k, pub_v))
        my_slab = _reslice(x_full, my_start, lay)
        my_slab, fresh = _run_substeps(
            params, cfg, sched, ts, plan.m_base, R, my_slab, cond, pub[0],
            pub[1], my_start, my_tok, my_ratio, int(m0))
        x_full, pub = _gather_and_merge(cfg, patches, lay, my_slab, fresh,
                                        pub, merge_kv=exchange_kind == "full")
        return (x_full,) + tuple(b.narrow(2, 0, cfg.n_tokens) for b in pub)

    fn.substeps = len(range(0, R, my_ratio))   # this rank's forwards a call
    return fn


def run_spmd_pipefuse(params, cfg: DiTConfig, sched: NoiseSchedule, x_T,
                      cond, plan: TemporalPlan, patches: Sequence[int],
                      stages: Sequence[int], exchange: str = "sync",
                      exchange_refresh: int = 2):
    """The displaced stage chain on one rank per stage (reference
    ``repro.core.spmd.run_spmd_pipefuse``, DESIGN.md §11). Returns the final
    image [B,H,W,C] on every rank.

    Rank d owns the ``stages[d]`` contiguous blocks of its stage and the
    displaced K/V context of exactly those blocks. Per micro-task (the
    substep-major order of :func:`repro_torch.core.pipefuse.run_pipefuse`)
    every rank embeds the slab; rank d > 0 receives the hidden state from
    rank d - 1 (:func:`repro_torch.core.comm.stage_handoff`), runs its
    blocks against its context (kernel K1, static ``tok_start``) and writes
    its fresh rows into it; the last rank runs the head and its eps goes to
    every rank (:func:`repro_torch.core.comm.chain_broadcast`) for the
    replicated DDIM update. Where the reference runs every stage on every
    device in lockstep and masks the result, a rank here runs its blocks
    only. Warm-up steps run the full-depth forward on every rank, as in the
    reference. The numerics are those of ``run_pipefuse``."""
    stages = list(stages)
    S = len(stages)
    if sum(stages) != cfg.n_layers:
        raise ValueError(f"stages {stages} must cover all {cfg.n_layers} "
                         "blocks")
    if S == 1:
        return run_spmd(params, cfg, sched, x_T, cond, plan, patches,
                        exchange=exchange, exchange_refresh=exchange_refresh)
    refuse_prompt(cond, "the spmd_pipefuse backend")
    _require_process_group("spmd_pipefuse")
    _world_check("run_spmd_pipefuse", S, "stage")
    policy = comm_lib.get_exchange(exchange, exchange_refresh)
    evs = list(ir.lower(plan, patches, policy, stages=stages))
    me = dist.get_rank()
    lo, hi = stage_bounds(stages)[me]
    my_blocks = stage_blocks(params, lo, hi)
    pairs = (_subgroups([(s, s + 1) for s in range(S - 1)])
             if dist.get_backend() != "nccl" else [None] * (S - 1))
    p, wp = cfg.patch_size, cfg.tokens_per_side
    bounds_tok = patch_bounds(patches)
    ts = sampler_lib.ddim_timesteps(sched.T, plan.m_base).tolist()
    eps_dtype = params["final_proj"].dtype
    for name in ("final_mod_w", "final_mod_b"):
        eps_dtype = torch.promote_types(eps_dtype, params[name].dtype)

    def my_kv(kvs):
        """This stage's rows of a full-depth forward's K/V (a copy: the
        other stages' rows are not kept)."""
        return tuple(kv[lo:hi].clone() for kv in kvs)

    def micro_task(x_loc, t, row_start, ctx_k, ctx_v):
        rows_tok = x_loc.shape[1] // p
        h, c = dit.embed_patch(params, cfg, x_loc, t, cond, row_start)
        tok_start = row_start * wp
        if me > 0:                       # h becomes the receive buffer
            h = comm_lib.stage_handoff(h.contiguous(), me - 1, me,
                                       pairs[me - 1])
        h, (k, v) = dit.block_stack(my_blocks, cfg, h, c, tok_start,
                                    buffers=(ctx_k, ctx_v))
        rows = slice(tok_start, tok_start + h.shape[1])
        ctx_k[:, :, rows] = k
        ctx_v[:, :, rows] = v
        if me < S - 1:
            comm_lib.stage_handoff(h.contiguous(), me, me + 1, pairs[me])
            eps = torch.empty(x_loc.shape, dtype=torch.promote_types(
                h.dtype, eps_dtype), device=x_loc.device)
        else:
            eps = dit.final_head(params, cfg, h, c, rows_tok).contiguous()
        return comm_lib.chain_broadcast(eps, S - 1), k, v

    x_full = x_T.clone()
    my_pub = my_ctx = None               # (k, v) of my blocks
    pend = {}                            # worker -> (k, v, token start)
    for ev in evs:
        if isinstance(ev, ir.Warmup):
            t_from, t_to = ts[ev.fine_step], ts[ev.fine_step + 1]
            eps, kvs = dit.forward_patch(params, cfg, x_full, t_from, cond, 0)
            x_full = sampler_lib.ddim_step(sched, x_full, eps, t_from, t_to)
            my_pub = my_kv(kvs)
        elif isinstance(ev, ir.StageShift):
            if my_pub is None:           # M_w == 0: bootstrap once
                _, kvs = dit.forward_patch(params, cfg, x_full, ts[0], cond, 0)
                my_pub = my_kv(kvs)
            my_ctx = tuple(kv.clone() for kv in my_pub)
        elif isinstance(ev, ir.ComputeInterval):
            pend = {}
            for f in range(ev.length):
                for i in ev.workers:
                    r = ev.ratios[i]
                    if f % r:
                        continue
                    a, b = bounds_tok[i]
                    t_from = ts[ev.fine_step + f]
                    t_to = ts[ev.fine_step + f + r]
                    x_loc = x_full[:, a * p:b * p]
                    eps, k, v = micro_task(x_loc, t_from, a, *my_ctx)
                    x_full[:, a * p:b * p] = sampler_lib.ddim_step(
                        sched, x_loc, eps, t_from, t_to)
                    if f == 0:
                        pend[i] = (k, v, a * wp)
        elif isinstance(ev, ir.Exchange) and ev.kind == "full":
            for i in sorted(pend):       # merge substep-0 K/V, my blocks
                k, v, start = pend[i]
                for buf, new in zip(my_pub, (k, v)):
                    buf.narrow(2, start, new.shape[2]).copy_(new)
        # skip/predict: the pipe stays full and the context persists
    return x_full


def _frame_groups(G: int, W: int) -> Tuple[List, List]:
    """spmd_frames' subgroups: (the row of each member row g, ranks ``g * W
    .. g * W + W - 1``; the handoff pair of each row boundary b and column
    w, ranks ``(b - 1) * W + w`` and ``b * W + w``, indexed ``(b - 1) * W +
    w``, or None under NCCL, whose handoff is a send/recv pair)."""
    pairs = ([] if dist.get_backend() == "nccl" else
             [((b - 1) * W + w, b * W + w)
              for b in range(1, G) for w in range(W)])
    groups = _subgroups([range(g * W, (g + 1) * W) for g in range(G)] + pairs)
    return groups[:G], (groups[G:] if pairs else [None] * ((G - 1) * W))


def run_spmd_frames(params, cfg: DiTConfig, sched: NoiseSchedule, x_T, cond,
                    plan: TemporalPlan, patches: Sequence[int], frames,
                    exchange: str = "sync", exchange_refresh: int = 2):
    """The frame axis on ``G * W`` ranks (reference
    ``repro.core.spmd.run_spmd_frames``): G = ``frames.n_groups`` member
    rows of W = ``len(patches)`` patch-worker columns, rank ``g * W + w``
    column w of row g. Returns the final video [B, F, H, W, C] on every
    rank.

    Row g computes only the frames it owns, ``frames.bounds[g]``, each
    under the snapshot semantics of
    :func:`repro_torch.core.frames.run_frames`: every substep of frame
    f > 0 reads the 2N-token context of the last boundary, its own
    published K/V ⊕ frame f-1's what the substeps read (``ctx_tokens`` =
    2N keeps the scratch mask past both halves), so kernel K2 runs over a
    context of 2N + Nl_max rows. The frame f-1 that row g's first frame
    needs belongs to row g - 1: column w of row g - 1 hands it to column w
    of row g (:func:`repro_torch.core.comm.stage_handoff`) after every
    warm-up step (the published full-image K/V), and in the adaptive phase
    whenever what its substeps read changed (a "full" boundary, a
    prediction). Each row's gathers run in its row subgroup. Where the
    reference's lockstep mesh computes every frame on every row and masks
    what a row does not own, a rank here computes its row's frames only;
    the video is the same. At the end every frame is broadcast from its
    row, so every rank returns the whole video.

    ``frames=None`` or a single-frame plan delegates to :func:`run_spmd` (a
    leading frame axis of 1 is squeezed and restored)."""
    if frames is None or frames.num_frames == 1:
        img = x_T[:, 0] if x_T.ndim == 5 else x_T
        out = run_spmd(params, cfg, sched, img, cond, plan, patches,
                       exchange=exchange, exchange_refresh=exchange_refresh)
        return out[:, None] if x_T.ndim == 5 else out
    from repro_torch.core import frames as frames_lib
    _require_process_group("spmd_frames")
    frames_lib.validate_frames(frames, x_T)
    F, G, W = frames.num_frames, frames.n_groups, len(patches)
    world = dist.get_world_size()
    if world != G * W:
        raise ValueError(f"frame_groups={G} over {W} patch workers needs "
                         f"{G * W} ranks, have {world}")
    policy = comm_lib.get_exchange(exchange, exchange_refresh)
    evs = list(ir.lower(plan, patches, policy, frames=frames))
    me = dist.get_rank()
    g, w = divmod(me, W)
    rows, pairs = _frame_groups(G, W)
    lo, hi = frames.bounds[g]
    mine = range(lo, hi)
    lay = _static_layout(cfg, patches)
    my_start = lay.row_starts[w]
    my_tok = patches[w] * lay.wp
    my_ratio = plan.ratios[w] or 1
    ts = sampler_lib.ddim_timesteps(sched.T, plan.m_base).tolist()
    N = cfg.n_tokens

    def scratch_pad(kv, rows_=N):
        return comm_lib.pad_to(kv, rows_ + lay.Nl_max, axis=2)

    xs = {f: x_T[:, f].clone(memory_format=torch.contiguous_format)
          for f in mine}
    pubs, prevs, reads, slabs, fresh = {}, {}, {}, {}, {}
    prev_in = None                    # frame lo-1's K/V as row g reads it
    m_prev = m_last = None            # fine steps of the last two "full"
    sent_pub = True                   # the last handoff carried pubs

    def prev_of(f, table):
        """Frame f-1's (k, v) of N rows as frame f reads them."""
        if f - 1 in table:
            return tuple(t.narrow(2, 0, N) for t in table[f - 1])
        return prev_in

    def full_forward(f, x, t):
        if f == 0 or f not in pubs:
            return dit.forward_patch(params, cfg, x, t, cond, 0,
                                     frame=None if f == 0 else f)
        own = pubs[f]
        prev = prev_of(f, pubs)
        return dit.forward_patch(params, cfg, x, t, cond, 0,
                                 buffers=(torch.cat([own[0], prev[0]], 2),
                                          torch.cat([own[1], prev[1]], 2)),
                                 frame=f)

    def pass_on(table):
        """The row-boundary handoffs of the first N rows of ``table``'s
        (k, v): row g > 0 receives frame lo-1's from column w of row g - 1,
        then row g < G - 1 sends its last frame's to column w of row g + 1
        (receive first, so the chain of rows never waits in a cycle)."""
        nonlocal prev_in
        if g > 0:
            like = table[lo][0].narrow(2, 0, N)
            prev_in = tuple(
                comm_lib.stage_handoff(
                    torch.empty(like.shape, dtype=like.dtype,
                                device=like.device), me - W, me,
                    pairs[me - W])
                for _ in range(2))
        if g < G - 1:
            for t in table[hi - 1]:
                comm_lib.stage_handoff(t.narrow(2, 0, N).contiguous(), me,
                                       me + W, pairs[me])

    for ev in evs:
        if isinstance(ev, ir.Warmup):
            t_from, t_to = ts[ev.fine_step], ts[ev.fine_step + 1]
            new = {}
            for f in mine:            # snapshot: read, then publish all
                eps, new[f] = full_forward(f, xs[f], t_from)
                xs[f] = sampler_lib.ddim_step(sched, xs[f], eps, t_from, t_to)
            pubs = new
            m_last = ev.fine_step
            pass_on(pubs)
        elif isinstance(ev, ir.ComputeInterval):
            if not slabs:             # entering the adaptive phase
                if not pubs:          # M_w == 0: bootstrap the buffers once
                    pubs = {f: full_forward(f, xs[f], ts[0])[1] for f in mine}
                    m_last = -1
                    pass_on(pubs)
                pubs = {f: tuple(scratch_pad(kv) for kv in pubs[f])
                        for f in mine}
                reads = dict(pubs)
                slabs = {f: _reslice(xs[f], my_start, lay) for f in mine}
            for f in mine:
                if f == 0:            # the image path, as run_spmd runs it
                    bk, bv, extra = reads[0][0], reads[0][1], {}
                else:
                    prev = prev_of(f, reads)
                    bk, bv = (scratch_pad(torch.cat(
                        [reads[f][i].narrow(2, 0, N), prev[i]], 2), 2 * N)
                        for i in range(2))
                    extra = dict(frame=f, ctx_tokens=2 * N)
                slabs[f], fresh[f] = _run_substeps(
                    params, cfg, sched, ts, plan.m_base, ev.length, slabs[f],
                    cond, bk, bv, my_start, my_tok, my_ratio, ev.fine_step,
                    **extra)
                del bk, bv
        elif isinstance(ev, ir.Exchange):
            fac = 0.0
            if ev.kind == "full":
                m_prev, m_last = m_last, ev.fine_step
            elif ev.kind == "predict" and m_prev is not None:
                fac = buf_lib.extrapolation_factor(m_prev, m_last,
                                                   ev.fine_step)
            for f in mine:
                if ev.kind == "full":
                    prevs[f] = pubs[f]
                    xs[f], pubs[f] = _gather_and_merge(
                        cfg, patches, lay, slabs[f], fresh[f], pubs[f],
                        rows[g])
                    reads[f] = pubs[f]
                    slabs[f] = _reslice(xs[f], my_start, lay)
                elif fac:
                    reads[f] = tuple(buf_lib.extrapolate_arrays(a, b, fac)
                                     for a, b in zip(pubs[f], prevs[f]))
                else:                 # "skip", or nothing to extrapolate
                    reads[f] = pubs[f]
            # hand on what frame hi-1's substeps read, when it changed and
            # an interval follows
            if not ev.last and (ev.kind == "full" or fac or not sent_pub):
                pass_on(reads)
            sent_pub = not fac
            fresh = {}
    # every frame's final latent, from column 0 of its row
    out = []
    for f in range(F):
        src = frames.row_of(f) * W
        x = (xs[f].contiguous() if f in xs else
             x_T.new_empty(x_T[:, f].shape))
        dist.broadcast(x, src=src)
        out.append(x)
    return torch.stack(out, dim=1)


#: subgroups by their member lists, with the default group they belong to.
#: NCCL builds a communicator for every group (seconds each time), so they
#: are made once per process group and reused by every call; destroying
#: the default group destroys them.
_GROUPS: Dict[Tuple, Tuple[object, List]] = {}


def _subgroups(members: Sequence[Sequence[int]]) -> List:
    """One process group per member list: every rank creates every group, in
    this one order (torch.distributed requires it), the first time the
    default process group asks for this layout."""
    key = tuple(tuple(m) for m in members)
    world = dist.group.WORLD
    cached = _GROUPS.get(key)
    if cached is None or cached[0] is not world:
        _GROUPS[key] = (world, [dist.new_group(list(m)) for m in key])
    return _GROUPS[key][1]


def _split_groups(n_pairs: int) -> List:
    """Split guidance's subgroups: [cond workers, uncond workers, pair 0,
    ..., pair n-1]."""
    return _subgroups([range(g * n_pairs, (g + 1) * n_pairs) for g in range(2)]
                      + [(i, n_pairs + i) for i in range(n_pairs)])


def run_spmd_guidance(params, cfg: DiTConfig, sched: NoiseSchedule, x_T,
                      cond, plan: TemporalPlan, patches: Sequence[int],
                      guidance, exchange: str = "sync",
                      exchange_refresh: int = 2):
    """Split-guidance STADI on ``2 * n_pairs`` ranks (reference
    ``repro.core.spmd.run_spmd_guidance``): rank ``g * n_pairs + i`` is
    patch worker i of branch g (0 conditional, 1 unconditional). Each branch
    runs :func:`run_spmd`'s body over its own patch-worker group with its
    own K/V; every eval's eps is combined across the pair by a float32
    ``all_reduce`` of ``coeff * eps``. Returns the final image on every
    rank."""
    if guidance is None or guidance.mode not in ("split", "interleaved"):
        raise ValueError("run_spmd_guidance needs a split/interleaved "
                         f"GuidancePlan, got {guidance!r}")
    if guidance.mode == "interleaved":
        raise ValueError("interleaved uncond reuse is not implemented on "
                         "the SPMD backend; use 'emulated'/'pipefuse' for "
                         "interleaved numerics")
    if cond is None:
        raise ValueError("guided generation needs a class condition")
    _require_process_group("spmd_guidance")
    N, world = len(patches), dist.get_world_size()
    if world != 2 * N:
        raise ValueError(f"split guidance over {N} pairs needs {2 * N} "
                         f"ranks, have {world}")
    guide, idx = divmod(dist.get_rank(), N)
    my_cond = cond if guide == 0 else dit.null_like(cond)
    coeff = guidance.scale if guide == 0 else 1.0 - guidance.scale
    policy = comm_lib.get_exchange(exchange, exchange_refresh)
    evs = list(ir.lower(plan, patches, policy, guidance=guidance))
    groups = _split_groups(N)
    pair = groups[2 + idx]

    def eps_combine(eps):
        total = coeff * eps.float()
        dist.all_reduce(total, group=pair)
        return total.to(eps.dtype)

    return _execute(params, cfg, sched, x_T, my_cond, plan, patches, evs, idx,
                    group=groups[guide], eps_combine=eps_combine)


def _seq_groups(S: int, N: int) -> Tuple[List, List]:
    """spmd_seq's subgroups: (the dev row of each seq member s, ranks
    ``s * N .. s * N + N - 1``; the seq column of each worker d, ranks
    ``d, N + d, ..., (S - 1) * N + d``)."""
    groups = _subgroups([range(s * N, (s + 1) * N) for s in range(S)]
                        + [range(d, S * N, N) for d in range(N)])
    return groups[:S], groups[S:]


def _ring_attend(cfg: DiTConfig, S: int, seq_group):
    """The buffered read of a seq member (reference: ``run_spmd_seq``'s
    ``attend_fn``): scatter the query heads over the seq group, hold this
    member's segment of the blended context (padded to ``cseg = ceil(N_buf
    / S)`` rows), and over S hops attend the held segment with kernel K4,
    merging the (out, lse) partials with an fp32 online log-sum-exp while
    the segments rotate one member down the ring; then regather the heads.
    The partial ``out`` is rounded to q's dtype before the merge, as the
    reference does. A segment with no real key has lse -1e30 and weighs 0."""
    me = dist.get_rank(seq_group)

    def attend_fn(q, full_k, full_v, key_mask):
        n_real = cfg.n_tokens if key_mask is not None else full_k.shape[1]
        q_g = comm_lib.ulysses_scatter_heads(q, seq_group)
        Hs = q_g.shape[2]
        heads = slice(me * Hs, (me + 1) * Hs)
        cseg = -(-full_k.shape[1] // S)
        # this member's K and V segment, stacked so one hop carries both
        hold = torch.stack([comm_lib.pad_to(t, cseg * S, axis=1)
                            .narrow(1, me * cseg, cseg) for t in (full_k, full_v)])
        num = den = run_m = None
        for hop in range(S):
            src = (me - hop) % S              # the segment this hop holds
            valid = min(max(n_real - src * cseg, 0), cseg)
            out_s, lse_s = kops.lse_attention(q_g, hold[0][:, :, heads],
                                              hold[1][:, :, heads], valid)
            out_s = out_s.float()
            if num is None:
                num, den, run_m = out_s, torch.ones_like(lse_s), lse_s
            else:
                m_new = torch.maximum(run_m, lse_s)
                corr = torch.exp(run_m - m_new)
                w = torch.exp(lse_s - m_new)
                num = num * corr[..., None] + out_s * w[..., None]
                den = den * corr + w
                run_m = m_new
            if hop < S - 1:
                hold = comm_lib.ring_hop(hold, seq_group)
        att_g = (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
        return comm_lib.ulysses_gather_heads(att_g, seq_group)

    return attend_fn


def run_spmd_seq(params, cfg: DiTConfig, sched: NoiseSchedule, x_T, cond,
                 plan: TemporalPlan, patches: Sequence[int], seq,
                 exchange: str = "ring", exchange_refresh: int = 2):
    """Sequence-parallel STADI on ``S * N`` ranks (reference
    ``repro.core.spmd.run_spmd_seq``): rank ``s * N + d`` is seq member s of
    patch worker d. Each seq row runs :func:`run_spmd`'s body over its dev
    subgroup; every buffered attention read goes through the seq column's
    head scatter and ring hops (:func:`_ring_attend`, kernel K4), so the
    whole context is never attended on one member. Needs ``n_heads %
    S == 0``. A plan with one shard runs :func:`run_spmd`. Returns the final
    image on every rank."""
    if seq is None or len(seq.segments) < 2:
        return run_spmd(params, cfg, sched, x_T, cond, plan, patches,
                        exchange=exchange, exchange_refresh=exchange_refresh)
    S = len(seq.segments)
    if cfg.n_heads % S:
        raise ValueError(
            f"spmd_seq needs n_heads divisible by seq_shards for the "
            f"all-to-all head scatter: {cfg.n_heads} % {S} != 0")
    _require_process_group("spmd_seq")
    N, world = len(patches), dist.get_world_size()
    if world != S * N:
        raise ValueError(f"seq_shards={S} over {N} patch workers needs "
                         f"{S * N} ranks, have {world}")
    policy = comm_lib.get_exchange(exchange, exchange_refresh)
    evs = list(ir.lower(plan, patches, policy, seq_shards=seq))
    s_idx, d_idx = divmod(dist.get_rank(), N)
    rows, cols = _seq_groups(S, N)
    return _execute(params, cfg, sched, x_T, cond, plan, patches, evs, d_idx,
                    group=rows[s_idx],
                    attend_fn=_ring_attend(cfg, S, cols[d_idx]))
