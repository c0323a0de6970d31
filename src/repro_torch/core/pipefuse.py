"""Displaced patch-pipeline parallelism (PipeFusion-style) composed with the
STADI schedule IR — the port of ``repro.core.pipefuse`` (DESIGN.md §11).

STADI parallelizes across steps and patches, but every device still runs the
full DiT depth. This module adds depth as a third dimension: the block stack
is split into contiguous *stages* sized to device speed
(:func:`repro_torch.core.hetero.stage_partition`), and patch micro-batches
stream through the stage chain with **displaced** (at most one substep
stale) remote activations.

Single-process emulation with exact numerics, like ``patch_parallel``:

* A micro-patch's hidden state passes through all stages within its substep
  exactly; only the attention context is displaced.
* Each stage holds a persistent K/V *context* for its blocks. Micro-tasks
  write their own rows as they pass, so when patch ``i`` reaches a stage the
  patches ahead of it in the pipe are fresh (this substep) and the ones
  behind one substep stale. Every block reads its context through kernel K1
  (:func:`repro_torch.kernels.ops.stale_kv_attention`, static
  ``tok_start``), exactly as a block reads the published buffers.
* The pipe (re)fills whenever the IR emits a
  :class:`~repro_torch.core.events.StageShift`: entering the adaptive phase
  and after every draining ("full") exchange. The contexts are copies of the
  published buffers, written in place from then on.
* With one stage the context machinery is off and the stream is interpreted
  with the same steps as ``patch_parallel.run_schedule``: the image is
  bitwise the ``emulated`` backend's.

Guided micro-tasks run both CFG branches in one forward, the branches folded
into the batch of the micro-task and of the stage contexts ([L, 2B, N, H,
hd], rows [0, B) conditional), and end in ONE launch of kernel K3 with the
delta (:func:`repro_torch.kernels.ops.cfg_epilogue`), where the reference
runs ``cfg_combine`` and ``cfg_delta``.

The multi-rank stage chain is :func:`repro_torch.core.spmd.run_spmd_pipefuse`;
the modeled wall clock (fill bubbles, bottleneck stage, handoffs) is
:func:`repro_torch.core.simulate.simulate_trace` on a staged trace.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.diffusion import DiTConfig
from repro_torch.core import buffers as buf_lib
from repro_torch.core import comm as comm_lib
from repro_torch.core import events as ir
from repro_torch.core import patch_parallel as pp
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.sampler import NoiseSchedule
from repro_torch.core.schedule import TemporalPlan, patch_bounds
from repro_torch.kernels import ops as kops
from repro_torch.models.diffusion import dit


def stage_bounds(stages: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Cumulative [lo, hi) block ranges of a stage partition."""
    out, lo = [], 0
    for n in stages:
        out.append((lo, lo + n))
        lo += n
    return tuple(out)


def stage_blocks(params, lo: int, hi: int):
    """The block parameters of one stage: views of the stacked leaves."""
    return {name: leaf[lo:hi] for name, leaf in params["blocks"].items()}


def refuse_prompt(cond, where: str) -> None:
    """Raise for prompt-token conds on the displaced chain (two or more
    stages). The reference's chain calls ``block_stack`` without its
    ``prompt_ctx``, so a prompt there silently loses every block's
    cross-attention and keeps only the pooled conditioning vector; the
    port neither copies that loss nor adds a chain cross-attention the
    reference lacks (ROADMAP.md queue 3)."""
    if getattr(cond, "ndim", 0) >= 2:
        raise ValueError(
            f"{where} takes class conds only: the displaced stage chain has "
            "no prompt cross-attention (the reference's chain drops it "
            "silently); run prompts on one stage or another backend")


def displaced_step(params, cfg: DiTConfig, x_loc, t, cond, row_start: int,
                   ctx_k, ctx_v, bounds):
    """One micro-task: a patch slab traverses every stage of the chain.

    The hidden state hands off stage to stage exactly; each stage attends
    over its slice of the displaced context (its own rows read fresh, as in
    ``forward_patch``) and then writes its fresh rows into the context, so
    later micro-tasks of this substep see them. ``ctx_k``/``ctx_v`` [L, B,
    N, H, hd] are written IN PLACE: the caller owns them. ``t`` is a number
    or one timestep a batch row (the serving engine's lanes). Returns (eps,
    fresh_k, fresh_v [L, B, Nl, H, hd], ctx_k, ctx_v)."""
    rows_tok = x_loc.shape[1] // cfg.patch_size
    h, c = dit.embed_patch(params, cfg, x_loc, t, cond, row_start)
    tok_start = row_start * cfg.tokens_per_side
    rows = slice(tok_start, tok_start + h.shape[1])
    ks, vs = [], []
    for lo, hi in bounds:
        h, (k, v) = dit.block_stack(stage_blocks(params, lo, hi), cfg, h, c,
                                    tok_start,
                                    buffers=(ctx_k[lo:hi], ctx_v[lo:hi]))
        ctx_k[lo:hi, :, rows] = k
        ctx_v[lo:hi, :, rows] = v
        ks.append(k)
        vs.append(v)
    eps = dit.final_head(params, cfg, h, c, rows_tok)
    return eps, torch.cat(ks), torch.cat(vs), ctx_k, ctx_v


def fold_branches(kv2):
    """Branch-stacked [2, L, B, ...] -> the guided contexts' folded layout
    [L, 2B, ...] (branch 0 in rows [0, B)): a new tensor."""
    return kv2.movedim(0, 1).flatten(1, 2).clone()


def unfold_branches(kv, B: int):
    """The folded [L, 2B, ...] -> branch-stacked [2, L, B, ...]."""
    return kv.unflatten(1, (2, B)).movedim(1, 0)


def guided_displaced_step(params, cfg: DiTConfig, x_loc, t, cond,
                          row_start: int, ctx_k2, ctx_v2, bounds, scale):
    """Guided micro-task (DESIGN.md §12): both branches of
    :func:`displaced_step` in one forward over the folded contexts [L, 2B,
    N, H, hd], then kernel K3 once for the combined eps and the fp32 delta.
    Returns (eps, delta, fresh k2, v2 [L, 2B, Nl, H, hd], ctx_k2,
    ctx_v2)."""
    B = x_loc.shape[0]
    conds = dit.guidance_conds(cond).to(x_loc.device).reshape(2, -1)
    conds = conds.expand(2, B).reshape(2 * B)
    if isinstance(t, torch.Tensor) and t.dim():
        t = torch.cat([t.reshape(-1).expand(B)] * 2)
    eps2, k2, v2, ctx_k2, ctx_v2 = displaced_step(
        params, cfg, torch.cat([x_loc, x_loc]), t, conds, row_start, ctx_k2,
        ctx_v2, bounds)
    eps2 = eps2.unflatten(0, (2, B))
    eps, delta = kops.cfg_epilogue(eps2[0], eps2[1], scale)
    return eps, delta, k2, v2, ctx_k2, ctx_v2


def run_pipefuse(params, cfg: DiTConfig, sched: NoiseSchedule, x_T, cond,
                 plan: TemporalPlan, patches: Sequence[int],
                 stages: Sequence[int], exchange: str = "sync",
                 exchange_refresh: int = 2, interval_hook=None,
                 guidance=None) -> pp.RunResult:
    """Execute a STADI schedule with the DiT depth pipelined over ``stages``
    (reference ``repro.core.pipefuse.run_pipefuse``).

    patches: token rows per micro-batch slab (sum == cfg.tokens_per_side);
    with one stage this is ``run_schedule`` (bitwise). Micro-tasks run
    substep-major, ascending slab index — the pipe order the displaced
    context emulates.

    guidance: micro-tasks become both-branch CFG evals over the folded
    stage contexts; interleaved intervals reuse the cached delta per the
    IR's GuidanceExchange verdicts, running only the cond branch through
    the chain.
    """
    stages = list(stages)
    if sum(stages) != cfg.n_layers:
        raise ValueError(f"stages {stages} must cover all {cfg.n_layers} "
                         "blocks")
    if interval_hook is not None:
        raise ValueError("online rebalancing is not supported by the "
                         "pipefuse backend (stage splits are static)")
    guided = guidance is not None
    if guided and cond is None:
        raise ValueError("guided generation needs a class condition")
    tok_axis = 3 if guided else 2
    S = len(stages)
    if S > 1:
        refuse_prompt(cond, "the pipefuse backend")
    bounds = stage_bounds(stages)
    p = cfg.patch_size
    plan0, patches0 = plan, list(patches)
    ts = sampler_lib.ddim_timesteps(sched.T, plan.m_base).tolist()
    policy = comm_lib.get_exchange(exchange, exchange_refresh)

    x = x_T.clone()
    B = x.shape[0]
    records: List[ir.IntervalEvent] = []

    published: Optional[buf_lib.Published] = None
    prev_published: Optional[buf_lib.Published] = None
    read_pub: Optional[buf_lib.Published] = None   # S == 1 read source
    ctx_k = ctx_v = None                           # S > 1 displaced context
    pending = {}
    slabs = {}
    ucache = {}                          # interleaved: last delta per worker
    interval: Optional[ir.ComputeInterval] = None
    fill_pending = False
    fresh = True

    def full_step(t):
        if guided:
            eps, _, kvs = pp._guided_step(params, cfg, x, t, cond, 0,
                                          guidance.scale)
            return eps, kvs
        return dit.forward_patch(params, cfg, x, t, cond, 0)

    def bootstrap():
        nonlocal published, read_pub
        if published is None:                      # M_w == 0: one full fwd
            _, kvs = full_step(ts[0])
            published = buf_lib.Published(kvs[0], kvs[1], -1)
            read_pub = published

    for ev in ir.lower(plan, patches, policy,
                       stages=stages if S > 1 else None, guidance=guidance):
        if isinstance(ev, ir.Warmup):
            # synchronous step: the chain's handoffs are exact, so warmup is
            # the same full-image forward as the non-pipelined engine's
            eps, kvs = full_step(ts[ev.fine_step])
            x = sampler_lib.ddim_step(sched, x, eps, ts[ev.fine_step],
                                      ts[ev.fine_step + 1])
            published = buf_lib.Published(kvs[0], kvs[1], ev.fine_step)
            read_pub = published
            records.append(ir.warmup_record(ev))

        elif isinstance(ev, ir.StageShift):
            # pipeline (re)fill: the stage contexts restart as copies of the
            # published K/V
            bootstrap()
            if guided:
                ctx_k, ctx_v = (fold_branches(published.k),
                                fold_branches(published.v))
            else:
                ctx_k, ctx_v = published.k.clone(), published.v.clone()
            fill_pending = True

        elif isinstance(ev, ir.GuidanceExchange):
            fresh = ev.fresh

        elif isinstance(ev, ir.ComputeInterval):
            bootstrap()
            interval = ev
            bounds_tok = patch_bounds(ev.patches)
            pending = {}
            slabs = {i: x[:, bounds_tok[i][0] * p:bounds_tok[i][1] * p]
                     for i in ev.workers}
            for f in range(ev.length):             # substep-major micro order
                for i in ev.workers:
                    r = ev.ratios[i]
                    if f % r:
                        continue
                    first = f == 0
                    t_from = ts[ev.fine_step + f]
                    t_to = ts[ev.fine_step + f + r]
                    row0 = bounds_tok[i][0]
                    tok_lo = row0 * cfg.tokens_per_side
                    kvs = None
                    if S == 1 and not guided:      # exact emulated path
                        eps, kvs = dit.forward_patch(
                            params, cfg, slabs[i], t_from, cond, row0,
                            buffers=(read_pub.k, read_pub.v),
                            return_kv=first)
                    elif S == 1:                   # the shared CFG substep
                        eps, kvs = pp.guided_substep(
                            params, cfg, slabs[i], t_from, cond, row0,
                            read_pub, published, guidance, fresh, ucache, i,
                            first=first)
                    elif not guided:
                        eps, k_loc, v_loc, ctx_k, ctx_v = displaced_step(
                            params, cfg, slabs[i], t_from, cond, row0, ctx_k,
                            ctx_v, bounds)
                        kvs = (k_loc, v_loc)
                    elif fresh or not guidance.worker_reuses(i):
                        (eps, delta, k2, v2, ctx_k,
                         ctx_v) = guided_displaced_step(
                            params, cfg, slabs[i], t_from, cond, row0, ctx_k,
                            ctx_v, bounds, guidance.scale)
                        if guidance.mode == "interleaved":
                            ucache[i] = delta
                        kvs = (unfold_branches(k2, B), unfold_branches(v2, B))
                    else:                          # staged interleaved reuse
                        # the cond branch alone, on the cond rows of the
                        # folded contexts (views, written in place)
                        eps_c, k_c, v_c, _, _ = displaced_step(
                            params, cfg, slabs[i], t_from, cond, row0,
                            ctx_k[:, :B], ctx_v[:, :B], bounds)
                        eps = sampler_lib.cfg_apply_delta(eps_c, ucache[i],
                                                          guidance.scale)
                        if first:
                            kvs = pp._stack_uncond((k_c, v_c), published,
                                                   tok_lo, k_c.shape[2])
                    slabs[i] = sampler_lib.ddim_step(sched, slabs[i], eps,
                                                     t_from, t_to)
                    if first:    # Alg.1: publish the interval-start K/V
                        buf_lib.publish_local(pending, i, kvs[0], kvs[1],
                                              tok_lo)

        elif isinstance(ev, ir.Exchange):
            bounds_tok = patch_bounds(ev.patches)
            for i in interval.workers:
                x[:, bounds_tok[i][0] * p:bounds_tok[i][1] * p] = slabs[i]
            if ev.kind == "full":
                prev_published = published
                published = buf_lib.merge(published, pending, ev.fine_step,
                                          axis=tok_axis)
                read_pub = published
            elif ev.kind == "skip":
                read_pub = published
            elif ev.kind == "predict":
                read_pub = buf_lib.extrapolate(prev_published, published,
                                               ev.fine_step)
            # S > 1: the context persists across skip/predict boundaries
            # (the pipe stays full); the next StageShift resets it
            records.append(ir.record(interval, ev.kind, fill=fill_pending,
                                     uncond_fresh=fresh))
            fill_pending = False
            fresh = True

    trace = ir.make_trace(records, plan0, patches0, cfg, int(B),
                          stages=stages, guidance=guidance)
    return pp.RunResult(x, trace)
