"""Patch-parallel diffusion inference engine (DistriFusion + STADI
schedules) — the port of ``repro.core.patch_parallel``.

Single-process EMULATION with exact numerics: N logical workers each own a
row-slab of the latent; stale-KV semantics follow DESIGN.md §2 (buffers are
carried state; an async broadcast == merge at the next sync). The engine
interprets the schedule IR (:mod:`repro_torch.core.events`), the same stream
the latency model (:mod:`repro_torch.core.simulate`) replays.

Boundary exchange is a pluggable policy (:mod:`repro_torch.core.comm`):
``sync`` merges fresh K/V at every interval boundary, ``stale_async`` skips
the exchange on a cadence, ``predictive`` extrapolates the remote K/V from
the last two exchanged versions.

Classifier-free guidance (DESIGN.md §12): every denoiser eval of a guided
schedule evaluates both branches in one branch-batched forward
(:func:`repro_torch.models.diffusion.dit.forward_patch_cfg`) against
branch-stacked buffers [2, L, B, N, H, hd], and ends in kernel K3
(:func:`repro_torch.kernels.ops.cfg_epilogue`), which writes the combined
eps and the guidance delta in one pass.

Sequence-sharded schedules (DESIGN.md §13) interpret the IR's SeqShard
events for trace provenance only: the sequence axis moves attention across
heads and ring segments, never what it computes, so the emulated numerics
are those of the unsharded schedule (the head-scattered realization is
:func:`repro_torch.core.spmd.run_spmd_seq`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.diffusion import DiTConfig
from repro_torch.core import buffers as buf_lib
from repro_torch.core import comm as comm_lib
from repro_torch.core import events as ir
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.events import ExecutionTrace, IntervalEvent
from repro_torch.core.sampler import NoiseSchedule
from repro_torch.core.schedule import TemporalPlan, patch_bounds
from repro_torch.kernels import ops as kops
from repro_torch.models.diffusion import dit


@dataclasses.dataclass
class RunResult:
    image: torch.Tensor                  # [B,H,W,C] final x_0
    trace: ExecutionTrace


# ----------------------------------------------------------------------
# classifier-free guidance steps (DESIGN.md §12)
# ----------------------------------------------------------------------
#
# The split and interleaved placements run the SAME steps as fused: the
# placement moves work between devices in the cost model, never between
# math, which is why split CFG is bitwise-identical to fused under one
# schedule.

def _stack_uncond(kv_c: Tuple, published: buf_lib.Published, tok_lo: int,
                  n_tok: int) -> Tuple:
    """Branch-stack a cond-only fresh K/V with the CURRENT published uncond
    rows (a no-op merge for the uncond branch): interleaved reuse intervals
    never recompute, and so never republish, a straggler's uncond branch."""
    ku = published.k[1].narrow(2, tok_lo, n_tok)
    vu = published.v[1].narrow(2, tok_lo, n_tok)
    return torch.stack([kv_c[0], ku]), torch.stack([kv_c[1], vu])


def _guided_step(params, cfg, x, t, cond, row_start, scale, buffers=None,
                 return_kv=True):
    """One guided denoiser eval: both branches in one forward, then the CFG
    epilogue (the reference's ``_cfg_tail``): kernel K3 on CUDA tensors, its
    plain version on CPU tensors — the device decides. buffers: None
    (full-image step) or the branch-stacked published (k, v). Returns
    (eps_combined, delta, branch-stacked fresh (k, v) [2, L, B, Nl, H, hd]
    or None)."""
    eps2, kvs2 = dit.forward_patch_cfg(params, cfg, x, t, cond, row_start,
                                       buffers=buffers, return_kv=return_kv)
    return kops.cfg_epilogue(eps2[0], eps2[1], scale) + (kvs2,)


def guided_substep(params, cfg, x_loc, t_from, cond, row_start, read_pub,
                   published, guidance, fresh: bool, ucache: dict, i: int,
                   first: bool):
    """One guided patch substep for worker ``i``: the fresh-vs-straggler-
    reuse dispatch. Returns (eps, kvs) with kvs the branch-stacked publish
    payload on ``first`` substeps, None otherwise; stores the guidance delta
    of fresh evals in ``ucache`` (interleaved only)."""
    if fresh or not guidance.worker_reuses(i):
        # fused/split, interleaved refresh intervals, and non-straggler
        # workers (always fresh)
        eps, delta, kvs = _guided_step(params, cfg, x_loc, t_from, cond,
                                       row_start, guidance.scale,
                                       buffers=(read_pub.k, read_pub.v),
                                       return_kv=first)
        if guidance.mode == "interleaved":   # only reuse ever reads it
            ucache[i] = delta
        return eps, kvs
    # interleaved reuse: the straggler pair's uncond device idles the whole
    # interval and the delta cached at the last refresh interval stands in;
    # only the cond branch runs (against its own branch's buffers), and its
    # first substep publishes with stale uncond rows
    eps_c, kv_c = dit.forward_patch(params, cfg, x_loc, t_from, cond,
                                    row_start,
                                    buffers=(read_pub.k[0], read_pub.v[0]),
                                    return_kv=first)
    eps = sampler_lib.cfg_apply_delta(eps_c, ucache[i], guidance.scale)
    kvs = (_stack_uncond(kv_c, published, row_start * cfg.tokens_per_side,
                         kv_c[0].shape[2]) if first else None)
    return eps, kvs


def run_schedule(params, cfg: DiTConfig, sched: NoiseSchedule, x_T, cond,
                 plan: TemporalPlan, patches: Sequence[int],
                 interval_hook=None, exchange: str = "sync",
                 exchange_refresh: int = 2, guidance=None,
                 seq=None) -> RunResult:
    """Execute Algorithm 1 by interpreting the schedule IR event stream.

    patches: token-rows per worker (sum == cfg.tokens_per_side; 0 = excluded).
    Uniform plan (all ratios 1, equal patches) == DistriFusion patch
    parallelism; plan from Eq. 4/5 == STADI.

    interval_hook: optional ``hook(next_fine_step, record) -> None | (plan,
    patches)`` called after every adaptive interval boundary. Returning a new
    (TemporalPlan, patches) re-allocates the remaining fine steps (online
    rebalancing); their count must be divisible by the new plan's LCM.

    exchange / exchange_refresh: boundary-exchange policy name + refresh
    cadence (see :func:`repro_torch.core.comm.get_exchange`).

    guidance: optional :class:`repro_torch.core.guidance.GuidancePlan`.
    Every denoiser eval becomes a branch-batched CFG eval against
    branch-stacked buffers; "fused" and "split" are bitwise-identical,
    "interleaved" reuses the cached guidance delta on the reuse intervals
    the IR's :class:`~repro_torch.core.events.GuidanceExchange` names.

    seq: optional :class:`repro_torch.core.seqpar.SeqPlan`. Its SeqShard
    events record each interval's ring hops in the trace, which carries the
    plan for the ring-contention cost model; the numerics are unchanged.

    ``x_T`` is not modified; the engine works on its own copy.
    """
    p = cfg.patch_size
    M_base = plan.m_base
    plan0, patches0 = plan, list(patches)  # trace provenance: the initial
    # allocation; per-interval records carry what actually executed
    ts = sampler_lib.ddim_timesteps(sched.T, M_base).tolist()
    policy = comm_lib.get_exchange(exchange, exchange_refresh)
    guided = guidance is not None
    if guided:
        if cond is None:
            raise ValueError("guided generation needs a class condition")
        if interval_hook is not None:
            raise ValueError("online rebalancing is not supported with "
                             "guidance (the branch pairing is static)")
    tok_axis = 3 if guided else 2        # buffers gain a leading branch axis

    def full_step(x, t):
        """A synchronous full-image eval: (eps, fresh (k, v))."""
        if guided:
            eps, _, kvs = _guided_step(params, cfg, x, t, cond, 0,
                                       guidance.scale)
            return eps, kvs
        return dit.forward_patch(params, cfg, x, t, cond, 0)

    x = x_T.clone()
    B = x.shape[0]
    records: List[IntervalEvent] = []
    published: Optional[buf_lib.Published] = None   # last fully-exchanged K/V
    prev_published: Optional[buf_lib.Published] = None
    read_pub: Optional[buf_lib.Published] = None    # what substeps attend to
    pending = {}
    new_slabs = {}
    ucache = {}                          # interleaved: last delta per worker
    interval: Optional[ir.ComputeInterval] = None
    fresh = True                         # uncond recomputed this interval?
    seq_hops = 0                         # ring hops of the coming interval

    gen = ir.lower(plan, patches, policy, guidance, seq)
    send = None
    while True:
        try:
            ev = gen.send(send)
        except StopIteration:
            break
        send = None

        if isinstance(ev, ir.Warmup):
            # synchronous step == exact full forward on every worker
            eps, kvs = full_step(x, ts[ev.fine_step])
            x = sampler_lib.ddim_step(sched, x, eps, ts[ev.fine_step],
                                      ts[ev.fine_step + 1])
            published = buf_lib.Published(kvs[0], kvs[1], ev.fine_step)
            read_pub = published
            records.append(ir.warmup_record(ev))

        elif isinstance(ev, ir.GuidanceExchange):
            fresh = ev.fresh             # verdict for the coming interval

        elif isinstance(ev, ir.SeqShard):
            seq_hops = ev.hops           # provenance only: no numerics

        elif isinstance(ev, ir.ComputeInterval):
            if published is None:        # M_w == 0: bootstrap buffers once
                _, kvs = full_step(x, ts[0])
                published = buf_lib.Published(kvs[0], kvs[1], -1)
                read_pub = published
            interval = ev
            bounds_tok = patch_bounds(ev.patches)
            pending = {}
            new_slabs = {}
            for i in ev.workers:
                r = ev.ratios[i]
                row0, row1 = bounds_tok[i]
                x_loc = x[:, row0 * p:row1 * p]
                for s in range(ev.substeps[i]):
                    t_from = ts[ev.fine_step + s * r]
                    t_to = ts[ev.fine_step + (s + 1) * r]
                    # only the first substep publishes (Alg. 1 l.16-17 /
                    # l.23), so only it returns its fresh K/V
                    if guided:
                        eps, kvs = guided_substep(
                            params, cfg, x_loc, t_from, cond, row0, read_pub,
                            published, guidance, fresh, ucache, i,
                            first=(s == 0))
                    else:
                        eps, kvs = dit.forward_patch(
                            params, cfg, x_loc, t_from, cond, row0,
                            buffers=(read_pub.k, read_pub.v),
                            return_kv=(s == 0))
                    x_loc = sampler_lib.ddim_step(sched, x_loc, eps, t_from,
                                                  t_to)
                    if s == 0:
                        buf_lib.publish_local(pending, i, kvs[0], kvs[1],
                                              row0 * cfg.tokens_per_side)
                new_slabs[i] = x_loc

        elif isinstance(ev, ir.Exchange):
            # every worker's slab write-back is local memory (disjoint rows);
            # the policy only gates the REMOTE traffic: K/V merge + gather
            bounds_tok = patch_bounds(ev.patches)
            for i in interval.workers:
                row0, row1 = bounds_tok[i]
                x[:, row0 * p:row1 * p] = new_slabs[i]
            if ev.kind == "full":
                prev_published = published
                published = buf_lib.merge(published, pending, ev.fine_step,
                                          axis=tok_axis)
                read_pub = published
            elif ev.kind == "skip":
                read_pub = published     # stale: pending never broadcast
            elif ev.kind == "predict":
                read_pub = buf_lib.extrapolate(prev_published, published,
                                               ev.fine_step)
            rec = ir.record(interval, ev.kind, uncond_fresh=fresh,
                            seq_hops=seq_hops)
            fresh = True
            records.append(rec)
            if interval_hook is not None and ev.fine_step < M_base:
                send = interval_hook(ev.fine_step, rec)  # None or new plan

        # ir.Replan events need no numerics: the next ComputeInterval
        # already carries the new patches/ratios

    trace = ir.make_trace(records, plan0, patches0, cfg, int(B),
                          guidance=guidance, seq=seq)
    return RunResult(x, trace)


# ----------------------------------------------------------------------
# convenience wrappers
# ----------------------------------------------------------------------

def uniform_plan(n_workers: int, m_base: int, m_warmup: int) -> TemporalPlan:
    return TemporalPlan([m_base] * n_workers, [1] * n_workers,
                        [False] * n_workers, m_base, m_warmup)


def run_distrifusion(params, cfg, sched, x_T, cond, n_workers: int,
                     m_base: int, m_warmup: int) -> RunResult:
    """Patch parallelism baseline: uniform patches, uniform steps."""
    P = cfg.tokens_per_side
    base, rem = divmod(P, n_workers)
    patches = [base + (1 if i < rem else 0) for i in range(n_workers)]
    return run_schedule(params, cfg, sched, x_T, cond,
                        uniform_plan(n_workers, m_base, m_warmup), patches)


def run_origin(params, cfg, sched, x_T, cond, m_base: int) -> torch.Tensor:
    """Non-distributed exact DDIM ("Origin" in Table II)."""
    eps_fn = lambda x, t: dit.forward(params, cfg, x, t, cond)
    return sampler_lib.ddim_sample(eps_fn, sched, x_T, m_base)


def run_origin_cfg(params, cfg, sched, x_T, cond, m_base: int,
                   scale: float) -> torch.Tensor:
    """Non-distributed exact guided DDIM: the CFG "Origin" — fused-batch
    classifier-free guidance with no patching or staleness."""
    eps_fn = lambda x, t: dit.forward_cfg(params, cfg, x, t, cond, scale)
    return sampler_lib.ddim_sample(eps_fn, sched, x_T, m_base)
