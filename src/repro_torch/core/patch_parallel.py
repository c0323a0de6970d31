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

Guided (classifier-free guidance) and sequence-sharded schedules come with
later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.configs.diffusion import DiTConfig
from repro_torch.core import buffers as buf_lib
from repro_torch.core import comm as comm_lib
from repro_torch.core import events as ir
from repro_torch.core import sampler as sampler_lib
from repro_torch.core.events import ExecutionTrace, IntervalEvent
from repro_torch.core.sampler import NoiseSchedule
from repro_torch.core.schedule import TemporalPlan, patch_bounds
from repro_torch.models.diffusion import dit


@dataclasses.dataclass
class RunResult:
    image: torch.Tensor                  # [B,H,W,C] final x_0
    trace: ExecutionTrace


def run_schedule(params, cfg: DiTConfig, sched: NoiseSchedule, x_T, cond,
                 plan: TemporalPlan, patches: Sequence[int],
                 interval_hook=None, exchange: str = "sync",
                 exchange_refresh: int = 2) -> RunResult:
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

    ``x_T`` is not modified; the engine works on its own copy.
    """
    p = cfg.patch_size
    M_base = plan.m_base
    plan0, patches0 = plan, list(patches)  # trace provenance: the initial
    # allocation; per-interval records carry what actually executed
    ts = sampler_lib.ddim_timesteps(sched.T, M_base).tolist()
    policy = comm_lib.get_exchange(exchange, exchange_refresh)

    x = x_T.clone()
    B = x.shape[0]
    records: List[IntervalEvent] = []
    published: Optional[buf_lib.Published] = None   # last fully-exchanged K/V
    prev_published: Optional[buf_lib.Published] = None
    read_pub: Optional[buf_lib.Published] = None    # what substeps attend to
    pending = {}
    new_slabs = {}
    interval: Optional[ir.ComputeInterval] = None

    gen = ir.lower(plan, patches, policy)
    send = None
    while True:
        try:
            ev = gen.send(send)
        except StopIteration:
            break
        send = None

        if isinstance(ev, ir.Warmup):
            # synchronous step == exact full forward on every worker
            eps, kvs = dit.forward_patch(params, cfg, x, ts[ev.fine_step],
                                         cond, 0)
            x = sampler_lib.ddim_step(sched, x, eps, ts[ev.fine_step],
                                      ts[ev.fine_step + 1])
            published = buf_lib.Published(kvs[0], kvs[1], ev.fine_step)
            read_pub = published
            records.append(ir.warmup_record(ev))

        elif isinstance(ev, ir.ComputeInterval):
            if published is None:        # M_w == 0: bootstrap buffers once
                _, kvs = dit.forward_patch(params, cfg, x, ts[0], cond, 0)
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
                    eps, kvs = dit.forward_patch(
                        params, cfg, x_loc, t_from, cond, row0,
                        buffers=(read_pub.k, read_pub.v), return_kv=(s == 0))
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
                published = buf_lib.merge(published, pending, ev.fine_step)
                read_pub = published
            elif ev.kind == "skip":
                read_pub = published     # stale: pending never broadcast
            elif ev.kind == "predict":
                read_pub = buf_lib.extrapolate(prev_published, published,
                                               ev.fine_step)
            rec = ir.record(interval, ev.kind)
            records.append(rec)
            if interval_hook is not None and ev.fine_step < M_base:
                send = interval_hook(ev.fine_step, rec)  # None or new plan

        # ir.Replan events need no numerics: the next ComputeInterval
        # already carries the new patches/ratios

    trace = ir.make_trace(records, plan0, patches0, cfg, int(B))
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
