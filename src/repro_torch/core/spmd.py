"""Multi-rank execution of a STADI schedule on ``torch.distributed`` — the
port of ``repro.core.spmd`` (``run_spmd`` and ``run_spmd_guidance``; the
pipefuse, sequence and frame executors come with their slices).

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
from repro_torch.core.sampler import NoiseSchedule
from repro_torch.core.schedule import TemporalPlan
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
                  my_ratio, m0, guidance_scale=None, eps_combine=None):
    """R fine steps on this rank's padded slab: a rank with interval ratio r
    runs every r-th substep and skips the others (the reference computes
    and discards them). Returns the slab and the FIRST substep's fresh K/V
    (Alg. 1 publishes it).

    ``guidance_scale`` makes each eval a fused CFG eval against
    branch-stacked buffers, combined by kernel K3; ``eps_combine``
    post-processes the raw local eps (split guidance's cross-branch
    all_reduce)."""
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
                valid_tokens=my_tok)
        if eps_combine is not None:
            eps = eps_combine(eps)
        my_slab = sampler_lib.ddim_step(sched, my_slab, eps, t_from, t_to)
        if s == 0:
            fresh = kvs
    return my_slab, fresh


def _gather_and_merge(cfg: DiTConfig, patches, lay: Layout, my_slab, fresh,
                      pub, group=None, tok_axis: int = 2):
    """Interval boundary ("full"): padded uneven all-gathers rebuild the
    full latent and every rank's fresh K/V valid prefix. The prefixes tile
    the image's ``n_tokens`` rows in rank order, so the merged buffers are
    the gathered K/V followed by the old scratch tail — new tensors; the
    old ones stay as they were (prediction keeps them)."""
    x_full = comm_lib.uneven_all_gather_padded(
        my_slab, [n * lay.p for n in patches], group, axis=1)
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
             group=None, guidance_scale=None, eps_combine=None):
    """The body every rank runs: interpret the IR events for patch worker
    ``idx`` of ``group``. ``guidance_scale`` = fused CFG (branch-stacked
    buffers); ``eps_combine`` = split CFG's cross-branch combine."""
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
                eps_combine=eps_combine)
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


#: split guidance's subgroups by worker-pair count, with the default group
#: they belong to. NCCL builds a communicator for every group (seconds each
#: time), so they are made once per process group and reused by every call;
#: destroying the default group destroys them.
_SPLIT_GROUPS: Dict[int, Tuple[object, List]] = {}


def _split_groups(n_pairs: int) -> List:
    """[cond workers, uncond workers, pair 0, ..., pair n-1]: every rank
    creates every group, in this one order (torch.distributed requires it),
    the first time a process group runs split guidance over n_pairs."""
    world = dist.group.WORLD
    cached = _SPLIT_GROUPS.get(n_pairs)
    if cached is None or cached[0] is not world:
        groups = ([dist.new_group(list(range(g * n_pairs, (g + 1) * n_pairs)))
                   for g in range(2)]
                  + [dist.new_group([i, n_pairs + i]) for i in range(n_pairs)])
        _SPLIT_GROUPS[n_pairs] = (world, groups)
    return _SPLIT_GROUPS[n_pairs][1]


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
