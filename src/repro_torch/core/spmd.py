"""Multi-rank execution of a STADI schedule on ``torch.distributed`` — the
port of ``repro.core.spmd`` (``run_spmd``, ``run_spmd_guidance`` and
``run_spmd_seq``; the pipefuse and frame executors come with their slices).

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
                  my_ratio, m0, guidance_scale=None, eps_combine=None,
                  attend_fn=None):
    """R fine steps on this rank's padded slab: a rank with interval ratio r
    runs every r-th substep and skips the others (the reference computes
    and discards them). Returns the slab and the FIRST substep's fresh K/V
    (Alg. 1 publishes it).

    ``guidance_scale`` makes each eval a fused CFG eval against
    branch-stacked buffers, combined by kernel K3; ``eps_combine``
    post-processes the raw local eps (split guidance's cross-branch
    all_reduce); ``attend_fn`` replaces every buffered attention read (the
    sequence-parallel ring read)."""
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
                valid_tokens=my_tok, attend_fn=attend_fn)
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
