"""Sequence-parallel attention, the fifth schedule dimension (DESIGN.md §13):
Ulysses head scattering plus ring K/V segment staging, composed with the
STADI IR — the port's own copy of ``repro.core.seqpar``.

  * :func:`head_partition` — Ulysses all-to-all head scattering, sized
    speed-proportionally by the largest-remainder allocator of the depth
    dimension (:func:`repro_torch.core.hetero.stage_partition`).
  * :func:`ring_segments` — ring-attention K/V segment sizing over the token
    rows, speed-proportional for the same reason: each ring hop forwards one
    shard's segment to its neighbour, and the largest segment gates the hop.
  * :class:`SeqPlan` — the (heads, segments) pair every consumer shares: the
    IR lowers it into :class:`~repro_torch.core.events.SeqShard` events, the
    multi-rank executor (``spmd_seq``) realizes it with all-to-all head
    scatters and ring hops, and the ring-contention cost model
    (``simulate._simulate_seq``) prices it.
  * :func:`run_seqpar` — the emulated reference. The sequence dimension
    repartitions WHERE attention is computed, never WHAT: it delegates to
    :func:`repro_torch.core.patch_parallel.run_schedule` and is bitwise the
    ``emulated`` backend at ``seq_shards=1``, and shard-count invariant
    beyond it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import hetero


@dataclasses.dataclass(frozen=True)
class SeqPlan:
    """The sequence-axis allocation every consumer shares.

    heads:    attention heads per seq shard (Ulysses scatter), sum == H
    segments: ring K/V segment token-rows per shard, sum == p_total
    """
    heads: Tuple[int, ...]
    segments: Tuple[int, ...]

    def __post_init__(self):
        if len(self.heads) != len(self.segments):
            raise ValueError(f"head partition ({len(self.heads)} shards) and "
                             f"ring segments ({len(self.segments)} shards) "
                             "disagree on the shard count")
        if any(h < 1 for h in self.heads):
            raise ValueError(f"every seq shard needs >= 1 head, got "
                             f"{list(self.heads)}")
        if any(s < 1 for s in self.segments):
            raise ValueError(f"every ring segment needs >= 1 token row, got "
                             f"{list(self.segments)}")

    @property
    def n_shards(self) -> int:
        return len(self.heads)

    @property
    def hops(self) -> int:
        """Ring hops per attention (one fewer than the shard count)."""
        return self.n_shards - 1

    @property
    def head_fracs(self) -> List[float]:
        t = sum(self.heads)
        return [h / t for h in self.heads]

    @property
    def seg_fracs(self) -> List[float]:
        t = sum(self.segments)
        return [s / t for s in self.segments]

    def even_heads(self) -> bool:
        """True when the head scatter is uniform, the layout an all-to-all
        realizes without padding heads."""
        return len(set(self.heads)) == 1


def _shard_speeds(n_shards: int, speeds: Optional[Sequence[float]]):
    sp = list(speeds)[:n_shards] if speeds else [1.0] * n_shards
    if len(sp) < n_shards:
        sp = sp + [sp[-1]] * (n_shards - len(sp))
    return sp


def head_partition(n_heads: int, n_shards: int,
                   speeds: Optional[Sequence[float]] = None) -> List[int]:
    """Heads per seq shard, speed-proportional with every shard keeping at
    least one head (``speeds=None`` partitions uniformly)."""
    if n_shards < 1:
        raise ValueError(f"need at least one seq shard, got {n_shards}")
    if n_shards > n_heads:
        raise ValueError(
            f"seq_shards={n_shards} cannot scatter {n_heads} attention "
            "heads (Ulysses needs >= 1 head per shard)")
    return hetero.stage_partition(n_heads, _shard_speeds(n_shards, speeds))


def ring_segments(rows: int, n_shards: int,
                  speeds: Optional[Sequence[float]] = None) -> List[int]:
    """Ring K/V segment token-rows per shard, speed-proportional: a hop
    forwards one segment padded to max(segments)."""
    if n_shards < 1:
        raise ValueError(f"need at least one seq shard, got {n_shards}")
    if n_shards > rows:
        raise ValueError(f"seq_shards={n_shards} cannot segment {rows} "
                         "token rows (>= 1 row per ring segment)")
    return hetero.stage_partition(rows, _shard_speeds(n_shards, speeds))


def make_seq_plan(n_heads: int, rows: int, n_shards: int,
                  speeds: Optional[Sequence[float]] = None) -> SeqPlan:
    """The (head partition, ring segments) pair for ``n_shards`` shards;
    ``speeds`` are per-SHARD aggregate speeds (:func:`seq_group_speeds`),
    None = uniform shards."""
    return SeqPlan(tuple(head_partition(n_heads, n_shards, speeds)),
                   tuple(ring_segments(rows, n_shards, speeds)))


def seq_group_speeds(speeds: Sequence[float], n_shards: int
                     ) -> Tuple[List[List[float]], List[float]]:
    """The device grouping of a seq-sharded plan, shared by the planner, the
    cost model and the ``spmd_seq`` ranks.

    The speed-sorted device list is dealt COLUMN-wise into ``n // n_shards``
    patch-worker groups of ``n_shards`` devices: member j of group g is the
    (j * n_workers + g)-th fastest device, so shard row j has similar speed
    across groups. Leftover devices idle. Returns (groups, shard_speeds):
    ``groups[g]`` the member speeds of patch worker g, ``shard_speeds[j]``
    the aggregate speed of shard row j across the groups."""
    n = len(speeds)
    if n_shards < 1:
        raise ValueError(f"need at least one seq shard, got {n_shards}")
    n_workers = n // n_shards
    if n_workers < 1:
        raise ValueError(
            f"seq_shards={n_shards} needs at least {n_shards} devices, "
            f"the cluster has {n}")
    order = sorted(speeds, reverse=True)
    groups = [[order[j * n_workers + g] for j in range(n_shards)]
              for g in range(n_workers)]
    shard_speeds = [sum(order[j * n_workers + g] for g in range(n_workers))
                    for j in range(n_shards)]
    return groups, shard_speeds


# ----------------------------------------------------------------------
# ring-attention reference (one process)
# ----------------------------------------------------------------------

def ring_attention_reference(q, k, v, seq: SeqPlan, mask=None):
    """Ulysses head scatter plus ring segment accumulation in plain torch:
    shard j attends with its ``seq.heads[j]`` head slice over the K/V
    segments in ring arrival order (own segment first, then the hop-1
    neighbour's, ...) with a streaming fp32 log-sum-exp. Equals the dense
    ``layers.attend`` up to reduction order.

    q: [B, S, H, hd]; k/v: [B, T, H, hd]; mask: broadcastable [B, 1, S, T]
    (True = attend), as ``layers.attend`` takes it."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    n = seq.n_shards
    if sum(seq.heads) != H:
        raise ValueError(f"head partition {list(seq.heads)} for {H} heads")
    scale = 1.0 / (hd ** 0.5)
    head_lo = [sum(seq.heads[:j]) for j in range(n)]
    # segment bounds in key tokens: rows scale to T
    per = T // sum(seq.segments)
    seg_lo = [sum(seq.segments[:j]) * per for j in range(n)]
    seg_sz = [s * per for s in seq.segments]
    full_mask = None if mask is None else torch.broadcast_to(mask, (B, 1, S, T))

    outs = []
    for j in range(n):
        heads = slice(head_lo[j], head_lo[j] + seq.heads[j])
        qj = q[:, :, heads].float().permute(0, 2, 1, 3) * scale   # [B,Hj,S,hd]
        m = torch.full(qj.shape[:3], -torch.inf, device=q.device)
        den = torch.zeros(qj.shape[:3], device=q.device)
        num = torch.zeros(qj.shape, device=q.device)
        for hop in range(n):                 # ring arrival order from shard j
            s = (j - hop) % n
            keys = slice(seg_lo[s], seg_lo[s] + seg_sz[s])
            ks = k[:, keys, heads].float()
            vs = v[:, keys, heads].float()
            logits = torch.einsum("bhsd,bthd->bhst", qj, ks)
            if full_mask is not None:
                logits = torch.where(full_mask[..., keys], logits, -torch.inf)
            m_new = torch.maximum(m, logits.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            p = torch.exp(logits - m_safe[..., None])
            den = den * corr + p.sum(-1)
            num = num * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, vs)
            m = m_new
        outs.append((num / den.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3))
    return torch.cat(outs, dim=2).to(q.dtype)


# ----------------------------------------------------------------------
# emulated reference executor
# ----------------------------------------------------------------------

def validate_seq(seq: SeqPlan, n_heads: int, rows: int) -> None:
    """Fail fast when a SeqPlan does not fit the model geometry."""
    if sum(seq.heads) != n_heads:
        raise ValueError(f"head partition {list(seq.heads)} sums to "
                         f"{sum(seq.heads)}, model has {n_heads} heads")
    if sum(seq.segments) != rows:
        raise ValueError(f"ring segments {list(seq.segments)} sum to "
                         f"{sum(seq.segments)}, image has {rows} token rows")


def run_seqpar(params, cfg, sched, x_T, cond, plan, patches,
               seq: Optional[SeqPlan], exchange: str = "ring",
               exchange_refresh: int = 2, guidance=None):
    """Emulated sequence-parallel reference: the IR stream of
    ``run_schedule`` with the :class:`~repro_torch.core.events.SeqShard`
    events a multi-shard plan lowers to. The sequence dimension moves
    attention across heads and ring segments without changing what any head
    computes, so the trajectory is that of ``run_schedule`` bit for bit; the
    trace carries the seq provenance the ring-contention cost model prices.
    The head-scattered realization is :func:`repro_torch.core.spmd.
    run_spmd_seq`."""
    from repro_torch.core import patch_parallel as pp

    if seq is not None and seq.n_shards > 1:
        validate_seq(seq, cfg.n_heads, cfg.tokens_per_side)
    else:
        seq = None
    return pp.run_schedule(params, cfg, sched, x_T, cond, plan, patches,
                           exchange=exchange,
                           exchange_refresh=exchange_refresh,
                           guidance=guidance, seq=seq)


def max_hop_staleness(records) -> int:
    """Worst staleness age (in adaptive intervals) of the cross-worker K/V
    the ring hops carry, over a trace's records: the age resets at every
    synchronous step and "full" boundary and grows by one per degraded
    boundary, so it is bounded by ``refresh_every - 1`` under the "ring"
    policy. Intervals without ring hops contribute 0."""
    age = 0
    worst = 0
    for ev in records:
        if ev.synchronous:
            age = 0
            continue
        if ev.seq_hops:
            worst = max(worst, age)
        age = 0 if ev.exchange == "full" else age + 1
    return worst
