"""Uneven-tensor collectives (paper §V-A "All-Gather for uneven sized
tensors") on ``torch.distributed``, boundary-exchange policies and the
analytic wire-row helpers (reference: ``repro.core.comm``, DESIGN.md §10).

The paper works around NCCL's lack of an uneven all_gather in two ways, and
both are here: (1) pad every rank's tensor to the largest size, all_gather,
keep the valid prefixes (:func:`uneven_all_gather_padded`); (2) one
broadcast from each source rank, each of its own size
(:func:`uneven_all_gather_broadcast`). The reference runs them inside
``shard_map`` bodies over a mesh axis name; here every rank calls them with
the ``torch.distributed`` process group of the ranks that exchange (None:
the default group). Both run on the tensors' device: NCCL for CUDA tensors,
gloo for CPU tensors, and gloo for CUDA tensors when the ranks were started
with it by name (it stages them through host memory).

The :class:`BoundaryExchange` policy decides, per interval boundary, whether
the latent/KV exchange happens synchronously ("full"), is skipped against
stale buffers ("skip", DistriFusion-style stale-async with a corrective
refresh cadence), or is replaced by local extrapolation of the remote slabs
("predict", Reuse-then-Predict). The schedule IR (:mod:`repro_torch.core.
events`) consults the policy when lowering; executors only ever see the
resulting per-boundary kind.

Sequence-parallel attention (DESIGN.md §13) adds the "ring" policy and two
collectives over the ranks of one seq group: the Ulysses head scatter and
its regather (:func:`ulysses_scatter_heads`, :func:`ulysses_gather_heads`,
the reference's tiled ``jax.lax.all_to_all``) and the ring hop
(:func:`ring_hop`, its ``ppermute`` to the next member). Both are built on
``all_to_all_single``, which gloo and NCCL both take.

The displaced stage chain (DESIGN.md §11) adds :func:`stage_handoff`, the
point-to-point move of a micro-task's hidden state from one stage rank to
the next (the reference's ``ppermute``), and :func:`chain_broadcast`, which
hands the last stage's output to every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist

from repro_torch import spans


def pad_to(x, rows: int, axis: int = 0):
    """Zero-pad ``x`` along ``axis`` to ``rows`` (no-op if already there)."""
    pad = rows - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _group_size(group, sizes: Sequence[int]) -> int:
    n = len(sizes)
    if dist.get_world_size(group) != n:
        raise ValueError(f"{n} sizes for a group of "
                         f"{dist.get_world_size(group)} ranks")
    return n


def _exchange(x_local, sizes: Sequence[int], axis: int, me: int = 0,
              padded: bool = True):
    """The ``exchange`` span of one uneven all-gather while the recorder is
    on: ``seq`` is this process's call index since the recorder's last
    take (every rank of a group makes the same calls in the same order, so
    the ranks' spans of one collective share it), ``bytes_in`` and
    ``bytes_out`` the wire bytes this rank receives and sends; the
    ``exchange.calls`` and ``exchange.bytes_in`` counters add them up."""
    if not spans.enabled():
        return spans.OFF
    row = (x_local.numel() // max(x_local.shape[axis], 1)
           * x_local.element_size())
    if padded:        # a ring all-gather forwards as many rows as it takes
        bytes_in = bytes_out = uneven_all_gather_rows(sizes) * row
    else:             # every other source's real rows; its own to each peer
        bytes_in = (sum(sizes) - sizes[me]) * row
        bytes_out = sizes[me] * (len(sizes) - 1) * row
    seq = spans.count("exchange.calls") - 1
    spans.count("exchange.bytes_in", bytes_in)
    return spans.span("exchange", seq=seq, bytes_in=bytes_in,
                      bytes_out=bytes_out)


def uneven_all_gather_padded(x_local, sizes: Sequence[int], group=None,
                             axis: int = 0):
    """Strategy 1: pad to max -> all_gather -> concat valid prefixes.

    x_local: this rank's slab, ALREADY padded by the caller to max(sizes)
    along ``axis`` (its first sizes[my_rank] entries are real); sizes in
    group-rank order. Returns the concatenation of every rank's valid
    prefix, [sum(sizes), ...] along ``axis``, on every rank. On the wire a
    rank receives (and, in a ring, forwards) :func:`uneven_all_gather_rows`
    padded rows."""
    n = _group_size(group, sizes)
    if x_local.shape[axis] != max(sizes):
        raise ValueError(f"the local slab has {x_local.shape[axis]} rows on "
                         f"axis {axis}; it must be padded to {max(sizes)}")
    with _exchange(x_local, sizes, axis):
        x = x_local.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat([parts[i].narrow(axis, 0, sizes[i])
                          for i in range(n)], dim=axis)


def uneven_all_gather_broadcast(x_local, sizes: Sequence[int], group=None,
                                axis: int = 0):
    """Strategy 2: one broadcast per source rank, each carrying only that
    rank's sizes[src] real rows (no padding on the wire).

    Same contract as :func:`uneven_all_gather_padded`."""
    n = _group_size(group, sizes)
    if x_local.shape[axis] != max(sizes):
        raise ValueError(f"the local slab has {x_local.shape[axis]} rows on "
                         f"axis {axis}; it must be padded to {max(sizes)}")
    group = group or dist.group.WORLD
    me = dist.get_rank(group)
    with _exchange(x_local, sizes, axis, me, padded=False):
        parts = []
        for src in range(n):
            if sizes[src] == 0:
                continue
            if src == me:
                buf = x_local.narrow(axis, 0, sizes[src]).contiguous()
            else:
                shape = list(x_local.shape)
                shape[axis] = sizes[src]
                buf = x_local.new_empty(shape)
            dist.broadcast(buf, src=dist.get_global_rank(group, src),
                           group=group)
            parts.append(buf)
        return torch.cat(parts, dim=axis)


def ulysses_scatter_heads(q, group=None):
    """Ulysses head scatter over the S ranks of ``group`` (reference: the
    tiled ``jax.lax.all_to_all(q, "seq", split_axis=2, concat_axis=1)``).

    q: [B, Nl, H, hd] on every member, H divisible by S. Member j gets head
    group j (``H / S`` heads) of every member's q, the members' token blocks
    concatenated in member order: [B, S * Nl, H / S, hd]."""
    S = dist.get_world_size(group)
    B, Nl, H, hd = q.shape
    if H % S:
        raise ValueError(f"{H} heads do not scatter evenly over {S} ranks")
    send = q.reshape(B, Nl, S, H // S, hd).permute(2, 0, 1, 3, 4).contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    return got.permute(1, 0, 2, 3, 4).reshape(B, S * Nl, H // S, hd)


def ulysses_gather_heads(att, group=None):
    """The regather that undoes :func:`ulysses_scatter_heads` (reference:
    ``jax.lax.all_to_all(att, "seq", split_axis=1, concat_axis=2)``):
    att [B, S * Nl, H / S, hd], token block i for member i; member j gets
    its own token block with every member's head group, [B, Nl, H, hd]."""
    S = dist.get_world_size(group)
    B, SNl, Hs, hd = att.shape
    send = att.reshape(B, S, SNl // S, Hs, hd).transpose(0, 1).contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    return got.permute(1, 2, 0, 3, 4).reshape(B, SNl // S, S * Hs, hd)


def ring_hop(x, group=None):
    """One ring hop over the ranks of ``group`` (reference:
    ``jax.lax.ppermute(x, "seq", [(s, (s + 1) % S)])``): every member sends
    ``x`` to the next member and returns what the previous one sent. An
    ``all_to_all_single`` with one non-zero split each way: gloo and NCCL
    both take it for CUDA tensors, where gloo's point-to-point ``send`` /
    ``recv`` refuse them (torch 2.11)."""
    S = dist.get_world_size(group)
    me = dist.get_rank(group)
    flat = x.contiguous().view(-1)
    send_sizes = [0] * S
    recv_sizes = [0] * S
    send_sizes[(me + 1) % S] = flat.numel()
    recv_sizes[(me - 1) % S] = flat.numel()
    got = torch.empty_like(flat)
    dist.all_to_all_single(got, flat, recv_sizes, send_sizes, group=group)
    return got.view(x.shape)


def stage_handoff(h, src: int, dst: int, pair_group=None):
    """Point-to-point pipeline handoff (reference: ``comm.stage_handoff``, a
    ``ppermute`` from stage s to s + 1): rank ``src``'s ``h`` moves to rank
    ``dst``. Both ranks call it, ``src`` with its tensor and ``dst`` with a
    buffer of the same shape and dtype, which comes back filled; no other
    rank takes part. NCCL runs a send/recv pair. Gloo refuses send/recv on
    CUDA tensors, so there it is a broadcast inside ``pair_group``, the
    two-rank group of src and dst (made once per run by the caller)."""
    me = dist.get_rank()
    if me not in (src, dst):
        raise ValueError(f"rank {me} is neither end of the {src} -> {dst} "
                         "handoff")
    if dist.get_backend() == "nccl":
        if me == src:
            dist.send(h, dst)
        else:
            dist.recv(h, src)
    else:
        if pair_group is None:
            raise ValueError("a gloo handoff runs in the two-rank group of "
                             "its ends: pass pair_group")
        dist.broadcast(h, src=src, group=pair_group)
    return h


def chain_broadcast(x, src: int):
    """The last stage's output to every rank of the default group (the
    reference's ``psum`` of the masked output): ``src`` passes its tensor,
    every other rank a buffer of its shape and dtype."""
    dist.broadcast(x, src=src)
    return x


def ring_all_reduce_bytes(n: int, nbytes: int) -> float:
    """Analytic bytes-on-wire per rank for ring all-reduce (simulator)."""
    return 2.0 * (n - 1) / n * nbytes


def ring_hop_rows(segments: Sequence[int]) -> int:
    """Modeled wire rows per rank for ONE ring hop of sequence-parallel
    attention (DESIGN.md §13): every rank forwards one K/V segment to its
    ring neighbor per hop, padded to max(segments). A single segment (or
    none) hops nothing."""
    active = [s for s in segments if s > 0]
    if len(active) <= 1:
        return 0
    return max(active)


def uneven_all_gather_rows(sizes: Sequence[int]) -> int:
    """Modeled wire rows per rank for the padded uneven all-gather: each of
    the N participating ranks receives N-1 remote slabs padded to
    max(sizes). A single participant (or none) exchanges nothing."""
    active = [s for s in sizes if s > 0]
    if len(active) <= 1:
        return 0
    return (len(active) - 1) * max(active)


# ----------------------------------------------------------------------
# boundary-exchange policies (DESIGN.md §10)
# ----------------------------------------------------------------------

#: per-boundary verdicts a policy may emit
EXCHANGE_KINDS = ("full", "skip", "predict")


@dataclasses.dataclass(frozen=True)
class BoundaryExchange:
    """Decides the exchange kind at each 0-based interval boundary.

    ``refresh_every`` = E means one corrective FULL refresh every E
    boundaries (so E-1 of every E boundaries are degraded); E = 1 is fully
    synchronous. The final boundary of a run is always forced to "full" by
    the IR regardless of the policy (the image must assemble).
    """
    name: str
    refresh_every: int = 1
    degraded_kind: str = "full"          # what non-refresh boundaries emit

    def __post_init__(self):
        if self.refresh_every < 1:
            raise ValueError(f"refresh_every must be >= 1, got "
                             f"{self.refresh_every}")
        if self.degraded_kind not in EXCHANGE_KINDS:
            raise ValueError(f"unknown exchange kind {self.degraded_kind!r}")

    def kind(self, boundary_index: int) -> str:
        if (boundary_index + 1) % self.refresh_every == 0:
            return "full"
        return self.degraded_kind


EXCHANGES: Dict[str, Callable[[int], BoundaryExchange]] = {}


def register_exchange(name: str):
    def deco(factory):
        EXCHANGES[name] = factory
        return factory
    return deco


def get_exchange(name: str, refresh_every: int = 2) -> BoundaryExchange:
    """Look up a boundary-exchange policy by registry name.

    ``refresh_every`` parameterizes the degraded policies (ignored by
    "sync"): stale_async/predictive skip/predict on ``refresh_every - 1``
    of every ``refresh_every`` boundaries.
    """
    try:
        factory = EXCHANGES[name]
    except KeyError:
        raise KeyError(f"unknown exchange policy {name!r}; registered: "
                       f"{sorted(EXCHANGES)}") from None
    return factory(refresh_every)


@register_exchange("sync")
def _sync(refresh_every: int) -> BoundaryExchange:
    """Blocking latent all-gather + KV merge at every boundary."""
    return BoundaryExchange("sync", refresh_every=1)


@register_exchange("stale_async")
def _stale_async(refresh_every: int) -> BoundaryExchange:
    """DistriFusion-style: skip the boundary exchange on E-1 of every E
    boundaries; workers denoise against neighbor slabs up to E intervals
    stale, with a corrective full refresh every E-th boundary."""
    return BoundaryExchange("stale_async", refresh_every=refresh_every,
                            degraded_kind="skip")


@register_exchange("predictive")
def _predictive(refresh_every: int) -> BoundaryExchange:
    """Reuse-then-Predict: on non-refresh boundaries, linearly extrapolate
    the remote K/V slabs from the last two fully-exchanged versions (falls
    back to stale reuse until two refreshes have landed)."""
    return BoundaryExchange("predictive", refresh_every=refresh_every,
                            degraded_kind="predict")


@register_exchange("ring")
def _ring(refresh_every: int) -> BoundaryExchange:
    """Sequence-parallel ring staging (DESIGN.md §13): between full
    refreshes the cross-worker boundary is skipped, the stale_async verdict,
    while within each worker the ring hops of every attention keep
    forwarding per-segment K/V, so hops carry stale neighbours the way
    DistriFusion halos do. The boundary kinds stay "skip"/"full"; what the
    policy adds is keyed off the IR's SeqShard events."""
    return BoundaryExchange("ring", refresh_every=refresh_every,
                            degraded_kind="skip")
