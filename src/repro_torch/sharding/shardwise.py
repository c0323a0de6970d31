"""Functions that run shard by shard when their operands are DTensors.

The kernels' wrappers (K6 and K7 in ``repro_torch.kernels.ops``) and the
xLSTM recurrences compute each batch row and each head (or channel) on its
own. Given DTensors, :func:`shardwise` keeps the batch and head shardings
of its leading operand, replicates every other mesh dim, and runs the
function on each rank's local shards through DTensor's ``local_map``: the
kernel (or, in the dry-run, the plain version over ``meta`` shards) sees
plain tensors, and no collective sits inside a recurrence's loop. Given
plain tensors it is the function itself.

Three hooks speak to the dry-run's recorder (``launch.dryrun``, a
TorchDispatchMode with a ``tally``) when one traces the step, and do
nothing otherwise: :func:`phase_mark` closes a segment of the step's
memory, :class:`FoldedLoop` lets one step of a recurrence over ``meta``
shards stand for all of them, and :func:`stand_in` runs a kernel's plain
version on ``meta`` shards with only its outputs counted as memory.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

#: per operand: (its batch dim, its head/channel dim), None where it has none
Dims = Tuple[Optional[int], Optional[int]]


def is_dtensor(t) -> bool:
    return type(t) is not torch.Tensor and type(t).__name__ == "DTensor"


def placements_for(lead, lead_dims: Dims, dims: Sequence[Dims]):
    """Each operand's placements: on each mesh dim where ``lead`` is split
    on its batch dim, every operand with a batch dim is split on it;
    likewise its head dim; every other mesh dim replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = [[] for _ in dims]
    for pl in lead.placements:
        which = None
        if isinstance(pl, Shard):
            which = {lead_dims[0]: 0, lead_dims[1]: 1}.get(pl.dim)
        for o, d in zip(out, dims):
            o.append(Shard(d[which]) if which is not None and d[which] is not None
                     else Replicate())
    return out


def shardwise(fn: Callable, args: Sequence, dims: Sequence[Dims],
              out_dims: Sequence[Dims]):
    """``fn(*args)``; with DTensor operands, on each rank's shards placed by
    :func:`placements_for` from ``args[0]`` (operands redistributed first;
    None operands pass through). Returns what ``fn`` returns: one tensor
    when ``out_dims`` has one entry, else a tuple."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    lead = args[0]
    mesh = lead.device_mesh
    in_pl = placements_for(lead, dims[0], dims)
    out_pl = placements_for(lead, dims[0], out_dims)
    moved = [a if a is None else
             (a if is_dtensor(a) else _replicated(a, mesh)).redistribute(mesh, p)
             for a, p in zip(args, in_pl)]
    out = out_pl[0] if len(out_dims) == 1 else tuple(out_pl)
    return local_map(fn, out, tuple(None if a is None else p
                                     for a, p in zip(args, in_pl)),
                     device_mesh=mesh)(*moved)


def heads_shardwise(fn, q, k, v, *, kv_lead: bool = False):
    """``fn(q, k, v)`` of an attention over q [B, S, H, hd] and k, v [B,
    T, K, hd] DTensors, shard by shard over batch and heads
    (:func:`shardwise`), split as q is, or with ``kv_lead`` as k is (a
    decode step's one query row follows its cache). Where the query heads are split over a mesh dim that does not
    divide the KV heads, K and V are broadcast to the query heads first
    (GQA's ``repeat_kv``), so that each shard holds the KV heads its query
    heads read."""
    from torch.distributed.tensor import Shard

    d = (0, 2)
    if kv_lead:
        return shardwise(lambda k, q, v: fn(q, k, v), (k, q, v), (d, d, d), (d,))
    H, K = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    if K != H and any(isinstance(p, Shard) and p.dim == 2 and K % mesh.size(m)
                      for m, p in enumerate(q.placements)):
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    return shardwise(fn, (q, k, v), (d, d, d), (d,))


def strided_shards_search(mesh) -> bool:
    """Whether DTensor plans a redistribution of a strided shard on
    ``mesh`` by a graph search too slow to trace through: on 3 or more mesh
    dims (minutes an op on the 2x16x16 production mesh; on 16x16 the search
    takes milliseconds). Where it does, the dry-run keeps strided shards
    out of the step (``layers.grad_as_value``, the decode attention shard
    by shard, ``launch.dryrun._unfolded_matmuls``)."""
    return mesh.ndim >= 3


def _replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _recorders():
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return [m for m in _get_current_dispatch_mode_stack() if hasattr(m, "tally")]


def phase_mark() -> None:
    """Close a segment of the step (the forward, the backward, each leaf's
    update, the encoder): the dry-run extrapolates each segment's peak of
    live bytes over its depth probes on its own."""
    for m in _recorders():
        m.tally.mark()


class FoldedLoop:
    """A recurrence's loop over ``n`` steps. On plain tensors, the loop
    itself: ``steps`` is ``range(n)``, ``stack`` is ``torch.stack``, and
    ``enter``, ``carry`` and ``leave`` pass their tensors through. On
    ``meta`` tensors (the dry-run, where nothing runs; unless ``FOLD`` is
    off) two steps stand for all: the first, which starts from the
    initial state, is not counted; a recorder counts the second, a step in
    the middle of the loop, ``n`` times, and ``stack`` repeats its output
    ``n`` times. Under autograd the backward is counted alike: ``leave``
    marks the loop's outputs, ``carry`` the state between the two steps
    and ``enter`` the inputs, and autograd runs the backward between the
    marks in reverse order of creation. Of the live bytes, what the first
    step allocated and is still alive when the loop ends outlived a step
    (an output kept, a tensor saved for the backward), as every step's
    does: the recorder counts it ``n - 1`` times from the loop's end until
    it is freed, and the second step's peak as if it were the last.

        loop = FoldedLoop(S, x)
        x, h = loop.enter(x, h)
        with loop:
            for t in loop.steps:
                h = step(h, x[:, t])
                ys.append(h)
                h, = loop.carry(h)
        ys = loop.stack(ys, 1)
        h, = loop.leave(h)
    """

    #: whether loops over ``meta`` tensors fold (off: every step runs)
    FOLD = True

    def __init__(self, n: int, like):
        self.n = n
        self.folded = self.FOLD and like.is_meta and n > 1
        self.steps = range(2) if self.folded else range(n)
        self.recs = _recorders() if self.folded else []
        self.marked = set()       # the marks the backward has passed

    def _scale(self, k: int, saved) -> None:
        for m, r in zip(self.recs, saved):
            m.repeat = r * k

    def __enter__(self):
        self.saved = [m.repeat for m in self.recs]
        self.first = [m.tally.allocations for m in self.recs]
        self._scale(0, self.saved)
        return self

    def __exit__(self, *exc):
        self._scale(1, self.saved)
        if "carried" in self.marked:
            for m, a, b in zip(self.recs, self.first, self.second):
                m.tally.repeat_storages(a, b, self.n - 2)

    def carry(self, *ts):
        """The state after a step; after the first, the step counted ``n``
        times begins."""
        if not self.folded or "carried" in self.marked:
            return ts
        self.marked.add("carried")
        self.second = [m.tally.window() for m in self.recs]
        self._scale(self.n, self.saved)
        return tuple(self._mark(t, "mid") for t in ts)

    def stack(self, ys, dim: int):
        """The steps' outputs stacked on ``dim``; call it right after the
        loop (its output is marked first, so that the stack's backward is
        counted once)."""
        if not self.folded:
            return torch.stack(ys, dim=dim)
        y = self._mark(ys[-1], "out").unsqueeze(dim)
        return y.expand(*y.shape[:dim], self.n, *y.shape[dim + 1:]).contiguous()

    def enter(self, *ts):
        return tuple(self._mark(t, "in") for t in ts)

    def leave(self, *ts):
        return tuple(self._mark(t, "out") for t in ts)

    def _mark(self, t, side):
        if (not self.recs or t is None or not torch.is_grad_enabled()
                or not t.requires_grad):
            return t
        return _LoopMark.apply(t, self, side)

    def backward_mark(self, side):
        """The backward passes a mark: at the first output it enters the
        counted step (``n`` times), at the carried state the uncounted one,
        at an input it leaves the loop."""
        if side in self.marked:
            return
        self.marked.add(side)
        if side == "out":
            self.bsaved = [m.repeat for m in self.recs]
        self._scale({"out": self.n, "mid": 0, "in": 1}[side], self.bsaved)


class _LoopMark(torch.autograd.Function):
    """The identity; its backward tells the :class:`FoldedLoop` where the
    backward stands."""

    @staticmethod
    def forward(ctx, t, loop, side):
        ctx.loop, ctx.side = loop, side
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.loop.backward_mark(ctx.side)
        return g, None, None


def stand_in(fn: Callable, *args):
    """``fn(*args)``, a kernel's plain version standing in for the kernel on
    ``meta`` shards: a recorder counts its FLOPs and bytes, but of its
    storages only those it returns (the kernel's outputs), as the kernel
    allocates no others."""
    recs = _recorders()
    for m in recs:
        m.untracked += 1
    try:
        out = fn(*args)
    finally:
        for m in recs:
            m.untracked -= 1
    for m in recs:
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                m.tally.allocate(t)
    return out
