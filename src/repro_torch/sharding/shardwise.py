"""Functions that run shard by shard when their operands are DTensors.

The kernels' wrappers (K6 and K7 in ``repro_torch.kernels.ops``) and the
xLSTM recurrences compute each batch row and each head (or channel) on its
own. Given DTensors, :func:`shardwise` keeps the batch and head shardings
of its leading operand, replicates every other mesh dim, and runs the
function on each rank's local shards through DTensor's ``local_map``: the
kernel (or, in the dry-run, the plain version over ``meta`` shards) sees
plain tensors, and no collective sits inside a recurrence's loop. Given
plain tensors it is the function itself.
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


def _replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
