"""Logical-axis sharding rules -> per-dim specs and DTensor placements
(reference: ``repro.sharding.specs``).

Production mesh axes (``launch/mesh.py``): ``(data=16, model=16)``
single-pod, ``(pod=2, data=16, model=16)`` multi-pod. Logical mapping:

  batch                  -> ('pod','data') when divisible, else replicated
  heads / d_ff / experts / vocab-partition dims -> 'model'  (tensor/expert par.)
  d_model on weight matrices                    -> 'data'   (FSDP-style)
  layer-stack dim / norms / biases / small dims -> replicated
  KV-cache: kv-head dim over 'model' if divisible, else sequence dim

Rules key off parameter *path names* (the dict keys of the port's trees,
list indices skipped, as the reference's pytree paths) and ndim; the rules,
the GQA/MQA head rule and the divisibility guard are the reference's, key
for key.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name or
a tuple of axis names, the framework-free counterpart of JAX's
``PartitionSpec``. Every function takes a ``DeviceMesh`` or a plain
``{axis: size}`` mapping (the counterpart of the reference tests'
``AbstractMesh``), so the rules run without a process group.
:func:`placements`, :func:`local_shape` and :func:`distribute` replace the
reference's ``named`` / ``tree_named``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping, in mesh order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _div(n: int, mesh, axis) -> bool:
    """Is dim n evenly divisible by the (possibly tuple) mesh axis?"""
    sz = 1
    for a in _axes(axis):
        sz *= _axis_size(mesh, a)
    return sz <= n and n % sz == 0


def _guard(spec: Sequence, shape, mesh) -> Spec:
    """Drop axis assignments that don't divide the dim."""
    return tuple(ax if _div(dim, mesh, ax) else None
                 for dim, ax in zip(shape, spec))


# per-leaf-name rules: rightmost dims (left-padded with None for stacking)
_RULES = {
    # embeddings / unembedding
    "embed": ("model", "data"),
    "head": ("data", "model"),
    "cond_embed": (None, "data"),
    "meta": (None, "data"),
    # attention
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "qkv": ("data", "model"),
    # dense mlp
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    "w1": ("data", "model"),
    "w2": ("model", "data"),
    # moe
    "router": ("data", None),
    # xlstm / mamba
    "w_in": ("data", "model"),
    "w_x": ("data", "model"),
    "r_h": ("model", None, None),
    "conv": (None, "model"),
    "w_bc": ("model", None),
    "w_dt1": ("model", None),
    "w_dt2": (None, "model"),
    "w_if": ("model", None),
    # dit
    "patch_embed": (None, "data"),
    "mod_w": ("data", "model"),
    "t_w1": (None, "data"),
    "t_w2": ("data", None),
    "final_proj": ("data", None),
}

# moe expert stacks: [L, E, D, F]-style; expert dim -> 'model'
_EXPERT_RULES = {
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}


def _leaf_spec(names: List[str], shape, mesh, cfg=None, rules=None) -> Spec:
    name = names[-1] if names else ""
    in_experts = "experts" in names
    table = (_EXPERT_RULES if (in_experts and name in _EXPERT_RULES)
             else (_RULES if rules is None else rules))
    rule = table.get(name)
    if rule is None or len(shape) < len(rule):
        return (None,) * len(shape)                   # norms, biases, scalars
    spec = (None,) * (len(shape) - len(rule)) + tuple(rule)
    # GQA/MQA: a projection's (heads*hd) dim whose head count does not
    # divide 'model' is replicated over 'model' (head_dim never splits), as
    # in the reference. Applies to q (n_heads) and k/v (n_kv_heads).
    if cfg is not None and not in_experts and name in ("wq", "wk", "wv", "wo"):
        ms = _axis_size(mesh, "model")
        heads = cfg.n_heads if name in ("wq", "wo") else cfg.n_kv_heads
        if heads % ms:
            if name == "wo":               # input dim is heads*hd
                spec = spec[:-2] + (None, spec[-1])
            else:                          # output dim is heads*hd
                spec = spec[:-1] + (None,)
    return _guard(spec, shape, mesh)


def _shape(leaf) -> Optional[Tuple[int, ...]]:
    """A tensor leaf's shape; None for a leaf that is no tensor (a cache's
    ``pos``, a Python int)."""
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else None


def _map_with_names(fn, tree, names=()):
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_names(fn, v, names) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(list(names), tree)


def _map(fn, tree):
    return _map_with_names(lambda _, leaf: fn(leaf), tree)


def param_specs(params: Any, mesh, cfg=None, rules: Optional[dict] = None):
    """Tree of specs matching ``params`` (``meta`` tensors work).

    cfg (optional ArchConfig) enables the GQA rule; ``rules`` replaces the
    name table (a perf variant's overrides; the expert table stays)."""
    def spec(names, leaf):
        shape = _shape(leaf)
        return () if shape is None else _leaf_spec(names, shape, mesh, cfg, rules)
    return _map_with_names(spec, params)


# ----------------------------------------------------------------------
# activations
# ----------------------------------------------------------------------

def batch_axes(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else "data"


def batch_specs(batch: Any, mesh, *, seq_axis: Optional[str] = None):
    """Shard the leading batch dim over ('pod','data') when divisible.
    ``seq_axis='model'`` additionally shards dim 1 (sequence parallelism for
    long prefill)."""
    ba = batch_axes(mesh)

    def spec(leaf):
        shape = _shape(leaf)
        if not shape:
            return ()
        dims = [ba if _div(shape[0], mesh, ba) else None]
        if len(shape) > 1:
            dims.append(seq_axis if (seq_axis and _div(shape[1], mesh, seq_axis))
                        else None)
        dims += [None] * (len(shape) - len(dims))
        return tuple(dims)

    return _map(spec, batch)


def cache_specs(cache: Any, mesh, *, split: bool = True):
    """KV caches [L,B,T,K,hd]: batch->('pod','data'); kv-heads->'model' when
    divisible else sequence->'model'. SSM states [.., B, ...]: batch, then
    the widest remaining dim over 'model'. ``split=False`` is the perf
    variant ``cache_nosplit``: KV caches batch-sharded only, states
    replicated."""
    ba = batch_axes(mesh)

    def spec(leaf):
        shape = _shape(leaf)
        if not shape:
            return ()
        if len(shape) == 5:                         # [L,B,T,K,hd]
            L, B, T, K, hd = shape
            b_ax = ba if _div(B, mesh, ba) else None
            if split and _div(K, mesh, "model"):
                return (None, b_ax, None, "model", None)
            if split and _div(T, mesh, "model"):
                return (None, b_ax, "model", None, None)
            return (None, b_ax, None, None, None)
        if not split:
            return (None,) * len(shape)
        # ssm/conv states: [L,B,...] or [B,...]; find a batch-like dim
        dims = [None] * len(shape)
        for i, d in enumerate(shape[:2]):
            if _div(d, mesh, ba) and d > 1:
                dims[i] = ba
                break
        # shard the widest remaining dim over model if divisible
        rest = [(d, i) for i, d in enumerate(shape) if dims[i] is None]
        if rest:
            d, i = max(rest)
            if _div(d, mesh, "model") and d >= _axis_size(mesh, "model"):
                dims[i] = "model"
        return tuple(dims)

    return _map(spec, cache)


# ----------------------------------------------------------------------
# placements, local shards
# ----------------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """The DTensor placement of each mesh dim: ``Shard(d)`` where tensor dim
    d's entry names the axis, else ``Replicate()``. A dim over ``("pod",
    "data")`` is sharded on both mesh dims, pod the major one (JAX's
    order), which DTensor reads in mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in mesh order "
                             f"{names}: DTensor shards a dim major to minor "
                             "in mesh-dim order")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of each device's shard (the guard keeps the split even)."""
    sizes = axis_sizes(mesh)
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        k = 1
        for a in _axes(entry):
            k *= sizes.get(a, 1)
        if n % k:
            raise ValueError(f"dim {n} does not split evenly over {entry}")
        out.append(n // k)
    return tuple(out)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute(tree: Any, specs: Any, mesh):
    """Each ``meta`` tensor leaf as a DTensor on ``mesh`` (a ``DeviceMesh``),
    placed by its spec or by its list of placements: ``DTensor.from_local``
    of an empty local shard of its dtype, so nothing is allocated or sent
    (the dry-run's arguments). Leaves that are no tensors pass through."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    def go(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if not leaf.is_meta:
            raise ValueError(f"distribute takes meta leaves, got one on {leaf.device}")
        pl = spec if isinstance(spec, list) else placements(spec, mesh)
        shape, _ = compute_local_shape_and_global_offset(leaf.shape, mesh, pl)
        local = torch.empty(shape, dtype=leaf.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=leaf.shape,
                                  stride=_contiguous_stride(leaf.shape))

    return _zip_map(go, tree, specs)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_zip_map(fn, t, s) for t, s in zip(tree, specs)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, specs)
