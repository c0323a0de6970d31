"""Assigned input shapes, their ``meta`` stand-ins and the step functions
the dry-run traces for each shape kind (reference:
``repro.launch.shapes``).

  train_4k     seq=  4,096 batch=256  -> train_step (loss+grads+AdamW)
  prefill_32k  seq= 32,768 batch= 32  -> prefill (full forward + cache build)
  decode_32k   seq= 32,768 batch=128  -> serve_step: ONE token, KV len 32,768
  long_500k    seq=524,288 batch=  1  -> serve_step with sub-quadratic attn
                                         (SSM state / sliding window 4,096)

Every struct is a ``meta`` tensor (shape and dtype, no allocation), the
counterpart of ``jax.ShapeDtypeStruct``; parameters come from
``model.init(layers.MetaGenerator())``, the counterpart of
``jax.eval_shape(model.init, key)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.models import encdec, layers
from repro_torch.models.api import Model, build_model
from repro_torch.optim import adamw
from repro_torch.sharding import specs as sh
from repro_torch.sharding.shardwise import is_dtensor, phase_mark


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

_I32 = torch.int32


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _dryrun_cfg(arch: str):
    """bf16 everywhere, for the bf16 peak of the roofline."""
    return get_config(arch).replace(param_dtype="bfloat16", dtype="bfloat16")


def batch_structs(cfg, model: Model, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.batch, shape.seq
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        St = encdec.tgt_len_for(S)
        return {"src_embeds": _sds((B, S, cfg.d_model), dt),
                "tgt_tokens": _sds((B, St), _I32),
                "labels": _sds((B, St), _I32)}
    if cfg.family == "vlm":
        text = S - cfg.n_vision_tokens
        return {"tokens": _sds((B, text), _I32),
                "labels": _sds((B, text), _I32),
                "vision_embeds": _sds((B, cfg.n_vision_tokens, cfg.d_model), dt)}
    return {"tokens": _sds((B, S), _I32), "labels": _sds((B, S), _I32)}


def decode_window(cfg, shape: ShapeSpec) -> int:
    """Sub-quadratic carve-out: long_500k uses a sliding window on attention
    archs (cfg.long_context_window); natively-windowed archs keep their own."""
    if cfg.sliding_window:
        return cfg.sliding_window
    if shape.name == "long_500k":
        return cfg.long_context_window
    return 0


def materialised(out, cache):
    """A serving step's ``(logits, new cache)`` as a compiled step returns
    them, with no partial sum left. A leaf's partial sum over a mesh dim is
    reduced onto the dim that the leaf it replaces is split on there (the
    ``cache_specs`` placements a server holds between steps; for the
    logits, the batch dim over a batch mesh dim) where that dim still
    splits evenly, else to a replica. The models place a replaced K/V
    cache as the cache itself (``layers.placed_like``); the other leaves
    (SSM and recurrent states) keep the shards the step gives them: the
    reference's cache rule splits a stacked state's layer dim where the
    depth divides the batch axes, and the depth probes' depths would then
    move them differently. On plain tensors, ``out``."""
    from repro_torch import tree as tree_lib

    logits, new = out
    if not is_dtensor(logits):
        return out
    from torch.distributed.tensor import Replicate, Shard

    batch = sh.batch_axes(logits.device_mesh)
    by_batch = [Shard(0) if name in batch else Replicate()
                for name in logits.device_mesh.mesh_dim_names]
    return (_reduced(logits, by_batch),
            tree_lib.tree_map(lambda o, i: _reduced(o, i.placements)
                              if is_dtensor(o) and is_dtensor(i) else o,
                              new, cache))


def _reduced(x, want):
    """``x`` with each partial sum reduced to ``want``'s placement on its
    mesh dim (:func:`materialised`)."""
    from torch.distributed.tensor import Replicate

    if not any(p.is_partial() for p in x.placements):
        return x
    mesh = x.device_mesh
    pl = list(x.placements)
    for i, (p, w, n) in enumerate(zip(x.placements, want, mesh.shape)):
        if p.is_partial():
            d = w.dim if w.is_shard() else None
            split = math.prod(m for q, m in zip(pl, mesh.shape)
                              if q.is_shard() and q.dim == d)
            pl[i] = (w if d is not None and x.shape[d] % (split * n) == 0
                     else Replicate())
    return x.redistribute(mesh, pl)


def _tree_placements(specs, mesh):
    if isinstance(specs, dict):
        return {k: _tree_placements(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_tree_placements(v, mesh) for v in specs]
    return sh.placements(specs, mesh)


def build_lowerable(arch: str, shape_name: str, cfg=None,
                    shape: Optional[ShapeSpec] = None, *,
                    rules: Optional[dict] = None, cache_split: bool = True,
                    respec: Optional[Callable] = None
                    ) -> Tuple[Callable, Tuple[Any, ...], Callable]:
    """Returns (fn, args on meta, shardings(mesh) -> a tree of DTensor
    placements for args, leaf for leaf).

    cfg/shape overrides support launch/perf.py variant runs and reduced
    probes; ``rules`` (the param rule table), ``cache_split`` (False: KV
    caches batch-sharded only) and ``respec`` (a function of the tuple of
    spec trees, returning another) are the perf variants' spec overrides,
    passed in rather than written into ``specs``. The train step is the model's ``loss``, its gradients and
    ``adamw_update``; prefill and decode are ``Model.prefill`` and
    ``Model.decode_step``. A decode's cache starts mid-stream at position
    ``seq - 1``."""
    cfg = cfg or _dryrun_cfg(arch)
    model = build_model(cfg)
    shape = shape or SHAPES[shape_name]
    opt_cfg = adamw.AdamWConfig()
    params_s = model.init(layers.MetaGenerator())

    def param_sp(mesh):
        return sh.param_specs(params_s, mesh, cfg, rules=rules)

    def done(specs, mesh):
        specs = respec(specs) if respec else specs
        return tuple(_tree_placements(s, mesh) for s in specs)

    if shape.kind == "train":
        batch_s = batch_structs(cfg, model, shape)
        opt_s = {**adamw.adamw_init(params_s),
                 "count": torch.zeros((), dtype=torch.int32, device="meta")}

        def train_step(params, opt_state, batch):
            from repro_torch import tree as tree_lib
            leaves = tree_lib.leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss = model.loss(params, batch)
            phase_mark()
            # each gradient reduced to its parameter's placement, as a
            # data-parallel trainer reduces it, before the update reads it
            grads = tree_lib.unflatten(params, [
                g.redistribute(p.device_mesh, p.placements) if is_dtensor(g) else g
                for g, p in zip(torch.autograd.grad(loss, leaves), leaves)])
            phase_mark()
            with torch.no_grad():
                params, opt_state = adamw.adamw_update(
                    params, grads, opt_state, opt_cfg)
            return params, opt_state, loss.detach()

        def shardings(mesh):
            ps = param_sp(mesh)
            os_ = {"mu": ps, "nu": ps, "count": ()}
            bs = sh.batch_specs(batch_s, mesh)
            return done((ps, os_, bs), mesh)

        return train_step, (params_s, opt_s, batch_s), shardings

    if shape.kind == "prefill":
        batch_s = batch_structs(cfg, model, shape)
        window = cfg.sliding_window
        if cfg.family == "encdec":
            cache_s = model.init_cache(shape.batch, encdec.tgt_len_for(shape.seq),
                                       src_len=shape.seq, device="meta")
        else:
            prefill_len = shape.seq + (cfg.n_vision_tokens
                                       if cfg.family == "vlm" else 0)
            cache_s = model.init_cache(shape.batch, prefill_len, window=window,
                                       device="meta")

        def prefill_fn(params, batch, cache):
            with torch.no_grad():
                return materialised(
                    model.prefill(params, batch, cache, window=window), cache)

        def shardings(mesh):
            return done((param_sp(mesh),
                         sh.batch_specs(batch_s, mesh),
                         sh.cache_specs(cache_s, mesh, split=cache_split)), mesh)

        return prefill_fn, (params_s, batch_s, cache_s), shardings

    # decode kinds
    window = decode_window(cfg, shape)
    if cfg.family == "encdec":
        # cached encoder memory over the full source + windowed self-attn
        cache_s = model.init_cache(shape.batch, shape.seq, window=window,
                                   src_len=shape.seq, device="meta")
    else:
        cache_s = model.init_cache(shape.batch, shape.seq, window=window,
                                   device="meta")
    if isinstance(cache_s, dict) and "pos" in cache_s:
        cache_s["pos"] = shape.seq - 1
    token_s = _sds((shape.batch,), _I32)

    def decode_fn(params, cache, token):
        with torch.no_grad():
            return materialised(
                model.decode_step(params, cache, token, window=window), cache)

    def shardings(mesh):
        return done((param_sp(mesh),
                     sh.cache_specs(cache_s, mesh, split=cache_split),
                     sh.batch_specs(token_s, mesh)), mesh)

    return decode_fn, (params_s, cache_s, token_s), shardings
