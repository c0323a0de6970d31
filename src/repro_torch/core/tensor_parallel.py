"""Tensor-parallel DiT baseline (paper §V-A Baselines) on
``torch.distributed`` — the port of ``repro.core.tensor_parallel``.

"Tensor parallelism achieves distributed diffusion inference by performing
synchronous all-reduce at each layer of computation": Megatron sharding.
The reference annotates shardings and lets GSPMD insert the all-reduces;
here the sharding is explicit. Every rank holds:

- ``qkv`` [L, D, 3D] and ``w1`` [L, D, F] split by columns, ``wo`` [L, D, D]
  and ``w2`` [L, F, D] split by rows (:func:`tp_param_specs` names the split
  axis of every leaf, in the reference's leaf names);
- the modulation, the embeddings and the final head whole (replicated).

``qkv`` is split by HEADS, not by contiguous columns: the forward reshapes
its 3D columns as (3, H, hd), so a contiguous slice would give rank 0 all of
q and part of k. Rank r takes heads [r H/W, (r+1) H/W) of each of q, k and
v, and the rows of ``wo`` that read those heads.

:func:`tp_forward` runs one full-image denoiser step with replicated
activations: every rank runs kernel K1 over its own heads ([B, N, H/W, hd],
all-fresh, ``tok_start`` 0) and the first MLP GEMM over its own columns;
the partial products ``att @ wo`` and ``gelu(xn @ w1) @ w2`` are summed
across the ranks (one all-reduce each, two a block) BEFORE the gated
residual ``addcmul`` with ``g1`` / ``g2``, and every rank returns the
whole eps. The all-reduce keeps the activations' dtype: NCCL and gloo both
sum bfloat16 (no widening to fp32).

A text-conditioned config is refused: the reference's specs have no
``xq``, ``xkv``, ``xo`` or ``ctx_pool`` leaves, so its ``tp_forward``
cannot take one either. Latency on heterogeneous devices comes from
:func:`repro_torch.core.simulate.simulate_tensor_parallel` (straggler-bound
per-layer sync).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.diffusion import DiTConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.diffusion import dit

#: the leaves split by heads: the split axis holds (3, H, hd) columns
HEAD_SPLIT = ("qkv",)


def _refuse_text(cfg: DiTConfig) -> None:
    if cfg.cross_attn:
        raise ValueError(
            "tensor parallelism takes class-conditional DiTs only: the "
            "reference's tp_param_specs have no xq / xkv / xo / ctx_pool "
            "leaves, so a text-conditioned config "
            f"(cond_seq_len={cfg.cond_seq_len}) has no TP layout")


def tp_param_specs(cfg: DiTConfig) -> dict:
    """The split axis of every leaf (the reference's leaf names and
    stacked [L, ...] layout), None for a replicated leaf. ``qkv``'s axis is
    split by heads (:data:`HEAD_SPLIT`)."""
    _refuse_text(cfg)
    blocks = {"qkv": 2, "wo": 1, "w1": 2, "w2": 1, "mod_w": None,
              "mod_b": None}
    return {"patch_embed": None, "patch_bias": None, "t_w1": None,
            "t_w2": None, "cond_embed": None, "blocks": blocks,
            "final_mod_w": None, "final_mod_b": None, "final_proj": None}


def _shard_leaf(name: str, leaf, axis: Optional[int], cfg: DiTConfig,
                rank: int, world: int):
    if axis is None:
        return leaf
    if name in HEAD_SPLIT:
        H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
        Hl = H // world
        heads = leaf.unflatten(axis, (3, H, hd))
        mine = heads.narrow(axis + 1, rank * Hl, Hl)
        return mine.flatten(axis, axis + 2).contiguous()
    n = leaf.shape[axis] // world
    return leaf.narrow(axis, rank * n, n).contiguous()


def shard_params(params: dict, cfg: DiTConfig, rank: int, world: int) -> dict:
    """Rank ``rank``'s shard of the full params, once before the steps:
    the split leaves sliced as :func:`tp_param_specs` says, the replicated
    ones as they are (shared, not copied)."""
    specs = tp_param_specs(cfg)
    Fd = int(cfg.mlp_ratio * cfg.d_model)
    if cfg.n_heads % world or Fd % world:
        raise ValueError(f"{world} ranks must divide the {cfg.n_heads} heads "
                         f"and the MLP width {Fd}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    extra = set(params) - set(specs) | set(params["blocks"]) - set(specs["blocks"])
    if extra:
        raise ValueError(f"leaves {sorted(extra)} have no TP layout")
    shard = {k: v for k, v in params.items() if k != "blocks"}
    shard["blocks"] = {name: _shard_leaf(name, leaf, specs["blocks"][name],
                                         cfg, rank, world)
                       for name, leaf in params["blocks"].items()}
    return shard


def _all_reduce(partial, group):
    dist.all_reduce(partial, group=group)
    return partial


def tp_forward(params_shard: dict, cfg: DiTConfig, x, t, cond, group=None):
    """Full-image TP denoiser step: [B, H, W, C] -> eps [B, H, W, C] on
    every rank of ``group`` (None: the default process group), each holding
    its :func:`shard_params` shard. Activations are replicated; two
    all-reduces a block (module docstring)."""
    _refuse_text(cfg)
    world = dist.get_world_size(group)
    B = x.shape[0]
    Hl = cfg.n_heads // world
    hd = cfg.d_model // cfg.n_heads
    h, c = dit.embed_patch(params_shard, cfg, x, t, cond, 0)
    N = h.shape[1]
    blocks = params_shard["blocks"]
    for i in range(blocks["qkv"].shape[0]):
        bp = {name: leaf[i] for name, leaf in blocks.items()}
        mod = dit._linear(c.to(h.dtype), bp["mod_w"], bp["mod_b"])
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        xn = dit._modulate(dit._ln(h), sh1, sc1)
        qkv = dit._linear(xn, bp["qkv"]).reshape(B, N, 3, Hl, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        att = kops.stale_kv_attention(q, k, v, k, v, tok_start=0)
        part = _all_reduce(dit._linear(att.reshape(B, N, Hl * hd), bp["wo"]),
                           group)
        x2 = torch.addcmul(h, g1[:, None], part)
        xn = dit._modulate(dit._ln(x2), sh2, sc2)
        part = _all_reduce(dit._linear(
            F.gelu(dit._linear(xn, bp["w1"]), approximate="tanh"), bp["w2"]),
            group)
        h = torch.addcmul(x2, g2[:, None], part)
    return dit.final_head(params_shard, cfg, h, c, cfg.tokens_per_side)
