"""Shared neural building blocks of the port (reference:
``repro.models.layers``): parameter init helpers drawing from an explicit
``torch.Generator``, RMS norm, rotary embeddings, the reference attention
and its masks, the attention block of the language models (whose
full-sequence attention runs kernel K6 through
``repro_torch.kernels.ops.flash_attention``), their single-token decode
attention over a full or ring cache (plain torch, as in the reference) and
the placement of a prefill's K/V in that ring, the enc-dec LM's
bidirectional and cross attention (K6 in its non-causal form), the gated
MLPs, the layer norm, the timestep embedding and the LM loss
(``cross_entropy``). The reference's ``models/attention.py``
(``chunked_attend``, its CPU stand-in for the flash kernel) has no
counterpart here: K6 and its plain version take both ``attn_impl`` values,
and the tests use ``chunked_attend`` as an oracle."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.shardwise import (heads_shardwise, is_dtensor,
                                            strided_shards_search)


# ----------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------

class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``. Every init of the
    port makes its leaves on its generator's device, so
    ``model.init(MetaGenerator())`` builds the parameter tree's shapes and
    dtypes without allocating it (the counterpart of
    ``jax.eval_shape(model.init, key)``): meta kernels take a CPU generator
    and draw nothing."""

    @property
    def device(self):
        return torch.device("meta")


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None):
    """Truncated-normal fan-in init (LeCun-style), drawn on the generator's
    device in float32 and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5):
    """RMS norm with the reference's ``(1 + weight)`` scale, computed in
    float32 and cast back to x's dtype. A DTensor ``x`` is first placed by
    :func:`batch_placed`: whole on the normalised dim, no partial sums, the
    batch and sequence splits of the residual stream's owner kept."""
    x = batch_placed(x)
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """Layer norm over the last axis (population variance), computed in
    float32 and cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * weight + bias
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# rotary embeddings
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] integer. Rotates the two
    halves of the head dim (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # [hd/2]
    angles = positions[..., None].float() * freqs                # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                        # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention core (reference path; the CUDA kernels live in repro_torch.kernels)
# ----------------------------------------------------------------------

def repeat_kv(kv, n_rep: int):
    """[B, T, K, hd] -> [B, T, K*n_rep, hd] (GQA broadcast: query head j
    reads KV head j // n_rep)."""
    return kv if n_rep == 1 else kv.repeat_interleave(n_rep, dim=2)


def attend(q, k, v, *, mask=None, scale: Optional[float] = None):
    """q: [B,S,H,hd]; k,v: [B,T,K,hd] with K | H. mask: broadcastable
    [B,1,S,T] bool. Returns [B,S,H,hd]. fp32 softmax; the probabilities are
    cast to v's dtype before the product, as in the JAX reference. On
    DTensors (the dry-run) on a mesh where strided shards cost a search
    (``shardwise.strided_shards_search``), and keys not split over T, shard
    by shard over the K/V's batch and heads (``shardwise.heads_shardwise``), as
    K6 runs: DTensor would fold batch and split heads into a ``bmm``'s
    batch dim. (A cache split over T, where its KV heads do not divide
    'model', keeps DTensor's own split of the scores over T.)"""
    if (is_dtensor(q) and strided_shards_search(q.device_mesh)
            and not any(p.is_shard(1) for p in k.placements)):
        return heads_shardwise(
            lambda q, k, v: attend(q, k, v, mask=mask, scale=scale), q, k, v,
            kv_lead=True)
    H, hd = q.shape[2], q.shape[3]
    k = repeat_kv(k, H // k.shape[2])
    v = repeat_kv(v, H // v.shape[2])
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def causal_mask(S: int, T: int, q_offset, device=None):
    """[1,1,S,T] bool: query i (global pos q_offset+i) sees keys <= its pos."""
    qi = torch.arange(S, device=device)[:, None] + q_offset
    kj = torch.arange(T, device=device)[None, :]
    return (kj <= qi)[None, None]


def window_mask(S: int, T: int, q_offset, window: int, device=None):
    qi = torch.arange(S, device=device)[:, None] + q_offset
    kj = torch.arange(T, device=device)[None, :]
    return ((kj <= qi) & (kj > qi - window))[None, None]


# ----------------------------------------------------------------------
# attention block (projection + rope + attend)
# ----------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, d_model: Optional[int] = None,
                   dtype=None):
    D = d_model or cfg.d_model
    dtype = dtype or getattr(torch, cfg.param_dtype)
    return {
        "wq": dense_init(gen, (D, cfg.n_heads * cfg.hd), dtype),
        "wk": dense_init(gen, (D, cfg.n_kv_heads * cfg.hd), dtype),
        "wv": dense_init(gen, (D, cfg.n_kv_heads * cfg.hd), dtype),
        "wo": dense_init(gen, (cfg.n_heads * cfg.hd, D), dtype,
                         scale=1.0 / math.sqrt(2 * max(1, cfg.n_layers)
                                               * cfg.n_heads * cfg.hd)),
    }


def attention_qkv(p, x, cfg, positions):
    q = split_heads(dense(x, p["wq"]), (cfg.n_heads, cfg.hd))
    k = split_heads(dense(x, p["wk"]), (cfg.n_kv_heads, cfg.hd))
    v = split_heads(dense(x, p["wv"]), (cfg.n_kv_heads, cfg.hd))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(p, x, cfg, *, positions=None, window: int = 0,
                   prefix_len: int = 0):
    """Full-sequence causal self attention (prefill), through kernel K6 for
    both ``attn_impl`` values. Keys in ``(q - window, q]`` are visible
    (all keys up to q when ``window`` is 0), and so are the ``prefix_len``
    leading positions (meta tokens) at or before q, outside the window: the
    mask of the reference's naive path and of its ``chunked_attend``.
    Returns (out [B, S, D], (k, v) [B, S, K, hd]). Under autograd K6's
    backward is the plain version's."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = attention_qkv(p, x, cfg, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              prefix_len=prefix_len)
    return dense(merge_heads(out), p["wo"]), (k, v)


def bidirectional_attention(p, x, cfg, positions=None):
    """Full-sequence attention without a mask (the enc-dec encoder): rope on
    q and k, then K6 in its non-causal form over the S keys. Returns
    [B, S, D]."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = attention_qkv(p, x, cfg, positions)
    out = ops.flash_attention(q, k, v, causal=False)
    return dense(merge_heads(out), p["wo"])


def cross_attention(p, x, memory_kv, cfg):
    """x: [B,S,D] queries (no rope) over ``memory_kv`` = (k, v) [B,T,K,hd]
    precomputed from the encoder's output: K6 in its non-causal form at any
    S, the decode's S = 1 included. Returns [B, S, D]."""
    q = split_heads(dense(x, p["wq"]), (cfg.n_heads, cfg.hd))
    k, v = memory_kv
    out = ops.flash_attention(q, k, v, causal=False)
    return dense(merge_heads(out), p["wo"])


def decode_attention(p, x, cfg, cache_k, cache_v, pos: int, *, window: int = 0,
                     prefix_len: int = 0):
    """Single-token decode. x: [B,1,D]; cache_[kv]: one layer's [B,T,K,hd]
    cache views; ``pos`` (a Python int) the token's position.

    Full cache (window 0): the token's K/V go to slot ``pos`` and keys up
    to ``pos`` are visible; a position past the cache raises (the
    reference's ``dynamic_update_slice`` would clamp the write to the last
    slot). Ring cache (window > 0): ``prefix_len`` pinned slots (a VLM's
    vision tokens; 0 for the text decoders, where the ring is the
    reference's ``pos % window``) and ``T - prefix_len`` ring slots, the
    token at ``prefix_len + (pos - prefix_len) % window``; the pinned slots
    and the ring slots written so far are visible. K/V are written into the
    views in place; returns out [B,1,D]."""
    B = x.shape[0]
    T = cache_k.shape[1]
    q = split_heads(dense(x, p["wq"]), (cfg.n_heads, cfg.hd))
    k = split_heads(dense(x, p["wk"]), (cfg.n_kv_heads, cfg.hd))
    v = split_heads(dense(x, p["wv"]), (cfg.n_kv_heads, cfg.hd))
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    if window:
        slot = prefix_len + (pos - prefix_len) % window
        n_valid = prefix_len + min(pos - prefix_len + 1, window)
    elif pos >= T:
        raise ValueError(
            f"full-cache decode at position {pos} is past the cache's {T} "
            "slots; the reference (repro.models.layers.decode_attention's "
            "dynamic_update_slice_in_dim) silently clamps the write to slot "
            f"{T - 1}. Size init_cache's max_len for prompt + new tokens, or "
            "decode with a window")
    else:
        slot, n_valid = pos, pos + 1
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    valid = (torch.arange(T, device=x.device) < n_valid)[None, None, None, :]
    out = attend(q, cache_k, cache_v, mask=valid)
    return dense(merge_heads(out), p["wo"])


def ring_kv(kv, T: int, prefix_len: int = 0):
    """The ``T`` cache slots of a prefill's stacked K or V ``[L, B, S, K,
    hd]`` when ``S >= T``: the ``prefix_len`` pinned positions in their
    slots, then the last ``T - prefix_len`` positions where decode reads
    and writes them, position p at slot ``prefix_len + (p - prefix_len) %
    (T - prefix_len)`` (:func:`decode_attention`; Hymba's meta-pinned ring).
    The reference keeps them in order in slots ``prefix_len..T-1``, which
    is that layout only when ``(S - prefix_len) % (T - prefix_len) == 0``:
    otherwise its first decode step overwrites a key still inside the
    window and keeps one that left it (ROADMAP.md queue 3)."""
    S = kv.shape[2]
    ring = T - prefix_len
    tail = kv[:, :, S - ring:].roll((S - prefix_len) % ring, dims=2)
    return torch.cat([kv[:, :, :prefix_len], tail], dim=2)


def constrain_residual(x, cfg):
    """The reference's ``lm._constrain`` (``cfg.act_shard``, a JAX sharding
    constraint on the residual stream [B, S, D] at each block's entry):
    given a DTensor, ``batch`` redistributes it to batch over 'data' and
    ``seqpar`` to batch over 'data' and sequence over 'model', every other
    mesh dim replicated. Plain tensors, and an empty ``act_shard``, pass
    through. The block's norms keep the batch and sequence splits set here
    (:func:`batch_placed`); with no ``act_shard`` the stream is split on
    its batch alone, so on the 2-D mesh ``batch`` pins what the norms
    would give it (on the 3-D mesh it replicates 'pod', as the
    reference's spec does)."""
    if not cfg.act_shard or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = {"data": Shard(0),
            "model": Shard(1) if cfg.act_shard == "seqpar" else Replicate()}
    return x.redistribute(x.device_mesh, [want.get(n, Replicate())
                                          for n in x.device_mesh.mesh_dim_names])


# ----------------------------------------------------------------------
# DTensor placements (the dry-run; each passes plain tensors through)
# ----------------------------------------------------------------------
#
# DTensor resolves a placement only one way or refuses it, where GSPMD
# reshards implicitly: a view that splits or merges a dim whose shards do
# not divide it is refused, and a fold of [B, S] whose S (or an uneven B)
# is split yields strided shards, whose redistributions DTensor plans by a
# graph search that takes minutes an op on a 3-D mesh. The helpers below
# place such tensors, and their gradients, explicitly.

def split_heads(x, dims):
    """``[..., prod(dims)] -> [..., *dims]`` (``dims`` e.g. ``(H, hd)``):
    on a plain tensor, ``reshape``. On a DTensor, a mesh dim that would
    split the last dim unevenly, or that splits the sequence dim, moves
    first (:func:`_even_for_view`), and so does one of the gradient's
    before the backward merges it."""
    shape = tuple(x.shape[:-1]) + tuple(dims)
    if not is_dtensor(x):
        return x.reshape(shape)
    y = _even_for_view(x, (x.ndim - 1,), dims[0]).reshape(shape)
    back = tuple(range(x.ndim - 1, y.ndim))
    return _PlaceGrad.apply(y, lambda g: _even_for_view(g, back, dims[0]))


def merge_heads(x, n: int = 2):
    """``[..., a, b] -> [..., a * b]`` over the last ``n`` dims: on a plain
    tensor, ``reshape``; on a DTensor, as :func:`split_heads`."""
    shape = tuple(x.shape[:-n]) + (-1,)
    if not is_dtensor(x):
        return x.reshape(shape)
    lead = x.shape[-n]
    y = _even_for_view(x, tuple(range(x.ndim - n, x.ndim)), lead).reshape(shape)
    last = y.ndim - 1
    return _PlaceGrad.apply(y, lambda g: _even_for_view(g, (last,), lead))


def _even_for_view(x, dims, lead: int):
    """``x`` placed so that DTensor can split or merge ``dims`` (heads and
    head dim) evenly. In order of preference, a mesh dim that splits one of
    ``dims`` or the sequence dim (1), or holds a partial sum: (1) splits
    the first of ``dims`` (the heads), where the shards so far still
    divide ``lead`` (the head count); (2) else splits the batch (dim 0)
    where that divides, so that the attention or recurrence after it does
    not repeat its work over that mesh dim; (3) else replicates (a partial
    sum stays: the shard-by-shard runs reduce it). The sequence dim is not
    kept split: the attention and the recurrences run shard by shard over
    batch and heads and would gather it again, and the next matmul would
    fold it into strided shards. Shards of the batch dim stay."""
    from torch.distributed.tensor import Replicate, Shard

    out = list(x.placements)
    kept = 1           # the mesh dims so far that keep or take the heads
    for i, (pl, n) in enumerate(zip(x.placements, x.device_mesh.shape)):
        d = None if pl.is_replicate() or pl.is_partial() else pl.dim
        if d not in dims and d != 1 and not pl.is_partial():
            continue
        if lead % (kept * n) == 0 and (d == dims[0] or d not in dims):
            out[i] = Shard(dims[0])
            kept *= n
            continue
        fit = _first_fit(x, out, i, [(0, x.shape[0])])
        if fit is not None:
            out[i] = fit
        elif not pl.is_partial():
            out[i] = Replicate()
    return x if out == list(x.placements) else x.redistribute(x.device_mesh, out)


def moved(x, src: int, dst: int):
    """``x`` with each mesh dim that splits its dim ``src`` splitting dim
    ``dst`` instead where that divides, else the batch (dim 0) where that
    divides, else replicated (an sLSTM's gates regrouped a head at a time:
    the split moves from the gate axis to the heads). Plain tensors pass
    through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    out = list(x.placements)
    for i, pl in enumerate(x.placements):
        if pl.is_shard(src):
            fit = _first_fit(x, out, i, [(dst, x.shape[dst]), (0, x.shape[0])])
            out[i] = Replicate() if fit is None else fit
    return x if out == list(x.placements) else x.redistribute(x.device_mesh, out)


def _first_fit(x, out, i, candidates):
    """``Shard(d)`` for the first ``(d, size)`` of ``candidates`` whose
    ``size`` mesh dim ``i`` splits evenly together with the other mesh dims
    that split dim ``d`` in the placements ``out`` of ``x``; else None."""
    from torch.distributed.tensor import Shard

    sizes = x.device_mesh.shape
    for d, size in candidates:
        split = math.prod(m for j, (p, m) in enumerate(zip(out, sizes))
                          if j != i and p.is_shard(d))
        if size % (split * sizes[i]) == 0:
            return Shard(d)
    return None


def grad_as_value(x):
    """``x``; on a DTensor under autograd on a mesh where strided shards
    cost a search (``shardwise.strided_shards_search``), its gradient is
    placed as ``x`` is (where ``x`` is a partial sum: a replica, or the
    gradient's own partial sum): GSPMD's rule that a cotangent is sharded
    like its value, applied to each block's output. DTensor's backward of a
    norm otherwise moves the residual's shards onto the sequence dim, which
    the next matmul folds into strided shards."""
    if not (is_dtensor(x) and torch.is_grad_enabled() and x.requires_grad
            and strided_shards_search(x.device_mesh)):
        return x
    from torch.distributed.tensor import Replicate

    mesh, value = x.device_mesh, x.placements      # not x: the closure outlives it

    def place(g):
        want = [(q if q.is_partial() or q.is_replicate() else Replicate())
                if p.is_partial() else p for p, q in zip(value, g.placements)]
        return g if want == list(g.placements) else g.redistribute(mesh, want)
    return _PlaceGrad.apply(x, place)


def tokens_whole(x, grad_only: bool = False):
    """``x`` [B, ..., D] with no mesh dim splitting its inner token dims
    (1 to ndim - 2) and none splitting B unevenly (each such mesh dim
    replicates), and its gradient placed so too; with ``grad_only``, only
    the gradient. (``launch.dryrun`` applies it around a matmul that folds
    the token dims, where either split would become a strided shard.)"""
    if not is_dtensor(x):
        return x
    if not grad_only:
        x = _tokens_whole(x)
    if torch.is_grad_enabled() and x.requires_grad:
        x = _PlaceGrad.apply(x, _tokens_whole)
    return x


def _tokens_whole(x):
    from torch.distributed.tensor import Replicate

    pl, split = list(x.placements), 1
    for i, (p, n) in enumerate(zip(x.placements, x.device_mesh.shape)):
        d = None if p.is_replicate() or p.is_partial() else p.dim
        if d == 0 and p.is_shard() and x.shape[0] % (split * n) == 0:
            split *= n
        elif d is not None and d < x.ndim - 1:
            pl[i] = Replicate()
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


class _PlaceGrad(torch.autograd.Function):
    """The identity; its backward places a DTensor gradient by ``place``."""

    @staticmethod
    def forward(ctx, y, place):
        ctx.place = place
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (ctx.place(g) if is_dtensor(g) else g), None


def placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements when both are DTensors
    (a step's new cache leaf placed as the cache it replaces); else ``x``."""
    if is_dtensor(x) and is_dtensor(ref) and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def unshard(w, like):
    """FSDP's unshard at use: the weight ``w`` replicated over every mesh
    dim that splits ``like``'s batch dim (dim 0 of the tokens or
    activations that read it), its other placements kept. The rules split a weight's d_model over
    'data' (``sharding/specs.py``) and a batch over ('pod', 'data'); GSPMD
    gathers such a weight where it meets a split batch and keeps the tokens
    split, where DTensor would keep the weight split and repeat the whole
    batch's work on every 'data' rank. The backward reduces the weight's
    gradient onto its shards (a reduce-scatter). Where the batch is not
    split (a batch of one), the weight stays as placed. Plain tensors pass
    through."""
    if not (is_dtensor(like) and is_dtensor(w)):
        return w
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if b.is_shard(0) and p.is_shard() else p
          for b, p in zip(like.placements, w.placements)]
    return w if pl == list(w.placements) else w.redistribute(w.device_mesh, pl)


def batch_placed(x, like=None):
    """``x`` [B, S, ...] as the residual stream is read (at each norm and
    from the embedding): split on its batch over the batch axes ('pod',
    'data') and on its sequence wherever its owner split it (the seqpar
    variant's tokens, ``constrain_residual``'s ``seqpar``), whole on every
    other mesh dim (partial sums reduced, other shards gathered), and its
    gradient placed so too. ``like`` (the tokens, for the embedding's rows)
    gives those splits instead of ``x``. This is GSPMD's placement under
    FSDP-style weights (:func:`unshard`), where the row-parallel products'
    partial sums, and their gradients, would otherwise lead DTensor to
    gather a weight over 'model'. Where neither split is there, ``x``."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.specs import batch_axes

    mesh = x.device_mesh
    axes = batch_axes(mesh)
    want = [Shard(0) if p.is_shard(0) and name in axes
            else Shard(1) if p.is_shard(1) else Replicate()
            for p, name in zip((x if like is None else like).placements,
                               mesh.mesh_dim_names)]
    if want == [Replicate()] * mesh.ndim:
        return x

    def place(t):
        return t if list(t.placements) == want else t.redistribute(mesh, want)
    x = place(x)
    if torch.is_grad_enabled() and x.requires_grad:
        x = _PlaceGrad.apply(x, place)
    return x


def dense(x, w):
    """``x @ w``: activations ``x`` [B, ..., D] times a weight ``w`` [D, F].
    Given DTensors, ``w`` is gathered where ``x``'s batch is split
    (:func:`unshard`), and on each other mesh dim:

    - ``w`` split on its output (column-parallel) and ``x`` on its d_model:
      ``x`` is gathered (no partial sum to reduce);
    - ``w`` whole, and ``x`` whole or split on its d_model: that dim's work
      would be repeated, or leave a partial sum, on every rank along it,
      so ``x``'s batch is split over it where it divides; else, with ``x``
      whole, the contraction is (a partial sum to reduce, where ``w``'s
      d_model is not split elsewhere), if that sum is no wider than ``x``
      or is one token a row (a decode step).

    A split of ``x``'s token dims (the sequence, under ``seqpar`` /
    ``actseq``) is gathered first: the norm ran on the sequence's shards,
    the product reads it whole, as Megatron's sequence parallelism
    all-gathers before a column-parallel product (and torch before 2.13
    refuses the matmul's flattening of a split sequence dim).

    Plain tensors: ``x @ w``."""
    if not is_dtensor(x):
        return x @ w
    from torch.distributed.tensor import Replicate, Shard

    w = unshard(w, x)
    tokens = [Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p
              for p in x.placements]
    if tokens != list(x.placements):
        x = x.redistribute(x.device_mesh, tokens)
    xp, wp = list(x.placements), list(w.placements)
    rows = math.prod(x.shape[1:-1])
    for i, n in enumerate(x.device_mesh.shape):
        split_d = xp[i].is_shard(x.ndim - 1) and not wp[i].is_shard(w.ndim - 2)
        if split_d and wp[i].is_shard(w.ndim - 1):
            xp[i] = Replicate()
            continue
        if n == 1 or not (split_d or xp[i] == wp[i] == Replicate()):
            continue
        fit = _first_fit(x, xp, i, [(0, x.shape[0])])
        if fit is not None:
            xp[i] = fit
        elif (not split_d and x.shape[-1] % n == 0
              and (rows == 1 or w.shape[-1] <= w.shape[-2])
              and not any(p.is_shard(w.ndim - 2) for p in wp)):
            xp[i], wp[i] = Shard(x.ndim - 1), Shard(w.ndim - 2)
    if xp != list(x.placements):
        x = x.redistribute(x.device_mesh, xp)
    if wp != list(w.placements):
        w = w.redistribute(w.device_mesh, wp)
    return x @ w


def embed(table, tokens):
    """``table[tokens]``. Given DTensors whose batch is split, the table is
    gathered over the batch's mesh dims (:func:`unshard`), the lookup is
    ``F.embedding`` (torch before 2.13 has sharding rules for its backward,
    and refuses the backward of an indexing, an ``index_put``, once the
    tokens are split), and the rows are split as the tokens are
    (:func:`batch_placed`; the masked partial sum of a vocab split over
    'model' reduced)."""
    if not (is_dtensor(tokens) and any(p.is_shard(0) for p in tokens.placements)):
        return table[tokens]
    rows = torch.nn.functional.embedding(tokens, unshard(table, tokens))
    return batch_placed(rows, like=tokens)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, ``fn`` runs on
    each rank's shard (partial sums reduced first), for the ops DTensor has
    no sharding rule for (``logsigmoid``'s backward)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return local_map(fn, pl, (pl,), device_mesh=x.device_mesh)(x)


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, d_model: Optional[int] = None,
             d_ff: Optional[int] = None, dtype=None):
    D = d_model or cfg.d_model
    F = d_ff or cfg.d_ff
    dtype = dtype or getattr(torch, cfg.param_dtype)
    return {
        "w_gate": dense_init(gen, (D, F), dtype),
        "w_up": dense_init(gen, (D, F), dtype),
        "w_down": dense_init(gen, (F, D), dtype,
                             scale=1.0 / math.sqrt(2 * max(1, cfg.n_layers) * F)),
    }


def mlp(p, x, activation: str = "swiglu"):
    """Gated MLP: swiglu (SiLU gate) or geglu (GELU gate in its tanh form,
    ``jax.nn.gelu``'s default)."""
    gate = dense(x, p["w_gate"])
    up = dense(x, p["w_up"])
    if activation == "geglu":
        h = torch.nn.functional.gelu(gate, approximate="tanh") * up
    else:
        h = torch.nn.functional.silu(gate) * up
    return dense(h, p["w_down"])


# ----------------------------------------------------------------------
# misc
# ----------------------------------------------------------------------

def sinusoidal_embedding(t, dim: int, max_period: float = 10_000.0):
    """t: [B] float timesteps -> [B, dim], ``[cos, sin]`` order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def cross_entropy(logits, labels, ignore_id: int = -1):
    """logits [B,S,V] of any float dtype; labels [B,S] integer. The mean
    negative log-likelihood in float32 over the labels that are not
    ``ignore_id``. The gold logit is gathered (the reference contracts a
    one-hot with the logits so that GSPMD keeps the vocab sharded; the
    two agree to rounding). DTensor logits (the dry-run) take the
    reference's one-hot contraction: DTensor's gather over a sharded vocab
    leaves a masked partial sum that ``meta`` shards cannot reduce."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.sum(logits * (vocab == labels[..., None]), dim=-1)
    else:
        gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
