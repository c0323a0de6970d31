"""DiT denoiser (arXiv:2212.09748) with patch-parallel support — the port of
``repro.models.diffusion.dit``.

Tokens are row-major over the latent grid; a *patch* is a contiguous range of
token ROWS (STADI's allocatable unit, P_total = tokens_per_side rows).
``forward_patch`` computes eps for a local row range while attending over
full-image K/V assembled from (fresh local) ⊕ (stale remote) buffers — the
DistriFusion mechanism that STADI schedules.

Parameters keep the reference's pytree: a dict with the per-block leaves
stacked ``[L, ...]`` under ``"blocks"``; a Python loop over L takes the place
of ``lax.scan``. Every attention — the buffered patch read and the
full-image warm-up read alike — goes through
:func:`repro_torch.kernels.ops.stale_kv_attention`, which runs the
hand-written CUDA kernel for CUDA tensors and its plain version for CPU
tensors. The all-fresh read (``buffers`` None: the full-image forward a
training step differentiates) goes through
:func:`repro_torch.kernels.ops.stale_kv_attention_autograd`, K1 under an
autograd Function whose backward is the plain version's. With ``valid_tokens`` set (the multi-rank executors' slab padded
to the largest patch), the buffered read goes through
:func:`repro_torch.kernels.ops.stale_kv_attention_padded` (kernel K2)
instead. Dtypes follow JAX's promotion rule: a product of activations and
weights of two float dtypes runs in the wider one.

A text-conditioned config (``DiTConfig.text_conditioned``, DESIGN.md §17)
adds a prompt cross-attention read to every block, between self-attention
and the MLP, and pools the prompt tokens into the adaLN conditioning vector.
The reference runs that read as its plain ``layers.attend`` (it has no
kernel for it), and so does the port: a guidance null branch masks every
prompt key, and only the reference's finite ``-1e30`` fill turns that into
uniform weights over zero values, an exact 0.0, where a ``-inf`` fill or
``scaled_dot_product_attention`` gives NaN.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.configs.diffusion import DiTConfig
from repro_torch.core import sampler
from repro_torch.core.guidance import NULL_COND
from repro_torch.kernels import ops as kops
from repro_torch.models import layers


def _torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _linear(x, w, b=None):
    """x @ w (+ b) in the wider of the two dtypes, as JAX promotes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    return y if b is None else y + b


# ----------------------------------------------------------------------
# patchify helpers
# ----------------------------------------------------------------------

def patchify(x, patch: int):
    """[B,H,W,C] -> [B, (H/p)*(W/p), p*p*C], row-major token grid."""
    B, H, W, C = x.shape
    hp, wp = H // patch, W // patch
    x = x.reshape(B, hp, patch, wp, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, hp * wp, patch * patch * C)


def unpatchify(tok, patch: int, hp: int, wp: int, channels: int):
    B = tok.shape[0]
    x = tok.reshape(B, hp, wp, patch, patch, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, hp * patch, wp * patch, channels)


def pos_embed_2d(hp: int, wp: int, dim: int, device=None):
    """Fixed 2D sin-cos positional embedding [hp*wp, dim], ``[sin, cos]``
    order per axis (the timestep embedding uses ``[cos, sin]``)."""
    def _1d(n, d):
        pos = torch.arange(n, dtype=torch.float32, device=device)
        omega = torch.exp(-math.log(10_000.0)
                          * torch.arange(d // 2, dtype=torch.float32,
                                         device=device) / (d // 2))
        out = pos[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)   # [n, d]

    eh = _1d(hp, dim // 2)
    ew = _1d(wp, dim // 2)
    grid = torch.cat([eh[:, None].expand(hp, wp, dim // 2),
                      ew[None, :].expand(hp, wp, dim // 2)], dim=-1)
    return grid.reshape(hp * wp, dim)


# ----------------------------------------------------------------------
# params
# ----------------------------------------------------------------------

#: seed offsets of the streams the prompt leaves are drawn from: the
#: cross-attention params of :func:`init_params` and xo's values in
#: :func:`nondegenerate_params` (the reference's ``seed + 101`` stream).
#: Drawing them apart leaves every class leaf bitwise what the same generator
#: gives a class-conditional config.
_XATTN_STREAM = 1_000_003
_XO_STREAM = 101


def _stream(gen: torch.Generator, offset: int) -> torch.Generator:
    """A generator on gen's device seeded ``offset`` past gen's seed."""
    return torch.Generator(device=gen.device).manual_seed(
        gen.initial_seed() + offset)


def init_params(gen: torch.Generator, cfg: DiTConfig):
    """Untrained DiT params (adaLN-zero) drawn from ``gen`` on its device.
    The draws are torch's, so they differ from the reference's
    ``jax.random`` draws; tests carry the reference's params through
    :mod:`repro_torch.bridge` instead. A text-conditioned config adds the
    prompt cross-attention leaves ``blocks.xq`` [L, D, D], ``blocks.xkv``
    [L, cond_dim, 2D], ``blocks.xo`` (zeros, adaLN-zero) and ``ctx_pool``
    [cond_dim, D], drawn from a second stream so the class leaves stay
    bitwise those of the class-conditional config."""
    dt = _torch_dtype(cfg.param_dtype)
    D, L = cfg.d_model, cfg.n_layers
    Fd = int(cfg.mlp_ratio * D)
    dev = gen.device
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    blocks = {
        "qkv": layers.dense_init(gen, (L, D, 3 * D), dt),
        "wo": layers.dense_init(gen, (L, D, D), dt, scale=1.0 / math.sqrt(2 * L * D)),
        "w1": layers.dense_init(gen, (L, D, Fd), dt),
        "w2": layers.dense_init(gen, (L, Fd, D), dt, scale=1.0 / math.sqrt(2 * L * Fd)),
        "mod_w": zeros(L, D, 6 * D),                     # adaLN-zero init
        "mod_b": zeros(L, 6 * D),
    }
    out = {
        "patch_embed": layers.dense_init(gen, (cfg.token_dim, D), dt),
        "patch_bias": zeros(D),
        "t_w1": layers.dense_init(gen, (256, D), dt),
        "t_w2": layers.dense_init(gen, (D, D), dt),
        "cond_embed": layers.embed_init(gen, (cfg.n_classes, D), dt),
        "blocks": blocks,
        "final_mod_w": zeros(D, 2 * D),
        "final_mod_b": zeros(2 * D),
        "final_proj": zeros(D, cfg.token_dim),           # zero-init output
    }
    if cfg.cross_attn:
        xgen = _stream(gen, _XATTN_STREAM)
        blocks["xq"] = layers.dense_init(xgen, (L, D, D), dt)
        blocks["xkv"] = layers.dense_init(xgen, (L, cfg.cond_dim, 2 * D), dt)
        blocks["xo"] = zeros(L, D, D)
        out["ctx_pool"] = layers.dense_init(xgen, (cfg.cond_dim, D), dt)
    return out


def nondegenerate_params(params, gen: torch.Generator):
    """Untrained params are adaLN-zero: modulation gates and the output head
    are exactly zero, so eps ignores attention (and the stale-KV buffers)
    entirely. This replaces those zeros with small draws from ``gen`` so
    remote K/V genuinely influences the trajectory. Returns a modified copy.

    A text-conditioned model's ``xo`` (adaLN-zero too) gets 0.05 x N(0, 1)
    from a stream of its own, so the class leaves get the draws they get
    without it. Unlike the reference, whose ``jax.random.normal`` draws turn
    these leaves into float32 even in a bf16 model, every leaf keeps its
    dtype here, so a bf16 model stays bf16 end to end."""
    def draw(like, std, g=gen):
        w = torch.randn(like.shape, generator=g, dtype=torch.float32,
                        device=g.device)
        return (std * w).to(device=like.device, dtype=like.dtype)

    params = dict(params)
    blk = dict(params["blocks"])
    blk["mod_w"] = draw(blk["mod_w"], 0.02)
    blk["mod_b"] = draw(blk["mod_b"], 0.02)
    params["blocks"] = blk
    params["final_mod_w"] = draw(params["final_mod_w"], 0.02)
    params["final_proj"] = draw(params["final_proj"], 0.05)
    if "xo" in blk:
        blk["xo"] = draw(blk["xo"], 0.05, _stream(gen, _XO_STREAM))
    return params


# ----------------------------------------------------------------------
# block math
# ----------------------------------------------------------------------

def _modulate(x, shift, scale):
    """x * (1 + scale) + shift, one fused elementwise kernel."""
    return torch.addcmul(shift[:, None], x, 1 + scale[:, None])


def _ln(x, eps=1e-6):
    """Affine-free layer norm with float32 statistics (population variance,
    as the reference's ``jnp.var``), in x's dtype. ``F.layer_norm``
    accumulates in float32 for bf16 inputs, so this is one fused kernel where
    the reference's formula would be seven."""
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


def _per_row(value, B, dev):
    """A number, a 0-d tensor or one value a batch row, as float32 [B]."""
    if isinstance(value, torch.Tensor) and value.dim():
        return value.to(device=dev, dtype=torch.float32).expand(B)
    return torch.full((B,), float(value), dtype=torch.float32, device=dev)


def _cond_vector(params, cfg, t, cond, B, frame=None):
    """Timestep + class or prompt conditioning vector [B, D]. ``t`` is a
    number (or a 0-d tensor), or one timestep a batch row ([B]: the serving
    engine's lanes, each at its own step); ``cond`` None, class ids
    broadcastable to [B] where the reserved :data:`NULL_COND` selects the
    zero (unconditional) embedding, or prompt tokens [B, L, cond_dim + 1]
    whose masked mean is projected by ``ctx_pool`` (the all-zero null
    sequence pools to exactly 0.0). ``frame`` (the video path, DESIGN.md
    §16): None, or the latent frame index in either form of ``t``, whose
    sinusoidal embedding is summed into the timestep features in float32
    before the shared MLP; None adds no op, so frame 0 and the image path
    stay bitwise."""
    dev = params["t_w1"].device
    temb = layers.sinusoidal_embedding(_per_row(t, B, dev), 256)
    if frame is not None:
        temb = temb + layers.sinusoidal_embedding(_per_row(frame, B, dev), 256)
    temb = _linear(F.silu(_linear(temb.to(params["t_w1"].dtype),
                                  params["t_w1"])), params["t_w2"])
    if cond is None:
        return F.silu(temb)
    cond = torch.as_tensor(cond, device=dev)
    if cond.ndim >= 2:
        return F.silu(temb + _pooled_prompt(params["ctx_pool"], cond))
    idx = cond.to(torch.int64).expand(B)
    gathered = params["cond_embed"][idx.clamp(min=0)]
    cemb = torch.where((idx >= 0)[:, None], gathered, torch.zeros_like(gathered))
    return F.silu(temb + cemb)


def _pooled_prompt(ctx_pool, cond):
    """The prompt's part of the conditioning vector [B, D]: the masked mean
    of the tokens of ``cond`` [B, L, Dc+1] (divided by max(real tokens, 1),
    so the null sequence pools to exactly 0.0), projected by ``ctx_pool``
    as the reference's broadcast-multiply-reduce rather than ``pooled @
    ctx_pool``: a GEMM's algorithm changes with the rows it is given, the
    reduction's order does not, so a served lane's vector stays bitwise
    that of its lone generate."""
    toks, w = cond[..., :-1], cond[..., -1:]
    pooled = ((toks * w).sum(1) / w.sum(1).clamp(min=1.0)).to(ctx_pool.dtype)
    return (pooled[..., :, None] * ctx_pool).sum(-2)


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

def embed_patch(params, cfg: DiTConfig, x_rows, t, cond, row_start: int,
                frame=None):
    """Pre-block embedding of a row-patch: patchify + patch embed + 2D pos
    embed + conditioning vector (``frame``: see :func:`_cond_vector`).
    Returns (h [B,Nl,D], c [B,D])."""
    B = x_rows.shape[0]
    wp = cfg.tokens_per_side
    tok = patchify(x_rows, cfg.patch_size)               # [B, Nl, token_dim]
    Nl = tok.shape[1]
    start = row_start * wp
    pe = pos_embed_2d(wp, wp, cfg.d_model, device=tok.device)[start:start + Nl]
    # a slab padded past the image's last row (the multi-rank executors)
    # gets zero positional embeddings on its scratch tail, as in the reference
    pe = F.pad(pe, (0, 0, 0, Nl - pe.shape[0]))
    h = _linear(tok, params["patch_embed"]) + params["patch_bias"] \
        + pe.to(tok.dtype)
    return h, _cond_vector(params, cfg, t, cond, B, frame=frame)


def block_stack(blocks, cfg: DiTConfig, h, c, tok_start: int,
                buffers: Optional[Tuple] = None, return_kv: bool = True,
                valid_tokens: Optional[int] = None, enable=None,
                attend_fn=None, ctx_tokens: Optional[int] = None,
                prompt_ctx=None):
    """Run a stack of DiT blocks over hidden states ``h`` [B, Nl, D].

    blocks:  dict of per-block params, leading axis = block count
    buffers: None (attention over the patch's own tokens: exact when the
             patch is the whole image) or (buf_k, buf_v) each
             [n_blocks, B, N_total, H, hd] — the stale K/V context; the
             patch's own rows are read fresh instead (DistriFusion)
    valid_tokens: None, or the multi-rank layout: ``h`` is a slab padded to
             the largest patch whose first ``valid_tokens`` rows are real,
             and the buffers are scratch-padded to ``cfg.n_tokens + Nl``
             rows; every buffered read runs kernel K2, which reads only the
             real rows fresh and masks the scratch keys. Rows past
             ``valid_tokens`` are computed and left for the caller to drop.
    attend_fn: optional replacement for the buffered read, called as
             ``attend_fn(q, full_k, full_v, key_mask)`` with the
             freshness-blended whole-image context: a COPY of the buffers
             with this slab's K/V written at ``tok_start`` (under
             ``valid_tokens`` its rows past that blended back to the
             buffer's) and, under ``valid_tokens``, ``key_mask`` [1, 1, 1,
             N_total] (True = attend; keys from ``ctx_tokens`` on are
             scratch), else None. The sequence-parallel executor routes the
             read through its head scatter and ring hops here.
    ctx_tokens: the real context tokens of scratch-padded buffers (with
             ``valid_tokens``); None = ``cfg.n_tokens``. The multi-frame
             executors pass ``2 * n_tokens`` for their own ⊕ previous frame
             context (DESIGN.md §16). Without ``valid_tokens`` the context
             is the whole buffer, whatever its length: the fresh rows land
             at ``tok_start`` within it.
    prompt_ctx: None, or (tokens [B, Lc, cond_dim], key mask [B, 1, 1, Lc]
             bool) read by every block's prompt cross-attention, between
             self-attention and the MLP (the reference's plain attend). None
             adds no op, so the class-conditional path stays bitwise.
    Returns (h', kvs) with kvs the fresh (k, v), each [n_blocks, B, Nl, H,
    hd], or None when ``return_kv`` is False.

    The reference's ``enable`` stage mask pads the stages of its lockstep
    chain; the port's chain runs each stage's own blocks
    (:func:`repro_torch.core.pipefuse.stage_blocks`) and refuses it.
    """
    if enable is not None:
        raise NotImplementedError(
            "block_stack(enable=...) is not ported: the stage chain of "
            "ROADMAP queue 1 item 10 slices the blocks a stage runs "
            "(pipefuse.stage_blocks) instead of masking them")
    n_real = ctx_tokens or cfg.n_tokens
    B, Nl, D = h.shape
    H = cfg.n_heads
    hd = D // H
    n_blocks = blocks["qkv"].shape[0]
    x = h
    ks, vs = [], []
    if prompt_ctx is not None:
        ck, cmask = prompt_ctx
        prompt_kv = _prompt_kv(blocks["xkv"], ck, x.dtype)
    for i in range(n_blocks):
        bp = {name: leaf[i] for name, leaf in blocks.items()}
        mod = _linear(c.to(x.dtype), bp["mod_w"], bp["mod_b"])
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        xn = _modulate(_ln(x), sh1, sc1)
        qkv = _linear(xn, bp["qkv"]).reshape(B, Nl, 3, H, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if buffers is None:
            # all-fresh layout: the context is the patch itself; the one
            # read a training step differentiates (K1 under autograd)
            att = kops.stale_kv_attention_autograd(q, k, v, k, v, tok_start=0)
        elif attend_fn is not None:
            att = attend_fn(q, *_blended_context(
                k, v, buffers[0][i], buffers[1][i], tok_start, valid_tokens,
                n_real))
        elif valid_tokens is not None:
            # padded multi-rank layout: fresh over the real rows only,
            # scratch keys masked (kernel K2)
            att = kops.stale_kv_attention_padded(
                q, k, v, buffers[0][i].to(q.dtype), buffers[1][i].to(q.dtype),
                tok_start, valid_tokens, n_tokens=n_real)
        else:
            att = kops.stale_kv_attention(q, k, v, buffers[0][i].to(q.dtype),
                                          buffers[1][i].to(q.dtype),
                                          tok_start=tok_start)
        x2 = torch.addcmul(x, g1[:, None], _linear(att.reshape(B, Nl, D), bp["wo"]))
        if prompt_ctx is not None:
            x2 = _prompt_read(bp, x2, prompt_kv[i], cmask, H)
        xn = _modulate(_ln(x2), sh2, sc2)
        hmid = _linear(F.gelu(_linear(xn, bp["w1"]), approximate="tanh"),
                       bp["w2"])
        x = torch.addcmul(x2, g2[:, None], hmid)
        if return_kv:
            ks.append(k)
            vs.append(v)
    return x, ((torch.stack(ks), torch.stack(vs)) if return_kv else None)


def _prompt_kv(xkv, ck, dtype):
    """Every block's prompt K/V projection, ``ck.to(dtype) @ xkv`` as the
    reference's per-block product, as [n_blocks, B, Lc, 2D]: one product
    over the blocks a batch row, so each row runs the same GEMM whatever
    batch it is in (a served lane group's G*Lc rows would pick another
    algorithm than a lone request's Lc, and another rounding)."""
    return torch.stack([_linear(row.to(dtype), xkv) for row in ck], dim=1)


def _prompt_read(bp, x2, kv, cmask, n_heads: int):
    """One block's prompt cross-attention added to ``x2`` [B, Nl, D]: every
    latent token's query (``_ln(x2) @ xq``) reads the prompt's K/V ``kv``
    [B, Lc, 2D] (this block's rows of :func:`_prompt_kv`) under the key
    mask ``cmask`` [B, 1, 1, Lc] through the reference's plain attend, and
    ``xo`` projects the read. The null branch's zero tokens give zero V, so
    its read adds exactly 0.0."""
    B, Nl, D = x2.shape
    hd = D // n_heads
    xkv = kv.reshape(B, -1, 2, n_heads, hd)
    xq = _linear(_ln(x2), bp["xq"]).reshape(B, Nl, n_heads, hd)
    xatt = layers.attend(xq, xkv[:, :, 0], xkv[:, :, 1], mask=cmask)
    return x2 + _linear(xatt.reshape(B, Nl, D), bp["xo"])


def _blended_context(k, v, bk, bv, tok_start: int,
                     valid_tokens: Optional[int], n_real: int):
    """The context an ``attend_fn`` reads: copies of the buffers (they are
    published, shared state) with the slab's K/V written at ``tok_start``,
    the slab's rows past ``valid_tokens`` blended back to the buffer's
    rows, and the key mask of the scratch-padded layout (keys from
    ``n_real`` on; None without ``valid_tokens``). Returns (full_k, full_v,
    key_mask)."""
    Nl = k.shape[1]
    rows = slice(tok_start, tok_start + Nl)
    ku, vu, key_mask = k.to(bk.dtype), v.to(bv.dtype), None
    if valid_tokens is not None:
        fresh = (torch.arange(Nl, device=k.device) < valid_tokens)[None, :, None, None]
        ku = torch.where(fresh, ku, bk[:, rows])
        vu = torch.where(fresh, vu, bv[:, rows])
        key_mask = (torch.arange(bk.shape[1], device=k.device)
                    < n_real)[None, None, None, :]
    full_k, full_v = bk.clone(), bv.clone()
    full_k[:, rows] = ku
    full_v[:, rows] = vu
    return full_k, full_v, key_mask


def final_head(params, cfg: DiTConfig, h, c, rows_tok: int):
    """adaLN-zero output head: hidden states -> eps rows."""
    mod = _linear(c.to(h.dtype), params["final_mod_w"], params["final_mod_b"])
    sh, sc = mod.chunk(2, dim=-1)
    out = _linear(_modulate(_ln(h), sh, sc), params["final_proj"])
    return unpatchify(out, cfg.patch_size, rows_tok, cfg.tokens_per_side,
                      cfg.channels)


def forward_patch(params, cfg: DiTConfig, x_rows, t, cond, row_start: int,
                  buffers: Optional[Tuple] = None, return_kv: bool = True,
                  valid_tokens: Optional[int] = None, attend_fn=None,
                  frame=None, ctx_tokens: Optional[int] = None):
    """Denoise a row-patch with stale remote K/V.

    x_rows: [B, rows_local, W, C] latent slab (full width).
    buffers: None (local-only attention: exact when patch == full image)
             or (buf_k, buf_v) each [L, B, N_total, H, hd] — stale K/V for
             the WHOLE image; the local rows are read fresh instead. N_total
             may exceed the image's tokens: the video path passes its 2N
             (own ⊕ previous frame) context, whose first N rows take the
             fresh rows.
    row_start: first token-row of this patch (positional embeddings and the
             fresh rows' offset in the context).
    valid_tokens: the multi-rank executors' padded layout — number of REAL
             local tokens (the rest pads the slab to the largest patch);
             the buffers are then scratch-padded (see :func:`block_stack`).
    attend_fn: replaces every buffered attention read (see
             :func:`block_stack`).
    frame:   None (image) or the latent frame index (a number, or one a
             batch row), summed into the conditioning vector.
    ctx_tokens: the real context tokens of scratch-padded buffers (see
             :func:`block_stack`).
    cond:    class ids, or prompt tokens [B, Lc, cond_dim + 1] whose last
             channel is the validity mask (a text-conditioned config only):
             the tokens feed every block's cross-attention under that key
             mask, and the conditioning vector.
    Returns (eps_rows [B, rows_local, W, C], (fresh_k, fresh_v)
    [L,B,Nl,H,hd] or None).
    """
    rows_tok = x_rows.shape[1] // cfg.patch_size         # token rows in patch
    with spans.span("forward", batch=x_rows.shape[0],
                    tokens=valid_tokens or rows_tok * cfg.tokens_per_side):
        h, c = embed_patch(params, cfg, x_rows, t, cond, row_start,
                           frame=frame)
        tok_start = row_start * cfg.tokens_per_side
        prompt_ctx = None
        if getattr(cond, "ndim", 0) >= 3:
            if not cfg.cross_attn:
                raise ValueError(
                    "prompt-token cond needs DiTConfig.cross_attn=True "
                    "(see DiTConfig.text_conditioned())")
            cond = cond.to(h.device)
            prompt_ctx = (cond[..., :-1],
                          (cond[..., -1] > 0.5)[:, None, None, :])
        h, kvs = block_stack(params["blocks"], cfg, h, c, tok_start,
                             buffers=buffers, return_kv=return_kv,
                             valid_tokens=valid_tokens, attend_fn=attend_fn,
                             ctx_tokens=ctx_tokens, prompt_ctx=prompt_ctx)
        return final_head(params, cfg, h, c, rows_tok), kvs


def forward(params, cfg: DiTConfig, x, t, cond=None, frame=None):
    """Full-image denoiser: [B,H,W,C] -> eps [B,H,W,C] (the Origin path)."""
    eps, _ = forward_patch(params, cfg, x, t, cond, 0, buffers=None,
                           return_kv=False, frame=frame)
    return eps


def _conds(cond) -> torch.Tensor:
    """Prompt tokens (ndim >= 2) as they are, class ids as int32."""
    cond = torch.as_tensor(cond)
    return cond if cond.ndim >= 2 else cond.to(torch.int32)


def null_like(cond) -> torch.Tensor:
    """The unconditional branch of a cond of either kind: all-zero prompt
    tokens (the empty sequence, mask channel included) for tokens [B, L,
    Dc+1], the reserved :data:`NULL_COND` id in cond's shape for class
    ids."""
    cond = _conds(cond)
    if cond.ndim >= 2:
        return torch.zeros_like(cond)
    return torch.full_like(cond, NULL_COND)


def guidance_conds(cond) -> torch.Tensor:
    """Branch-stacked conds: row 0 the conditional branch, row 1 the
    unconditional one (:func:`null_like`); [2, B] for class ids [B], [2, B,
    L, Dc+1] for prompt tokens."""
    cond = _conds(cond)
    return torch.stack([cond, null_like(cond)])


def forward_patch_cfg(params, cfg: DiTConfig, x_rows, t, cond, row_start: int,
                      buffers: Optional[Tuple] = None, return_kv: bool = True,
                      valid_tokens: Optional[int] = None, branch_axis: int = 0,
                      frame=None, ctx_tokens: Optional[int] = None):
    """Both guidance branches of :func:`forward_patch` in ONE forward — the
    port's form of the reference's ``jax.vmap`` over the branch axis. The
    branches are folded into the batch: x (and a per-row ``t``) repeated to
    2B rows, the conds of :func:`guidance_conds` flattened to 2B, so every
    attention runs K1 once for both branches.

    buffers: None or branch-stacked (buf_k, buf_v) (branch 0 conditional):
    [2, L, B, N, H, hd] with ``branch_axis`` 0, the generate engines'
    layout, whose [2B, N, H, hd] layer read is a strided view at B = 1 and a
    copy at B > 1; or [L, 2, B, N, H, hd] with ``branch_axis`` 1, the
    serving engine's lane groups, whose read is a view at every B when the
    buffers are contiguous.
    valid_tokens: as in :func:`forward_patch`; both branches are fresh over
    the same rows, so the padded read runs K2 at batch 2B.
    frame, ctx_tokens: as in :func:`forward_patch`; a frame a batch row is
    repeated for the second branch like ``t``. Prompt tokens fold to [2B,
    L, Dc+1] (one prompt a row, or one for every row).
    Returns (eps2 [2, B, rows, W, C], branch-stacked fresh (k, v) in the
    buffers' layout — [2, L, B, Nl, H, hd] or [L, 2, B, Nl, H, hd] — or
    None)."""
    B = x_rows.shape[0]
    with spans.span("forward", batch=2 * B,
                    tokens=valid_tokens or (x_rows.shape[1] // cfg.patch_size
                                            * cfg.tokens_per_side)):
        conds = guidance_conds(cond).to(x_rows.device)
        if conds.ndim >= 4:                   # prompt tokens [2, B|1, L, Dc+1]
            rest = conds.shape[2:]
            conds = conds.expand(2, B, *rest).reshape(2 * B, *rest)
        else:
            conds = conds.reshape(2, -1).expand(2, B).reshape(2 * B)
        if isinstance(t, torch.Tensor) and t.dim():
            t = torch.cat([t.reshape(-1).expand(B)] * 2)
        if isinstance(frame, torch.Tensor) and frame.dim():
            frame = torch.cat([frame.reshape(-1).expand(B)] * 2)
        if buffers is not None:
            buffers = tuple(b.movedim(branch_axis, 1).flatten(1, 2)
                            for b in buffers)
        eps, kvs = forward_patch(params, cfg, torch.cat([x_rows, x_rows]),
                                 t, conds, row_start, buffers=buffers,
                                 return_kv=return_kv,
                                 valid_tokens=valid_tokens, frame=frame,
                                 ctx_tokens=ctx_tokens)
        if kvs is not None:
            kvs = tuple(k.unflatten(1, (2, B)).movedim(1, branch_axis)
                        for k in kvs)
        return eps.unflatten(0, (2, B)), kvs


def forward_cfg(params, cfg: DiTConfig, x, t, cond, scale):
    """Fused-batch classifier-free guidance over the full image, the guided
    "Origin": both branches in one forward, combined by the sampler's
    :func:`~repro_torch.core.sampler.cfg_combine` (as the reference's
    ``forward_cfg`` is)."""
    eps2, _ = forward_patch_cfg(params, cfg, x, t, cond, 0, return_kv=False)
    return sampler.cfg_combine(eps2[0], eps2[1], scale)


def buffer_shape(cfg: DiTConfig, batch: int):
    D, H = cfg.d_model, cfg.n_heads
    return (cfg.n_layers, batch, cfg.n_tokens, H, D // H)


def init_buffers(cfg: DiTConfig, batch: int, dtype=None, *, device):
    dt = dtype or _torch_dtype(cfg.dtype)
    shape = buffer_shape(cfg, batch)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))
