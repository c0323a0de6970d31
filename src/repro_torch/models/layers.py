"""Shared neural building blocks of the port (reference:
``repro.models.layers``): parameter init helpers drawing from an explicit
``torch.Generator``, RMS norm, rotary embeddings, the reference attention
and its masks, the attention block of the language models (whose
full-sequence attention runs kernel K6 through
``repro_torch.kernels.ops.flash_attention``), the gated MLPs and the
timestep embedding. The reference's ``models/attention.py``
(``chunked_attend``, its CPU stand-in for the flash kernel) has no
counterpart here: K6 and its plain version take both ``attn_impl`` values,
and the tests use ``chunked_attend`` as an oracle."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops


# ----------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------

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
    float32 and cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + weight.float())
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
    cast to v's dtype before the product, as in the JAX reference."""
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
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
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
    Returns (out [B, S, D], (k, v) [B, S, K, hd])."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = attention_qkv(p, x, cfg, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              prefix_len=prefix_len)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


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
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    if activation == "geglu":
        h = torch.nn.functional.gelu(gate, approximate="tanh") * up
    else:
        h = torch.nn.functional.silu(gate) * up
    return h @ p["w_down"]


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
