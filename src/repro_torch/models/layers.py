"""Shared neural building blocks of the port, the DiT subset (reference:
``repro.models.layers``): parameter init helpers drawing from an explicit
``torch.Generator``, the reference attention and the timestep embedding."""
from __future__ import annotations

import math
from typing import Optional

import torch


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
# attention core (reference path; the CUDA kernels live in repro_torch.kernels)
# ----------------------------------------------------------------------

def attend(q, k, v, *, mask=None, scale: Optional[float] = None):
    """q: [B,S,H,hd]; k,v: [B,T,K,hd] with K | H. mask: broadcastable
    [B,1,S,T] bool. Returns [B,S,H,hd]. fp32 softmax; the probabilities are
    cast to v's dtype before the product, as in the JAX reference."""
    H, hd = q.shape[2], q.shape[3]
    K = k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


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
