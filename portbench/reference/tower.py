"""A frozen copy of the prompt tower the port conditions its text model on
(DESIGN.md section 17): whitespace words hashed by sha256 onto a 1024-word
vocabulary, padded to a power-of-two bucket (4 at least, ``cond_seq_len``
at most), embedded, given sinusoidal positions and run through two
pre-norm bidirectional blocks of width ``cond_dim``; the output carries a
last channel of 1.0 for a real token and 0.0 for padding, and padding is
zero. The tower's weights are drawn on the CPU from its own fixed seed, in
the tower's own order, so that this copy and the port hold the same
tower. Products go through a :class:`~.dit.Precision`.
"""
from __future__ import annotations

import hashlib
import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from . import dit

VOCAB = 1024
LAYERS = 2
HEADS = 4
MIN_BUCKET = 4
SEED = 1234


def token_ids(prompt: str, max_len: int) -> List[int]:
    out = []
    for w in prompt.strip().lower().split()[:max_len]:
        out.append(int.from_bytes(hashlib.sha256(w.encode("utf-8")).digest()[:4],
                                  "big") % VOCAB)
    return out


def bucket(n: int, cond_seq_len: int) -> int:
    b = MIN_BUCKET
    while b < max(n, 1):
        b *= 2
    return min(b, cond_seq_len)


def _dense(gen, shape, std):
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w * std


def weights(cond_dim: int, device):
    """The tower's weights: a fan-in truncated normal per block matrix
    (the output projections at 1 / sqrt(2 L fan_in)), then the embedding
    at 0.02, all from one CPU generator seeded SEED."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    D, Fd, L = cond_dim, 4 * cond_dim, LAYERS
    blocks = {
        "qkv": _dense(gen, (L, D, 3 * D), 1.0 / math.sqrt(D)),
        "wo": _dense(gen, (L, D, D), 1.0 / math.sqrt(2 * L * D)),
        "w1": _dense(gen, (L, D, Fd), 1.0 / math.sqrt(D)),
        "w2": _dense(gen, (L, Fd, D), 1.0 / math.sqrt(2 * L * Fd)),
    }
    embed = torch.randn((VOCAB, D), generator=gen) * 0.02
    return {"embed": embed.to(device),
            "blocks": {k: v.to(device) for k, v in blocks.items()}}


def _rms(x, eps: float = 1e-5):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def encode(prompts: Sequence[str], cond_dim: int, cond_seq_len: int,
           device, prec: dit.Precision = dit.FP32, W=None):
    """[B, L, cond_dim + 1] prompt tokens of ``prompts``, L the bucket of
    the longest."""
    W = W or weights(cond_dim, device)
    ids = [token_ids(p, cond_seq_len) for p in prompts]
    L = bucket(max(len(i) for i in ids), cond_seq_len)
    idx = torch.tensor([i + [0] * (L - len(i)) for i in ids], device=device)
    mask = torch.tensor([[1.0] * len(i) + [0.0] * (L - len(i)) for i in ids],
                        device=device)
    B, D, H = len(prompts), cond_dim, HEADS
    hd = D // H
    pos = torch.arange(L, dtype=torch.float32, device=device)
    h = W["embed"][idx] + dit.timestep_features(pos, D)[None]
    for i in range(LAYERS):
        bp = {k: v[i] for k, v in W["blocks"].items()}
        qkv = prec.mm(_rms(h), bp["qkv"]).reshape(B, L, 3, H, hd)
        att = dit.attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], prec,
                            mask=mask > 0.5)
        h = h + prec.mm(att.reshape(B, L, D), bp["wo"])
        h = h + prec.mm(F.gelu(prec.mm(_rms(h), bp["w1"]), approximate="tanh"),
                        bp["w2"])
    return torch.cat([h * mask[..., None], mask[..., None]], dim=-1)
