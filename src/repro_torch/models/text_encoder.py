"""Frozen text-encoder stand-in: deterministic prompt tokens for the DiT —
the port of ``repro.models.text_encoder`` (DESIGN.md §17).

A text-to-image deployment runs a CLIP/T5 tower whose output, a ``[B, L,
D]`` sequence of prompt tokens, is what the denoiser cross-attends. This
module is that tower's scheduling stand-in: a hash-token embedding,
sinusoidal positions and a tiny frozen transformer, all drawn from one seed,
so every executor, rank and test sees the same prompt tokens for the same
prompt string. The tower's weights are a pure function of ``(cond_dim,
seed)``: they are drawn on the CPU from a ``torch.Generator`` and moved to
the device asked for, so the card and the CPU hold the same tower. The
values differ from the reference's ``jax.random`` draws (as the DiT's do);
tests carry the reference's tower through :mod:`repro_torch.bridge`.

Conventions the rest of the port relies on, as in the reference:

- :func:`encode` returns ``[B, L, cond_dim + 1]`` float32: the last channel
  is the validity mask (1.0 a real token, 0.0 bucket padding), and padded
  positions are zero in every channel.
- The guidance null branch is the EMPTY sequence: :func:`null_cond` is all
  zeros, mask included. Zero tokens project to zero K/V, so the DiT's
  cross-attention adds exactly 0.0 and the pooled conditioning vector is
  exactly 0.0 — the token-space image of the reserved ``NULL_COND`` class.
- Prompts are padded to power-of-two buckets (:func:`bucket_length`): each
  bucket is its own serving lane group and plan-cache key component.
"""
from __future__ import annotations

import functools
import hashlib
import math
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.diffusion import DiTConfig
from repro_torch.core.pipeline import resolve_device
from repro_torch.models import layers

#: hash-token vocabulary (open-vocabulary prompts fold onto it)
VOCAB = 1024
#: frozen-tower depth and heads (tiny on purpose: a latency- and
#: numerics-faithful stand-in, not a quality model)
N_LAYERS = 2
N_HEADS = 4
#: smallest prompt bucket (shorter prompts still pad to it)
MIN_BUCKET = 4
#: the one seed every process derives the frozen tower from
DEFAULT_SEED = 1234


def tokenize(prompt: str, max_len: int) -> List[int]:
    """Whitespace words, each hashed (sha256) onto the fixed VOCAB;
    truncated to ``max_len``. Stable across processes."""
    words = prompt.strip().lower().split()
    ids = []
    for w in words[:max_len]:
        h = hashlib.sha256(w.encode("utf-8")).digest()
        ids.append(int.from_bytes(h[:4], "big") % VOCAB)
    return ids


def bucket_length(n_tokens: int, cond_seq_len: int) -> int:
    """Smallest power-of-two bucket >= n_tokens (floor MIN_BUCKET, cap
    cond_seq_len): the serving batching axis."""
    if cond_seq_len < 1:
        raise ValueError("bucket_length needs cond_seq_len >= 1 "
                         f"(got {cond_seq_len}) — is cross_attn configured?")
    n = max(int(n_tokens), 1)
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, cond_seq_len)


@functools.lru_cache(maxsize=8)
def _tower(cond_dim: int, seed: int, device: str):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    D, Fd, L = cond_dim, 4 * cond_dim, N_LAYERS
    dt = torch.float32
    blocks = {
        "qkv": layers.dense_init(gen, (L, D, 3 * D), dt),
        "wo": layers.dense_init(gen, (L, D, D), dt,
                                scale=1.0 / math.sqrt(2 * L * D)),
        "w1": layers.dense_init(gen, (L, D, Fd), dt),
        "w2": layers.dense_init(gen, (L, Fd, D), dt,
                                scale=1.0 / math.sqrt(2 * L * Fd)),
    }
    return {"embed": layers.embed_init(gen, (VOCAB, D), dt).to(device),
            "blocks": {k: v.to(device) for k, v in blocks.items()}}


def frozen_params(cond_dim: int, seed: int = DEFAULT_SEED, device="cpu"):
    """The frozen tower's params, the reference's pytree: an embedding
    table and N_LAYERS pre-norm bidirectional blocks at width cond_dim,
    stacked ``[N_LAYERS, ...]`` under ``"blocks"``. Drawn on the CPU (so
    every device holds the same tower), moved to ``device``, cached."""
    return _tower(cond_dim, seed, str(torch.device(device)))


def _encode_ids(params, ids, mask, cond_dim: int):
    """[B, L] hash-token ids and [B, L] validity mask -> [B, L, cond_dim]
    prompt tokens, padded positions zero."""
    B, L = ids.shape
    D, H = cond_dim, N_HEADS
    hd = D // H
    pos = torch.arange(L, dtype=torch.float32, device=ids.device)
    h = params["embed"][ids.clamp(min=0)] \
        + layers.sinusoidal_embedding(pos, D)[None]
    key_mask = (mask > 0.5)[:, None, None, :]             # [B,1,1,L]
    zeros = torch.zeros(D, device=ids.device)
    for i in range(N_LAYERS):
        bp = {k: v[i] for k, v in params["blocks"].items()}
        qkv = (layers.rms_norm(h, zeros) @ bp["qkv"]).reshape(B, L, 3, H, hd)
        att = layers.attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                            mask=key_mask)
        h = h + att.reshape(B, L, D) @ bp["wo"]
        xn = layers.rms_norm(h, zeros)
        h = h + F.gelu(xn @ bp["w1"], approximate="tanh") @ bp["w2"]
    # zero the padding so a prompt's tokens do not depend on bucket junk
    return h * mask[..., None]


def _check_text_config(cfg: DiTConfig, hint: str) -> None:
    if not cfg.cross_attn or cfg.cond_seq_len < 1:
        raise ValueError(
            "prompt conditioning needs a text-conditioned model config "
            "(DiTConfig.cross_attn=True, cond_seq_len >= 1)" + hint)


def _tokens(tok_ids: Sequence[Sequence[int]], L: int, cfg: DiTConfig, seed,
            device) -> torch.Tensor:
    dev = resolve_device(device)
    ids = torch.tensor([t[:L] + [0] * (L - len(t[:L])) for t in tok_ids],
                       dtype=torch.int64, device=dev)
    mask = torch.tensor([[1.0] * len(t[:L]) + [0.0] * (L - len(t[:L]))
                         for t in tok_ids], dtype=torch.float32, device=dev)
    h = _encode_ids(frozen_params(cfg.cond_dim, seed, dev), ids, mask,
                    cfg.cond_dim)
    return torch.cat([h, mask[..., None]], dim=-1)


def encode(prompts: Union[str, Sequence[str]], cfg: DiTConfig, *,
           length: Optional[int] = None, seed: int = DEFAULT_SEED,
           device=None) -> torch.Tensor:
    """Encode prompt string(s) into ``[B, L, cond_dim + 1]`` cond tokens on
    ``device`` (``cuda`` unless given). ``length`` pins the bucket
    (default: :func:`bucket_length` of the longest prompt); the last
    channel is the validity mask.
    ``cond.ndim == 3`` is what tells every executor that a workload is
    prompt- rather than class-conditioned."""
    _check_text_config(cfg, " — see DiTConfig.text_conditioned()")
    if isinstance(prompts, str):
        prompts = [prompts]
    tok = [tokenize(p, cfg.cond_seq_len) for p in prompts]
    L = length or bucket_length(max((len(t) for t in tok), default=1),
                                cfg.cond_seq_len)
    if L > cfg.cond_seq_len:
        raise ValueError(f"bucket {L} exceeds cond_seq_len "
                         f"{cfg.cond_seq_len}")
    return _tokens(tok, L, cfg, seed, device)


def null_cond(batch: int, length: int, cfg: DiTConfig,
              device=None) -> torch.Tensor:
    """The guidance null branch: an EMPTY prompt sequence, every channel
    (the validity mask included) exactly zero."""
    return torch.zeros((batch, length, cfg.cond_dim + 1), dtype=torch.float32,
                       device=resolve_device(device))


def cond_tokens_from_ids(ids: Sequence[int], cfg: DiTConfig, *,
                         length: Optional[int] = None,
                         seed: int = DEFAULT_SEED,
                         device=None) -> torch.Tensor:
    """Encode raw hash-token ids (the ``--cond-tokens`` path) into one
    ``[1, L, cond_dim + 1]`` cond tensor."""
    ids = [int(i) % VOCAB for i in ids]
    if not ids:
        raise ValueError("--cond-tokens needs at least one token id")
    L = length or bucket_length(len(ids), cfg.cond_seq_len)
    _check_text_config(cfg, "")
    return _tokens([ids[:L]], L, cfg, seed, device)
