"""Encoder-decoder backbone of the port (SeamlessM4T-medium text/speech-to-
text; reference: ``repro.models.encdec``).

The speech frontend is a stub: the encoder consumes precomputed frame
embeddings [B, S_src, D]. The encoder's attention is bidirectional and the
decoder's cross-attention reads K/V precomputed once from the encoder's
output: both run kernel K6 in its non-causal form
(``layers.bidirectional_attention``, ``layers.cross_attention``; the
decode's cross read too, at one query row). The decoder's self-attention
is K6's causal form at prefill and the plain ``layers.decode_attention``
at decode, as in ``lm``. Layers are stacked ``[L, ...]``; the reference's
``jax.lax.scan`` over layers is a Python loop.

A target prompt longer than a ring cache leaves its kept positions where
decode reads and writes them (``layers.ring_kv``): the reference keeps them
in order (``repro.models.encdec.prefill``), which is right only when the
ring divides the prompt (ROADMAP.md queue 3). A full-cache decode past the
cache's end raises.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.hymba import _layers, _stack
from repro_torch.sharding.shardwise import phase_mark


def tgt_len_for(src_len: int) -> int:
    """Convention: training/prefill target length = src_len // 4 (speech:text)."""
    return max(16, src_len // 4)


def init_params(gen: torch.Generator, cfg):
    """Random weights drawn from ``gen`` on its device, with the
    reference's leaf names, shapes and dtypes."""
    dt = getattr(torch, cfg.param_dtype)
    dev = gen.device

    def zeros():
        return torch.zeros(cfg.d_model, dtype=dt, device=dev)

    def init_enc_block():
        return {"ln1": zeros(), "attn": layers.init_attention(gen, cfg),
                "ln2": zeros(), "mlp": layers.init_mlp(gen, cfg)}

    def init_dec_block():
        return {"ln1": zeros(), "attn": layers.init_attention(gen, cfg),
                "lnx": zeros(), "xattn": layers.init_attention(gen, cfg),
                "ln2": zeros(), "mlp": layers.init_mlp(gen, cfg)}

    return {
        "enc_blocks": _stack([init_enc_block() for _ in range(cfg.n_enc_layers)]),
        "dec_blocks": _stack([init_dec_block() for _ in range(cfg.n_layers)]),
        "embed": layers.embed_init(gen, (cfg.vocab, cfg.d_model), dt),
        "enc_ln_f": zeros(),
        "dec_ln_f": zeros(),
        "head": layers.dense_init(gen, (cfg.d_model, cfg.vocab), dt),
    }


def encode(params, cfg, src_embeds):
    """src_embeds [B,Ss,D] (stub frontend output) -> memory [B,Ss,D]."""
    x = src_embeds.to(getattr(torch, cfg.dtype))
    for p in _layers(params["enc_blocks"]):
        x = layers.constrain_residual(x, cfg)
        x = x + layers.bidirectional_attention(
            p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
        x = layers.grad_as_value(x + layers.mlp(
            p["mlp"], layers.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.activation))
    return layers.rms_norm(x, params["enc_ln_f"], cfg.norm_eps)


def cross_kv(params, cfg, memory):
    """Each decoder layer's cross-attention K/V of ``memory``, stacked:
    (k, v) [L,B,Ss,K,hd]."""
    ks, vs = [], []
    for blk in _layers(params["dec_blocks"]):
        p = blk["xattn"]
        ks.append(layers.split_heads(layers.dense(memory, p["wk"]),
                                     (cfg.n_kv_heads, cfg.hd)))
        vs.append(layers.split_heads(layers.dense(memory, p["wv"]),
                                     (cfg.n_kv_heads, cfg.hd)))
    return torch.stack(ks), torch.stack(vs)


def _dec_block(p, x, cfg, mem_kv, *, window: int = 0):
    x = layers.constrain_residual(x, cfg)
    h, kv = layers.self_attention(p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps),
                                  cfg, window=window)
    x = x + h
    x = x + layers.cross_attention(p["xattn"], layers.rms_norm(x, p["lnx"], cfg.norm_eps),
                                   mem_kv, cfg)
    x = x + layers.mlp(p["mlp"], layers.rms_norm(x, p["ln2"], cfg.norm_eps),
                       cfg.activation)
    return x, kv


def _logits(params, cfg, x):
    x = layers.rms_norm(x, params["dec_ln_f"], cfg.norm_eps)
    return layers.dense(x, params["head"].to(x.dtype))


def decode_forward(params, cfg, tgt_tokens, memory, *, window: int = 0,
                   return_kv: bool = False, logits_last_only: bool = False):
    """tgt_tokens [B,St] over ``memory`` -> (logits [B, St, V] (the last
    position only with ``logits_last_only``), the self-attention's stacked
    (k, v) [L,B,St,K,hd] or None, the cross K/V (:func:`cross_kv`))."""
    mk, mv = cross_kv(params, cfg, memory)
    x = layers.embed(params["embed"], tgt_tokens).to(getattr(torch, cfg.dtype))
    kvs = []
    for i, p in enumerate(_layers(params["dec_blocks"])):
        x, kv = _dec_block(p, x, cfg, (mk[i], mv[i]), window=window)
        x = layers.grad_as_value(x)
        if return_kv:
            kvs.append(kv)
    if logits_last_only:
        x = x[:, -1:]
    kvs = ((torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
           if return_kv else None)
    return _logits(params, cfg, x), kvs, (mk, mv)


def loss_fn(params, cfg, batch):
    """batch: src_embeds [B,Ss,D], tgt_tokens [B,St], labels [B,St]."""
    memory = encode(params, cfg, batch["src_embeds"])
    phase_mark()
    logits, _, _ = decode_forward(params, cfg, batch["tgt_tokens"], memory)
    return layers.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, src_len: int, *, window: int = 0,
               device=None):
    """Self-attention K/V of ``window`` (a ring) or ``max_len`` slots, the
    cross K/V of ``src_len`` memory rows; ``pos`` (target positions so
    far) a Python int."""
    T = window if window else max_len
    dt = getattr(torch, cfg.dtype)
    kv = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.hd)
    mem = (cfg.n_layers, batch, src_len, cfg.n_kv_heads, cfg.hd)
    z = dict(dtype=dt, device=device)
    return {"k": torch.zeros(kv, **z), "v": torch.zeros(kv, **z),
            "mem_k": torch.zeros(mem, **z), "mem_v": torch.zeros(mem, **z),
            "pos": 0}


def prefill(params, cfg, src_embeds, tgt_tokens, cache, *, window: int = 0):
    """Encode the source and run the target prompt; returns (logits of its
    last position [B, V], the filled cache). A prompt that fits is written
    into the cache's K/V in place; a longer one keeps its last positions
    where decode expects them (ring slot ``p % T``; ``layers.ring_kv``).
    The cross K/V replace the cache's."""
    memory = encode(params, cfg, src_embeds)
    phase_mark()
    logits, (k, v), (mk, mv) = decode_forward(params, cfg, tgt_tokens, memory,
                                              window=window, return_kv=True,
                                              logits_last_only=True)
    S = k.shape[2]
    T = cache["k"].shape[2]
    if S >= T:
        if window:                      # the ring, as decode reads it
            k, v = layers.ring_kv(k, T), layers.ring_kv(v, T)
        else:                           # a full cache too short: the last T,
            k, v = k[:, :, S - T:], v[:, :, S - T:]    # and decode raises
        cache = {**cache,
                 "k": layers.placed_like(k.to(cache["k"].dtype), cache["k"]),
                 "v": layers.placed_like(v.to(cache["v"].dtype), cache["v"])}
    else:
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
    dt = cache["mem_k"].dtype
    return logits[:, -1], {
        **cache, "mem_k": layers.placed_like(mk.to(dt), cache["mem_k"]),
        "mem_v": layers.placed_like(mv.to(dt), cache["mem_v"]), "pos": S}


def decode_step(params, cfg, cache, token, *, window: int = 0):
    """token [B] -> (logits [B, V], the cache). The self-attention K/V are
    updated in place (the reference returns new arrays); ``pos`` is
    replaced."""
    x = layers.embed(params["embed"], token[:, None]).to(getattr(torch, cfg.dtype))
    pos = cache["pos"]
    for i, p in enumerate(_layers(params["dec_blocks"])):
        x = x + layers.decode_attention(
            p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
            cache["k"][i], cache["v"][i], pos, window=window)
        x = x + layers.cross_attention(
            p["xattn"], layers.rms_norm(x, p["lnx"], cfg.norm_eps),
            (cache["mem_k"][i], cache["mem_v"][i]), cfg)
        x = x + layers.mlp(p["mlp"], layers.rms_norm(x, p["ln2"], cfg.norm_eps),
                           cfg.activation)
    return _logits(params, cfg, x)[:, 0], {**cache, "pos": pos + 1}
