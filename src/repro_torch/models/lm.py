"""Decoder-only language models of the port (reference: ``repro.models.lm``):
dense (llama3 / yi / minitron / gemma), MoE (olmoe / deepseek-moe, through
:mod:`repro_torch.models.moe`) and VLM (internvl2: the dense decoder
reading stub ViT patch embeddings as a prefix).

Parameters keep the reference's stacked ``[L, ...]`` leaves; its
``jax.lax.scan`` over layers is a Python loop. Every prefill attention is
kernel K6 (``layers.self_attention``; a VLM's vision tokens are its
``prefix_len``), every decode attention the plain ``layers.
decode_attention``, as in the reference. The reference's ``_constrain``
(a JAX sharding constraint, a no-op without a mesh) is
``layers.constrain_residual``: a redistribution of a DTensor residual
stream at each block's entry when ``cfg.act_shard`` is set. On DTensors
a weight is gathered where it meets a split batch and the tokens stay
split (``layers.dense``, ``layers.embed``), as GSPMD partitions the
reference's FSDP-style weights.
``loss_fn`` is the training objective; under autograd K6's backward is
the plain version's.

Serving differs from the reference in two ways (ROADMAP.md queue 3): a
prompt longer than a ring cache leaves its kept positions where decode
reads them (``layers.ring_kv``; the reference keeps them in order, which
is right only when the prompt fills the ring a whole number of times), and
a VLM's windowed cache pins the vision tokens (:func:`_pinned` slots
before the ring, as Hymba pins its meta tokens), so that decode sees what
the windowed forward's prefix mask shows. Decode writes K/V in place, with
``pos`` a Python int.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, moe as moe_lib
from repro_torch.models.hymba import _layers, _stack


# ----------------------------------------------------------------------
# params
# ----------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg):
    """Random weights drawn from ``gen`` on its device, with the
    reference's leaf names, shapes and dtypes."""
    dt = getattr(torch, cfg.param_dtype)
    dev = gen.device

    def zeros():
        return torch.zeros(cfg.d_model, dtype=dt, device=dev)

    def init_block():
        block = {"ln1": zeros(), "attn": layers.init_attention(gen, cfg),
                 "ln2": zeros()}
        if cfg.n_experts:
            block["moe"] = moe_lib.init_moe(gen, cfg)
        else:
            block["mlp"] = layers.init_mlp(gen, cfg)
        return block

    params = {
        "embed": layers.embed_init(gen, (cfg.vocab, cfg.d_model), dt),
        "blocks": _stack([init_block() for _ in range(cfg.n_layers)]),
        "ln_f": zeros(),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    return params


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

def _embed(params, cfg, tokens, vision_embeds=None):
    x = layers.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    if cfg.arch_id.startswith("gemma"):
        # sqrt(d_model) in x's dtype (45.25 in bf16 at d_model 2048)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params, cfg, x):
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = layers.dense(x, head.to(x.dtype))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _ffn(p, xn, cfg):
    """The block's FFN: (out, the MoE's aux loss or 0)."""
    if cfg.n_experts:
        return moe_lib.moe_ffn(p["moe"], xn, cfg)
    return (layers.mlp(p["mlp"], xn, cfg.activation),
            torch.zeros((), dtype=torch.float32, device=xn.device))


def _block(p, x, cfg, *, window: int, prefix_len: int):
    x = layers.constrain_residual(x, cfg)
    h, kv = layers.self_attention(
        p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
        window=window, prefix_len=prefix_len)
    x = x + h
    h, aux = _ffn(p, layers.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + h, kv, aux


def forward(params, cfg, tokens, *, vision_embeds=None, window: int = 0,
            return_kv: bool = False, logits_last_only: bool = False):
    """tokens [B,S] -> (logits [B, S(+Nv), V] (the last position only with
    ``logits_last_only``), the summed MoE aux loss (fp32 scalar), stacked
    (k, v) [L, B, S(+Nv), K, hd] or None). window=0 => full causal
    attention; the vision tokens stay visible outside a window."""
    prefix_len = vision_embeds.shape[1] if vision_embeds is not None else 0
    x = _embed(params, cfg, tokens, vision_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for p in _layers(params["blocks"]):
        x, kv, a = _block(p, x, cfg, window=window,
                          prefix_len=prefix_len)
        x = layers.grad_as_value(x)
        aux = aux + a
        if return_kv:
            kvs.append(kv)
    if logits_last_only:
        x = x[:, -1:]
    kvs = ((torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
           if return_kv else None)
    return _logits(params, cfg, x), aux, kvs


def loss_fn(params, cfg, batch):
    """batch: tokens [B,S], labels [B,S] (+ vision_embeds for a VLM): the
    next-token cross entropy over the text positions, plus
    ``router_aux_coef`` times the MoE's load-balance loss."""
    ve = batch.get("vision_embeds")
    logits, aux, _ = forward(params, cfg, batch["tokens"], vision_embeds=ve)
    if ve is not None:
        logits = logits[:, ve.shape[1]:]   # loss on text positions only
    ce = layers.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return ce + cfg.router_aux_coef * aux if cfg.n_experts else ce


# ----------------------------------------------------------------------
# serving: prefill + decode with a KV cache
# ----------------------------------------------------------------------

def _pinned(cfg, window: int) -> int:
    """Slots pinned before a ring cache: a VLM's vision tokens (0 for the
    text decoders and for a full cache)."""
    return cfg.n_vision_tokens if window else 0


def init_cache(cfg, batch: int, max_len: int, *, window: int = 0, device=None):
    """window=0 => full cache of max_len slots; else the pinned slots
    (:func:`_pinned`) and a ring of ``window``. ``pos`` (the positions so
    far, vision tokens included) is a Python int."""
    T = (_pinned(cfg, window) + window) if window else max_len
    shape = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.hd)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device), "pos": 0}


def prefill(params, cfg, tokens, cache, *, vision_embeds=None, window: int = 0):
    """Run the prompt (behind ``vision_embeds``, which a VLM needs); returns
    (logits of its last position [B, V], the filled cache). A prompt that
    fits is written into the cache's K/V in place; a longer one keeps the
    pinned positions and its last positions in the ring, where decode
    expects them (``layers.ring_kv``)."""
    n_vis = vision_embeds.shape[1] if vision_embeds is not None else 0
    if window and n_vis != _pinned(cfg, window):
        raise ValueError(f"{cfg.arch_id}'s ring cache pins {_pinned(cfg, window)} "
                         f"vision tokens; the prefill got {n_vis}")
    logits, _, (k, v) = forward(params, cfg, tokens, vision_embeds=vision_embeds,
                                window=window, return_kv=True,
                                logits_last_only=True)
    S = k.shape[2]
    T = cache["k"].shape[2]
    if S >= T:
        if window:                      # the ring, as decode reads it
            P = _pinned(cfg, window)
            k, v = layers.ring_kv(k, T, P), layers.ring_kv(v, T, P)
        else:                           # a full cache too short: the last T,
            k, v = k[:, :, S - T:], v[:, :, S - T:]    # and decode raises
        cache = {**cache,
                 "k": layers.placed_like(k.to(cache["k"].dtype), cache["k"]),
                 "v": layers.placed_like(v.to(cache["v"].dtype), cache["v"])}
    else:
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
    return logits[:, -1], {**cache, "pos": S}


def decode_step(params, cfg, cache, token, *, window: int = 0):
    """token [B] -> (logits [B, V], the cache). The cache's K/V are updated
    in place (the reference returns new arrays); ``pos`` is replaced."""
    x = _embed(params, cfg, token[:, None])
    pos = cache["pos"]
    for i, p in enumerate(_layers(params["blocks"])):
        h = layers.decode_attention(
            p["attn"], layers.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
            cache["k"][i], cache["v"][i], pos, window=window,
            prefix_len=_pinned(cfg, window))
        x = x + h
        x = x + _ffn(p, layers.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)[0]
    logits = _logits(params, cfg, x)[:, 0]
    return logits, {**cache, "pos": pos + 1}
