"""Hymba (arXiv:2411.13676) forward and serving path of the port
(reference: ``repro.models.hymba``): each block runs attention heads and SSM
(Mamba) heads IN PARALLEL on the same input and fuses the branch outputs
(mean of per-branch RMS-normed outputs, learned scales). ``n_meta_tokens``
learnable meta tokens are prepended to every sequence and stay attendable
outside the sliding window.

The prefill's attention is kernel K6 (``layers.self_attention`` with
``prefix_len = n_meta_tokens``) and every Mamba branch runs kernel K7; the
decode attention over the meta-pinned ring cache is the plain ``attend``,
as in the reference. Parameters keep the reference's stacked ``[L, ...]``
leaves; the reference's ``jax.lax.scan`` over layers is a Python loop. The
reference's ``lm._constrain`` is ``layers.constrain_residual`` (DTensor
runs with ``act_shard`` set only). ``loss_fn`` trains through K6 and
K7 under autograd (their backward the plain versions'). A prompt longer
than the ring leaves its kept positions where decode reads them
(``layers.ring_kv``), which the reference does only when the prompt fills
the ring a whole number of times (ROADMAP.md queue 3).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, mamba as mamba_lib


def _layers(tree):
    """The per-layer trees of a stacked ``[L, ...]`` tree (views), from one
    ``unbind`` of each leaf. Under autograd a leaf's gradient is then one
    stack of its L layer gradients, where indexing each leaf layer by layer
    writes a whole-stack gradient for every layer: L times the stack's
    bytes in the backward."""
    parts = {k: _layers(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _stack(trees):
    """Per-layer trees -> one stacked ``[L, ...]`` tree."""
    return {k: (_stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees]))
            for k in trees[0]}


def init_params(gen: torch.Generator, cfg):
    """Random weights drawn from ``gen`` on its device, with the
    reference's leaf names, shapes and dtypes."""
    dt = getattr(torch, cfg.param_dtype)
    dev = gen.device

    def zeros():
        return torch.zeros(cfg.d_model, dtype=dt, device=dev)

    def init_block():
        return {
            "ln1": zeros(),
            "attn": layers.init_attention(gen, cfg),
            "mamba": mamba_lib.init_mamba(gen, cfg),
            "fuse_a": zeros(),
            "fuse_m": zeros(),
            "ln2": zeros(),
            "mlp": layers.init_mlp(gen, cfg),
        }

    return {
        "embed": layers.embed_init(gen, (cfg.vocab, cfg.d_model), dt),
        "meta": layers.embed_init(gen, (cfg.n_meta_tokens, cfg.d_model), dt),
        "blocks": _stack([init_block() for _ in range(cfg.n_layers)]),
        "ln_f": zeros(),
        "head": layers.dense_init(gen, (cfg.d_model, cfg.vocab), dt),
    }


def _fuse(p, x, attn_out, ssm_out, cfg):
    """The residual update of one block from its two branch outputs."""
    fused = 0.5 * (layers.rms_norm(attn_out, p["fuse_a"], cfg.norm_eps) +
                   layers.rms_norm(ssm_out, p["fuse_m"], cfg.norm_eps))
    x = x + fused
    return x + layers.mlp(p["mlp"], layers.rms_norm(x, p["ln2"], cfg.norm_eps),
                          cfg.activation)


def _block(p, x, cfg, ssm_state, *, window: int):
    x = layers.constrain_residual(x, cfg)
    xn = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, kv = layers.self_attention(p["attn"], xn, cfg, window=window,
                                         prefix_len=cfg.n_meta_tokens)
    ssm_out, new_state = mamba_lib.mamba_forward(p["mamba"], xn, cfg, ssm_state)
    return _fuse(p, x, attn_out, ssm_out, cfg), kv, new_state


def _stacked_state(cfg, batch: int, device):
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in mamba_lib.init_state(cfg, batch, device).items()}


def forward(params, cfg, tokens, ssm_states=None, *, window: int = None,
            return_kv: bool = False, logits_last_only: bool = False):
    """tokens [B,S] -> (logits over the S positions, meta stripped (the last
    one only with ``logits_last_only``), stacked (k, v) [L, B, M+S, K, hd]
    or None, stacked new SSM states)."""
    B, S = tokens.shape
    window = cfg.sliding_window if window is None else window
    if ssm_states is None:
        ssm_states = _stacked_state(cfg, B, tokens.device)
    x = layers.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    meta = layers.unshard(params["meta"], tokens)
    meta = meta[None].expand((B,) + meta.shape).to(x.dtype)
    x = torch.cat([meta, x], dim=1)

    kvs, states = [], []
    for p, st0 in zip(_layers(params["blocks"]), _layers(ssm_states)):
        x, kv, st = _block(p, x, cfg, st0, window=window)
        x = layers.grad_as_value(x)
        if return_kv:
            kvs.append(kv)
        states.append(st)
    x = x[:, -1:] if logits_last_only else x[:, cfg.n_meta_tokens:]
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    kvs = ((torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
           if return_kv else None)
    return layers.dense(x, params["head"].to(x.dtype)), kvs, _stack(states)


def loss_fn(params, cfg, batch):
    """batch: tokens [B,S], labels [B,S]: the next-token cross entropy."""
    logits, _, _ = forward(params, cfg, batch["tokens"])
    return layers.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, window: int = 0, device=None):
    """window=0 => full cache of max_len+meta; else meta-pinned ring cache
    of meta+window slots. ``pos`` (meta plus tokens so far) is a Python
    int, so the ring's slot is computed on the host."""
    M = cfg.n_meta_tokens
    T = (M + window) if window else (M + max_len)
    kv_shape = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.hd)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(kv_shape, dtype=dt, device=device),
            "v": torch.zeros(kv_shape, dtype=dt, device=device),
            "ssm": _stacked_state(cfg, batch, device), "pos": 0}


def prefill(params, cfg, tokens, cache, *, window: int = 0):
    """Run the prompt; returns (logits of its last position [B, V], the
    filled cache). A prompt that fits is written into the cache's K/V in
    place; one longer than the ring keeps the meta tokens and its last
    ``T - M`` positions, position p at ring slot ``M + (p - M) % (T - M)``
    as decode expects it."""
    logits, (k, v), ssm = forward(params, cfg, tokens, return_kv=True,
                                  window=window or cfg.sliding_window,
                                  logits_last_only=True)
    M = cfg.n_meta_tokens
    T = cache["k"].shape[2]
    S_tot = k.shape[2]
    if S_tot > T:                                     # ring: meta + last (T-M)
        cache = {**cache, "k": layers.placed_like(
                     layers.ring_kv(k, T, M).to(cache["k"].dtype), cache["k"]),
                 "v": layers.placed_like(
                     layers.ring_kv(v, T, M).to(cache["v"].dtype), cache["v"])}
    else:                                             # written in place
        cache["k"][:, :, :S_tot] = k
        cache["v"][:, :, :S_tot] = v
    return logits[:, -1], {**cache, "ssm": ssm, "pos": S_tot}


def decode_step(params, cfg, cache, token, *, window: int = 0):
    """One token [B] -> (logits [B, V], the cache). The cache's K/V are
    updated in place (the reference returns new arrays); its SSM states and
    ``pos`` are replaced."""
    x = layers.embed(params["embed"], token[:, None]).to(getattr(torch, cfg.dtype))
    pos = cache["pos"]
    states = []
    for i, (p, st0) in enumerate(zip(_layers(params["blocks"]),
                                     _layers(cache["ssm"]))):
        xn = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        # the meta-pinned ring: the meta tokens are the pinned prefix
        a = layers.decode_attention(p["attn"], xn, cfg, cache["k"][i],
                                    cache["v"][i], pos, window=window,
                                    prefix_len=cfg.n_meta_tokens)
        m, st = mamba_lib.mamba_forward(p["mamba"], xn, cfg, st0)
        x = _fuse(p, x, a, m, cfg)
        states.append(st)
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = layers.dense(x, params["head"].to(x.dtype))[:, 0]
    return logits, {**cache, "ssm": _stack(states), "pos": pos + 1}
