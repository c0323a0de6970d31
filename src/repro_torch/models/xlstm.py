"""xLSTM (arXiv:2405.04517) of the port (reference: ``repro.models.xlstm``):
interleaved mLSTM (matrix memory) and sLSTM (scalar memory, recurrent
gating) blocks.

The recurrences are the reference's exact steps over time, with the
paper's max stabiliser, run as plain torch loops in float32 on weights of
any dtype: the reference computes them in ``lax.scan`` outside any Pallas
kernel, so the xLSTM brings no kernel. (The reference's docstring places a
chunkwise mLSTM in ``kernels/ssm_scan.py``; that kernel computes the Mamba
recurrence.)

Given DTensors (the dry-run), each recurrence runs on each rank's batch
and head shards (``repro_torch.sharding.shardwise``).

Blocks are heterogeneous (every ``slstm_every``-th is sLSTM), so the
parameters hold a list of per-block dicts and the state a list of
per-block states, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding.shardwise import FoldedLoop, shardwise


def _d_inner(cfg) -> int:
    return int(cfg.proj_factor * cfg.d_model)


def is_slstm(cfg, layer_idx: int) -> bool:
    return cfg.slstm_every > 0 and (layer_idx % cfg.slstm_every) == (cfg.slstm_every - 1)


# ----------------------------------------------------------------------
# params
# ----------------------------------------------------------------------

def init_mlstm_block(gen: torch.Generator, cfg):
    """The reference's leaves; ``w_if`` and ``b_if`` are float32 whatever
    ``param_dtype`` is."""
    D, Di, H = cfg.d_model, _d_inner(cfg), cfg.n_heads
    dt = getattr(torch, cfg.param_dtype)
    dev = gen.device
    return {
        "ln": torch.zeros(D, dtype=dt, device=dev),
        "w_up": layers.dense_init(gen, (D, 2 * Di), dt),          # x, z branches
        "conv": layers.dense_init(gen, (cfg.ssm_conv, Di), dt, scale=0.3),
        "wq": layers.dense_init(gen, (Di, Di), dt),
        "wk": layers.dense_init(gen, (Di, Di), dt),
        "wv": layers.dense_init(gen, (Di, Di), dt),
        "w_if": layers.dense_init(gen, (Di, 2 * H), torch.float32),
        "b_if": torch.cat([torch.zeros(H, device=dev),               # forget bias
                           torch.linspace(3.0, 6.0, H, device=dev)]),
        "w_down": layers.dense_init(gen, (Di, D), dt,
                                    scale=1.0 / math.sqrt(2 * cfg.n_layers * Di)),
    }


def init_slstm_block(gen: torch.Generator, cfg):
    """The reference's leaves; ``b`` is float32 whatever ``param_dtype``
    is."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    dt = getattr(torch, cfg.param_dtype)
    dev = gen.device
    return {
        "ln": torch.zeros(D, dtype=dt, device=dev),
        "w_x": layers.dense_init(gen, (D, 4 * D), dt),             # z,i,f,o from x
        "r_h": layers.dense_init(gen, (H, dh, 4 * dh), dt, scale=1.0 / math.sqrt(dh)),
        "b": torch.cat([torch.zeros(2 * D, device=dev),
                        torch.full((D,), 3.0, device=dev),
                        torch.zeros(D, device=dev)]),
        "w_down": layers.dense_init(gen, (D, D), dt,
                                    scale=1.0 / math.sqrt(2 * cfg.n_layers * D)),
    }


def init_params(gen: torch.Generator, cfg):
    """Random weights drawn from ``gen`` on its device, with the
    reference's leaf names, shapes and dtypes."""
    dt = getattr(torch, cfg.param_dtype)
    blocks: List[Dict[str, Any]] = [
        init_slstm_block(gen, cfg) if is_slstm(cfg, i) else init_mlstm_block(gen, cfg)
        for i in range(cfg.n_layers)]
    return {
        "embed": layers.embed_init(gen, (cfg.vocab, cfg.d_model), dt),
        "blocks": blocks,
        "ln_f": torch.zeros(cfg.d_model, dtype=dt, device=gen.device),
        "head": layers.dense_init(gen, (cfg.d_model, cfg.vocab), dt),
    }


# ----------------------------------------------------------------------
# mLSTM cell
# ----------------------------------------------------------------------

def mlstm_init_state(cfg, batch: int, device=None):
    Di, H = _d_inner(cfg), cfg.n_heads
    dh = Di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros(batch, H, dh, dh, **f32),
        "n": torch.zeros(batch, H, dh, **f32),
        "m": torch.full((batch, H), -1e30, **f32),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, Di,
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def _mlstm_cell_step(C, n, m, q, k, v, logi, logf):
    """One recurrence step. q, k, v: [B,H,dh]; logi, logf: [B,H]. Returns
    (C, n, m, h [B,H,dh])."""
    m_new = torch.maximum(logf + m, logi)
    decay = torch.exp(logf + m - m_new)
    inp = torch.exp(logi - m_new)
    C = decay[..., None, None] * C + inp[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = decay[..., None] * n + inp[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C, q)              # C q   (C = v k^T)
    den = torch.maximum(torch.einsum("bhi,bhi->bh", n, q).abs(), torch.exp(-m_new))
    return C, n, m_new, num / den[..., None]


def _mlstm_proj(p, xb, cfg, conv_state):
    """Projections of a block. xb: [B,S,D] (pre-normed). Returns (q, k, v
    [B,S,H,dh] f32, logi/logf [B,S,H] f32, z [B,S,Di], the new conv state:
    the last ``ssm_conv - 1`` projected inputs, so that a decode step
    continues a prefill's causal conv)."""
    S = xb.shape[1]
    Di, H = _d_inner(cfg), cfg.n_heads
    dh = Di // H
    x_br, z = layers.dense(xb, p["w_up"]).chunk(2, dim=-1)
    # causal depthwise conv over time (with carried state for decode)
    pad = torch.cat([conv_state.to(x_br.dtype), x_br], dim=1)
    w = p["conv"]                                      # [W, Di]
    W = w.shape[0]
    xc = F.silu(sum(pad[:, i:i + S] * w[i] for i in range(W)))
    new_conv = pad[:, -(W - 1):] if W > 1 else conv_state
    q = layers.split_heads(layers.dense(xc, p["wq"]), (H, dh)).float() / math.sqrt(dh)
    k = layers.split_heads(layers.dense(xc, p["wk"]), (H, dh)).float() / math.sqrt(dh)
    v = layers.split_heads(layers.dense(x_br, p["wv"]), (H, dh)).float()
    gates = layers.dense(xc.float(), p["w_if"]) + p["b_if"]
    logi, logf = gates[..., :H], layers.elementwise(F.logsigmoid, gates[..., H:])
    return q, k, v, logi, logf, z, new_conv


def mlstm_forward(p, x, cfg, state):
    """x: [B,S,D] -> (y [B,S,D], new state). Sequential over S."""
    xb = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v, logi, logf, z, new_conv = _mlstm_proj(p, xb, cfg, state["conv"])
    bh = (0, 2)                                        # [B, S, H, ...]
    hs, C, n, m = shardwise(
        _mlstm_scan, (q, k, v, logi, logf, state["C"], state["n"], state["m"]),
        (bh,) * 5 + ((0, 1),) * 3, (bh,) + ((0, 1),) * 3)
    h = layers.merge_heads(hs).to(x.dtype) * F.silu(z)
    return x + layers.dense(h, p["w_down"]), {"C": C, "n": n, "m": m, "conv": new_conv}


def _mlstm_scan(q, k, v, logi, logf, C, n, m):
    """The recurrence over the S steps: (h [B,S,H,dh], C, n, m)."""
    loop = FoldedLoop(q.shape[1], q)
    q, k, v, logi, logf, C, n, m = loop.enter(q, k, v, logi, logf, C, n, m)
    hs = []
    with loop:
        for t in loop.steps:
            C, n, m, h = _mlstm_cell_step(C, n, m, q[:, t], k[:, t], v[:, t],
                                          logi[:, t], logf[:, t])
            hs.append(h)
            C, n, m = loop.carry(C, n, m)
    hs = loop.stack(hs, 1)
    return (hs, *loop.leave(C, n, m))


# ----------------------------------------------------------------------
# sLSTM cell
# ----------------------------------------------------------------------

def slstm_init_state(cfg, batch: int, device=None):
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros(batch, H, dh, **f32)
    return {"c": z, "n": z, "h": z, "m": torch.full((batch, H, dh), -1e30, **f32)}


def _slstm_step(r_h, state, gx):
    """gx: [B,H,4*dh] f32, the step's input gates regrouped per head; r_h
    [H,dh,4*dh] f32. Returns (new state, h [B,H,dh])."""
    gh = torch.einsum("bhd,hde->bhe", state["h"], r_h)   # [B,H,4dh]
    zg, ig, fg, og = (gx + gh).chunk(4, dim=-1)        # each [B,H,dh]
    z = torch.tanh(zg)
    o = torch.sigmoid(og)
    logi = ig
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + state["m"], logi)
    i_s = torch.exp(logi - m_new)
    f_s = torch.exp(logf + state["m"] - m_new)
    c = f_s * state["c"] + i_s * z
    n = f_s * state["n"] + i_s
    h = o * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


def slstm_forward(p, x, cfg, state):
    """x: [B,S,D] -> (y [B,S,D], new state). The input gates of every step
    are one product (the reference takes ``x_t @ w_x`` a step); the
    recurrence is sequential over S."""
    D = x.shape[-1]
    H = cfg.n_heads
    dh = D // H
    xb = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    gx = layers.dense(xb, p["w_x"]) + p["b"].to(xb.dtype)           # [B,S,4D]
    # w_x packs gates as [z|i|f|o] each D wide = H*dh; regroup per head
    gx = layers.moved(layers.split_heads(gx.float(), (4, H, dh)), 2, 3)
    gx = layers.merge_heads(gx.transpose(2, 3))
    keys = ("c", "n", "h", "m")
    bh, st = (0, 2), (0, 1)
    hs, *new = shardwise(
        _slstm_scan, (gx, p["r_h"].float()) + tuple(state[k] for k in keys),
        (bh, (None, 0)) + (st,) * 4, (bh,) + (st,) * 4)
    hs = layers.merge_heads(hs).to(x.dtype)            # [B,S,D]
    return x + layers.dense(hs, p["w_down"]), dict(zip(keys, new))


def _slstm_scan(gx, r_h, c, n, h, m):
    """The recurrence over the S steps: (h [B,S,H,dh], c, n, h, m)."""
    loop = FoldedLoop(gx.shape[1], gx)
    gx, r_h, c, n, h, m = loop.enter(gx, r_h, c, n, h, m)
    state = {"c": c, "n": n, "h": h, "m": m}
    hs = []
    with loop:
        for t in loop.steps:
            state, h = _slstm_step(r_h, state, gx[:, t])
            hs.append(h)
            state = dict(zip(state, loop.carry(*state.values())))
    hs = loop.stack(hs, 1)
    return (hs, *loop.leave(state["c"], state["n"], state["h"], state["m"]))


# ----------------------------------------------------------------------
# model API
# ----------------------------------------------------------------------

def init_state(cfg, batch: int, device=None):
    """Per-block recurrent states (a list), each on ``device``."""
    return [slstm_init_state(cfg, batch, device) if is_slstm(cfg, i)
            else mlstm_init_state(cfg, batch, device)
            for i in range(cfg.n_layers)]


def forward(params, cfg, tokens, state=None, *, logits_last_only: bool = False):
    """tokens [B,S] -> (logits [B, S, V] (the last position only with
    ``logits_last_only``), the new per-block states)."""
    B = tokens.shape[0]
    if state is None:
        state = init_state(cfg, B, tokens.device)
    x = layers.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    new_states = []
    for i, p in enumerate(params["blocks"]):
        fwd = slstm_forward if is_slstm(cfg, i) else mlstm_forward
        x, st = fwd(p, x, cfg, state[i])
        x = layers.grad_as_value(x)
        new_states.append(st)
    if logits_last_only:
        x = x[:, -1:]
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return layers.dense(x, params["head"].to(x.dtype)), new_states


def loss_fn(params, cfg, batch):
    logits, _ = forward(params, cfg, batch["tokens"])
    return layers.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


def prefill(params, cfg, tokens, state=None):
    """Run the prompt; returns (logits of its last position [B, V], the
    states after it)."""
    logits, state = forward(params, cfg, tokens, state, logits_last_only=True)
    return logits[:, -1], state


def decode_step(params, cfg, state, token):
    """One token [B] -> (logits [B, V], the new states)."""
    logits, state = forward(params, cfg, token[:, None], state)
    return logits[:, 0], state
