"""Mixture-of-Experts FFN of the port (OLMoE / DeepSeekMoE style; reference:
``repro.models.moe``): an fp32 router, ``top_k`` experts a token with their
gates renormalised, capacity-based dispatch (a batch row's expert queues
hold ``ceil(S * top_k / n_experts * capacity_factor)`` tokens each, filled
in the order of the flattened (token, k-slot) pairs; a pair past its
expert's capacity is dropped, not rerouted), the experts' gated MLPs, the
gate-weighted combine, optional shared experts and the Switch-style
load-balance loss.

The reference builds the dispatch as one-hot tensors (``[B, S, K, E, C]``
for the queue positions, 1.34 GB a layer in fp32 at olmoe-1b-7b's
2048-token prefill) and contracts them with einsums. The port computes the
same queue positions with a cumulative count and moves the tokens with
index copies and gathers: each kept (token, k-slot) pair lands in the same
(expert, position) cell, so the experts see the same inputs (a one-hot
contraction copies each token exactly). The expert products are plain
``torch.einsum``, as the reference leaves them to XLA outside any kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers


def init_moe(gen: torch.Generator, cfg, dtype=None):
    """Random weights drawn from ``gen`` on its device, with the reference's
    leaf names, shapes and dtypes (the router stays float32)."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": layers.dense_init(gen, (D, E), torch.float32),
        "experts": {
            "w_gate": layers.dense_init(gen, (E, D, F), dtype),
            "w_up": layers.dense_init(gen, (E, D, F), dtype),
            "w_down": layers.dense_init(gen, (E, F, D), dtype,
                                        scale=1.0 / math.sqrt(2 * cfg.n_layers * F)),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(gen, cfg, d_ff=cfg.n_shared_experts * F)
    return p


def _capacity(S: int, cfg) -> int:
    return max(1, int(math.ceil(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def route(p, x, cfg):
    """The router's decisions for x [B, S, D]: (probs [B, S, E] fp32, gate
    [B, S, K] renormalised, idx [B, S, K] the chosen experts in descending
    probability, pos [B, S, K] each pair's place in its expert's queue,
    keep [B, S, K] whether that place is within the capacity)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(layers.dense(x.float(), p["router"]), dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1, sorted=True)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # place of each (token, k-slot) in its expert's queue: the pairs before
    # it (s-major, then k) that chose the same expert
    sel = torch.nn.functional.one_hot(idx.reshape(B, S * K), E).to(torch.int32)
    before = torch.cumsum(sel, dim=1) - sel                   # [B, S*K, E]
    pos = before.gather(2, idx.reshape(B, S * K, 1)).reshape(B, S, K)
    return probs, gate, idx, pos, pos < _capacity(S, cfg)


def moe_ffn(p, x, cfg):
    """x: [B,S,D] -> (y [B,S,D], aux_loss scalar fp32)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(S, cfg)
    probs, gate, idx, pos, keep = route(p, x, cfg)

    # dispatch: each row's kept pairs into their (expert, place) cells, its
    # dropped pairs into one spare cell past them (then cut off); empty
    # cells 0. The shapes do not depend on the routing, so a trace of
    # shapes (the dry-run's meta tensors) runs it too.
    cell = torch.where(keep, idx * C + pos, E * C).reshape(B, S * K, 1)
    src = x[:, :, None].expand(B, S, K, D).reshape(B, S * K, D)
    xe = x.new_zeros(B, E * C + 1, D).scatter(1, cell.expand(B, S * K, D), src)
    xe = xe[:, :E * C].reshape(B, E, C, D)
    w = {k: layers.unshard(v, x) for k, v in p["experts"].items()}
    h = (torch.nn.functional.silu(torch.einsum("becd,edf->becf", xe, w["w_gate"]))
         * torch.einsum("becd,edf->becf", xe, w["w_up"]))
    ye = torch.einsum("becf,efd->becd", h, w["w_down"])           # [B,E,C,D]

    # combine: each token's kept pairs, weighted by their gates
    weight = torch.where(keep, gate, torch.zeros_like(gate)).to(ye.dtype)
    slot = (idx * C + pos.clamp_max(C - 1)).reshape(B, S * K, 1)
    picked = ye.reshape(B, E * C, D).gather(1, slot.expand(B, S * K, D))
    y = torch.einsum("bsk,bskd->bsd", weight, picked.reshape(B, S, K, D))

    if cfg.n_shared_experts:
        y = y + layers.mlp(p["shared"], x, cfg.activation)

    # load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e
    routed = torch.zeros(B, S, E, device=x.device).scatter_add(
        2, idx, keep.float())
    frac_tokens = routed.reshape(B * S, E).mean(0)
    frac_probs = probs.reshape(B * S, E).mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs) / K
    return y, aux
