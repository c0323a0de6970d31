"""AdamW — the port of ``repro.optim.adamw``: functional over the nested
containers of tensors of :mod:`repro_torch.tree` (a parameter tree in, a
new one out), with the reference's rules. ``torch.optim.AdamW`` is not
used: it decays every parameter and clips nothing.

- moments ``mu`` / ``nu`` in float32 whatever the parameter dtype;
- the update clipped to a global gradient norm of ``grad_clip`` first;
- bias correction ``1 - b ** count`` in float32;
- decoupled weight decay only on leaves with ndim >= 2 (not on biases,
  norms' gains or the modulation bias).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.sharding.shardwise import phase_mark


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": tree_lib.tree_map(zeros, params),
            "nu": tree_lib.tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32)}


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the global
    norm) — the sum of squares over the leaves in JAX's order, in float32."""
    gs = tree_lib.leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_lib.tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0
                 ) -> Tuple[Any, dict]:
    """One step: (new params, new state). ``lr_scale`` a number or a 0-d
    tensor (a schedule's value). The step count, the bias corrections and
    the learning rate are 0-d float32 tensors on the CPU, which enter the
    card's products as numbers (no copy, no synchronization). Each leaf's
    update closes a segment of the dry-run's memory
    (``shardwise.phase_mark``; nothing outside it)."""
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    count = state["count"] + 1
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** count.float()
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** count.float()
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)

    def upd(p, g, mu, nu):
        g32 = g.float()
        mu = cfg.b1 * mu + (1 - cfg.b1) * g32
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g32)
        step = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        p32 = p.float()
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p32
        newp = p32 - lr * step
        return newp.to(p.dtype), mu, nu

    flat_p = tree_lib.leaves(params)
    out = []
    for p, g, m, n in zip(flat_p, tree_lib.leaves(grads),
                          tree_lib.leaves(state["mu"]),
                          tree_lib.leaves(state["nu"])):
        out.append(upd(p, g, m, n))
        phase_mark()
    new_p = tree_lib.unflatten(params, [o[0] for o in out])
    new_mu = tree_lib.unflatten(params, [o[1] for o in out])
    new_nu = tree_lib.unflatten(params, [o[2] for o in out])
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}
