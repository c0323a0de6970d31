"""Selective SSM (Mamba-style) branch of Hymba's parallel heads (reference:
``repro.models.mamba``).

The scan runs kernel K7 through :func:`repro_torch.kernels.ops.ssm_scan` (its
plain version on CPU tensors); :func:`ssm_scan_ref` is the reference's exact
recurrence, kept for the tests.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models import layers


def d_inner(cfg) -> int:
    return cfg.d_model


def dt_rank(cfg) -> int:
    return max(8, cfg.d_model // 32)


def softplus(x):
    """``log(1 + exp(x))`` everywhere, as ``jax.nn.softplus``
    (``F.softplus`` switches to the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba(gen: torch.Generator, cfg):
    """The reference's leaves and dtypes: ``b_dt``, ``A_log`` and ``D_skip``
    are float32 whatever ``param_dtype`` is."""
    D = cfg.d_model
    Di, N, R = d_inner(cfg), cfg.ssm_state, dt_rank(cfg)
    dt = getattr(torch, cfg.param_dtype)
    dev = gen.device
    u = torch.rand(Di, generator=gen, device=dev)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    return {
        "w_in": layers.dense_init(gen, (D, 2 * Di), dt),              # x, z
        "conv": layers.dense_init(gen, (cfg.ssm_conv, Di), dt, scale=0.3),
        "w_bc": layers.dense_init(gen, (Di, 2 * N), dt),              # B_t, C_t
        "w_dt1": layers.dense_init(gen, (Di, R), dt),
        "w_dt2": layers.dense_init(gen, (R, Di), dt),
        "b_dt": torch.log(torch.expm1(torch.exp(log_dt))),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                        device=dev))[None, :].repeat(Di, 1),
        "D_skip": torch.ones(Di, dtype=torch.float32, device=dev),
        "w_out": layers.dense_init(gen, (Di, D), dt,
                                   scale=1.0 / math.sqrt(2 * cfg.n_layers * Di)),
    }


def init_state(cfg, batch: int, device=None):
    Di, N = d_inner(cfg), cfg.ssm_state
    return {"h": torch.zeros(batch, Di, N, dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, cfg.ssm_conv - 1, Di,
                                dtype=getattr(torch, cfg.dtype), device=device)}


def _proj(p, xb, cfg, conv_state):
    """xb: [B,S,D] pre-normed -> per-step SSM inputs (all fp32). The
    depthwise causal conv is the reference's sum over taps, in its order."""
    S = xb.shape[1]
    N = cfg.ssm_state
    x_br, z = layers.dense(xb, p["w_in"]).chunk(2, dim=-1)
    pad = torch.cat([conv_state.to(x_br.dtype), x_br], dim=1)
    w = p["conv"]
    W = w.shape[0]
    xc = F.silu(sum(pad[:, i:i + S] * w[i] for i in range(W)))
    new_conv = pad[:, -(W - 1):] if W > 1 else conv_state
    bc = layers.dense(xc, p["w_bc"]).float()
    B_t, C_t = bc[..., :N], bc[..., N:]                                # [B,S,N]
    delta = softplus(layers.dense(layers.dense(xc, p["w_dt1"]), p["w_dt2"]).float()
                     + p["b_dt"])
    A = -torch.exp(p["A_log"])                                         # [Di,N]
    return xc.float(), z, B_t, C_t, delta, A, new_conv


def ssm_scan_ref(xc, B_t, C_t, delta, A, D_skip, h0):
    """Exact recurrence in the reference's argument order. xc: [B,S,Di];
    B_t/C_t: [B,S,N]; delta: [B,S,Di]. Returns (y [B,S,Di], h_final
    [B,Di,N])."""
    return ref.ssm_scan_ref(xc, delta, B_t, C_t, A, D_skip, h0)


def mamba_forward(p, xb, cfg, state):
    """xb: [B,S,D] (pre-normed) -> (y [B,S,D], new state); the scan is K7,
    started from the state's ``h`` and returning the final one (under
    autograd its backward is the plain version's)."""
    xc, z, B_t, C_t, delta, A, new_conv = _proj(p, xb, cfg, state["conv"])
    y, h = ops.ssm_scan(xc, delta, B_t, C_t, A, p["D_skip"], h0=state["h"],
                        final_state=True)
    y = layers.dense(y.to(xb.dtype) * F.silu(z), p["w_out"])
    return y, {"h": h, "conv": new_conv}
