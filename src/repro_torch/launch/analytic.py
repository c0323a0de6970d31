"""Analytic per-(arch x shape) FLOP and HBM-byte accounting (reference:
``repro.launch.analytic``), a framework-free copy over the port's configs.

Why this exists: a traced step's counts say what one device runs, not the
idealized perfectly-sharded work; the matmuls of every model are the port's
own, so exact matmul-level accounting is available analytically. The
roofline (``launch/roofline.py``) takes its compute and memory terms from
these numbers divided by the chip count, and keeps the dry-run's traced
counts beside them as the compiler-side view; the collective term comes
from the dry-run's recorded collectives.

Conventions:
  - flops: 2*M*N*K per matmul; backward = 2x forward; train = 3x forward.
  - bytes: every major intermediate read+written once in activation dtype
    (2 bytes bf16) + weight traffic once per step + optimizer traffic for
    train (3 reads + 2 writes x 4 bytes f32) - a one-pass HBM model.
  - naive attention materializes S x T scores (fp32): counted; the flash
    variant (``flash=True``, kernel K6 on the card) drops those terms.

``shape`` is a ``SHAPES`` name or a :class:`repro_torch.launch.shapes.
ShapeSpec`; with a name every number equals the reference's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.models import encdec as encdec_lib


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o):
        return Cost(self.flops + o.flops, self.bytes + o.bytes)

    def __mul__(self, k):
        return Cost(self.flops * k, self.bytes * k)

    __rmul__ = __mul__


def _mm(m, n, k, dtype_bytes=2):
    """One matmul: flops + (A + B + C) traffic."""
    return Cost(2.0 * m * n * k, dtype_bytes * (m * k + k * n + m * n))


def _attn(cfg, B, S, T, flash: bool):
    """QK^T + PV for H heads (scores fp32 when materialized)."""
    H, hd = cfg.n_heads, cfg.hd
    c = Cost(2.0 * B * H * S * T * hd * 2, 0.0)
    if flash:
        # streaming: read q,k,v + write o once
        c.bytes = 2.0 * B * (S + 2 * T + S) * H * hd
        return c
    # naive: scores + probs materialized in fp32 (write + read each)
    score_bytes = 4.0 * B * H * S * T
    c = Cost(c.flops, 2.0 * B * (S + 2 * T + S) * H * hd + 4 * score_bytes)
    return c


def _block_tokens(cfg, B, T, ctx, flash):
    """One decoder block over T tokens attending to ctx keys."""
    D, F = cfg.d_model, cfg.d_ff
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    BT = B * T
    c = _mm(BT, H * hd, D) + 2 * _mm(BT, K * hd, D) + _mm(BT, D, H * hd)
    c = c + _attn(cfg, B, T, ctx, flash)
    if cfg.n_experts:
        act = cfg.top_k + cfg.n_shared_experts
        c = c + _mm(BT, cfg.n_experts, D)                    # router
        c = c + 3 * act * _mm(BT, F, D)                      # swiglu experts
        # expert weights touched: top_k experts' weights stream per step
        c.bytes += 2.0 * 3 * min(cfg.n_experts, 256) * D * F / max(1, 1)
    else:
        n_mat = 3 if cfg.activation in ("swiglu", "geglu") else 2
        c = c + n_mat * _mm(BT, F, D)
    c.bytes += 2.0 * BT * D * 6                              # norms/residuals
    return c


def _head(cfg, B, T):
    return _mm(B * T, cfg.vocab, cfg.d_model)


def _ssm_block(cfg, B, T):
    """xLSTM mLSTM block (proj_factor inner width)."""
    D = cfg.d_model
    Di = int(cfg.proj_factor * D)
    H = cfg.n_heads
    dh = Di // H
    BT = B * T
    c = _mm(BT, 2 * Di, D) + 3 * _mm(BT, Di, Di) + _mm(BT, D, Di)
    # cell: C update (~4 * H*dh^2) + C q (2 H dh^2) per token, fp32 state
    c = c + Cost(6.0 * BT * H * dh * dh, 4.0 * BT * H * dh * dh / 64)
    c.bytes += 4.0 * B * H * dh * dh * 2 * min(T, 1)          # state r/w once
    return c


def _mamba_branch(cfg, B, T):
    D, N = cfg.d_model, cfg.ssm_state
    BT = B * T
    c = _mm(BT, 2 * D, D) + _mm(BT, 2 * N, D) + _mm(BT, D, D)
    c = c + Cost(6.0 * BT * D * N, 2.0 * BT * D * N / 16)     # recurrence
    return c


def _hybrid_block(cfg, B, T, ctx, flash):
    c = _block_tokens(cfg, B, T, min(ctx, cfg.sliding_window or ctx), flash)
    return c + _mamba_branch(cfg, B, T)


def _enc_block(cfg, B, T, flash):
    return _block_tokens(cfg, B, T, T, flash)


def params_bytes(cfg) -> float:
    return 2.0 * cfg.param_count()


def _weight_bytes(cfg, kind: str) -> float:
    return 2.0 * cfg.active_param_count() if kind == "decode" else params_bytes(cfg)


def streamed_weight_bytes(arch: str, shape) -> float:
    """The step's separate weight-streaming term in :func:`step_cost`'s
    bytes (3 forwards' worth in training). Each GEMM's bytes already read
    its weight, so the step's bytes less this term count every GEMM weight
    once; the reference's model, which this one equals, counts it twice."""
    s = _shape(shape)
    wb = _weight_bytes(get_config(arch), s.kind)
    return 3.0 * wb if s.kind == "train" else wb


def _shape(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def forward_cost(arch: str, shape, flash: bool = False) -> Cost:
    cfg = get_config(arch)
    s = _shape(shape)
    shape_name = s.name
    B, S = s.batch, s.seq
    fam = cfg.family
    kind = s.kind
    if kind == "decode":
        T = 1
        ctx = cfg.sliding_window or (cfg.long_context_window
                                     if shape_name == "long_500k" else S)
    else:
        T, ctx = S, S

    if fam == "ssm":
        c = cfg.n_layers * _ssm_block(cfg, B, T)
        c = c + _head(cfg, B, T)
    elif fam == "hybrid":
        c = cfg.n_layers * _hybrid_block(cfg, B, T + cfg.n_meta_tokens
                                         if kind != "decode" else T, ctx, flash)
        c = c + _head(cfg, B, T)
    elif fam == "encdec":
        St = encdec_lib.tgt_len_for(S) if kind != "decode" else 1
        if kind != "decode":
            c = cfg.n_enc_layers * _enc_block(cfg, B, S, flash)
        else:
            c = Cost()
        dec = _block_tokens(cfg, B, St, St if kind != "decode" else ctx, flash)
        dec = dec + _attn(cfg, B, St, S, flash)               # cross attention
        dec = dec + _mm(B * St, cfg.n_kv_heads * cfg.hd, cfg.d_model)
        c = c + cfg.n_layers * dec
        c = c + _head(cfg, B, St)
    else:                                                     # dense/moe/vlm
        Tv = T + (cfg.n_vision_tokens if fam == "vlm" and kind != "decode" else 0)
        c = cfg.n_layers * _block_tokens(cfg, B, Tv, ctx if kind == "decode" else Tv, flash)
        c = c + _head(cfg, B, Tv)
    # weights streamed once (MoE: only active experts' ffn weights)
    c.bytes += _weight_bytes(cfg, kind)
    # kv cache traffic for decode
    if kind == "decode" and fam not in ("ssm",):
        c.bytes += 2.0 * 2 * cfg.n_layers * B * ctx * cfg.n_kv_heads * cfg.hd
    return c


def step_cost(arch: str, shape, flash: bool = False) -> Cost:
    """Full step cost: train = fwd + bwd(2x) + optimizer traffic."""
    cfg = get_config(arch)
    s = _shape(shape)
    c = forward_cost(arch, s, flash)
    if s.kind == "train":
        c = Cost(3.0 * c.flops, 3.0 * c.bytes)
        n = cfg.param_count()
        c.bytes += 4.0 * n * (3 + 2)          # adam m/v/param r+w (f32)
        c.flops += 10.0 * n
    return c


def per_device(arch: str, shape, chips: int, flash: bool = False) -> Cost:
    c = step_cost(arch, shape, flash)
    return Cost(c.flops / chips, c.bytes / chips)
