"""Small conv UNet denoiser (SDXL's architecture class, scaled down) — the
port of ``repro.models.diffusion.unet``.

Single-device quality wing only, as in the reference: STADI's distributed
path targets the DiT (DESIGN.md §2). Functional over the reference's
parameter tree (a dict whose ``down`` / ``up`` levels are lists, and whose
last ``downsample`` is None), with the reference's leaf layouts: convolution
kernels HWIO ``[kh, kw, Cin, Cout]``, dense weights ``[in, out]``. The
forward takes and returns ``[B, H, W, C]`` like the reference and runs NCHW
inside.

:func:`conv2d` is ``F.conv2d`` with the padding of XLA's "SAME" spelled out:
the total is ``max((ceil(H / s) - 1) s + k - H, 0)``, its smaller half
before. At stride 2 on an even input that is (0, 1) — one row after, none
before — not the symmetric (1, 1) of ``padding=1``, which would sample the
other phase of the grid. The attention block is the plain
:func:`repro_torch.models.layers.attend` (one head of C channels), as in
the reference: it has no kernel there, and its head dim (C, 64 at
``tiny-unet``'s attention level) is not one K1 is built for (32 and 72).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.diffusion import UNetConfig
from repro_torch.models import layers


def _torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _conv_init(gen: torch.Generator, shape, dtype):
    fan_in = shape[0] * shape[1] * shape[2]
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / math.sqrt(fan_in)).to(dtype)


def same_padding(size: int, kernel: int, stride: int):
    """XLA's "SAME" padding of one spatial axis as (before, after)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride: int = 1):
    """x: [B, Cin, H, W]; w: HWIO [kh, kw, Cin, Cout]; "SAME" padding."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = same_padding(x.shape[2], kh, stride)
    left, right = same_padding(x.shape[3], kw, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def group_norm(x, gamma, beta, groups: int = 8, eps: float = 1e-5):
    """x: [B, C, H, W]; min(groups, C) groups with float32 statistics
    (population variance), affine in the parameters' dtype."""
    B, C, H, W = x.shape
    g = min(groups, C)
    x32 = x.float().reshape(B, g, C // g, H, W)
    mu = x32.mean(dim=(2, 3, 4), keepdim=True)
    var = x32.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    x32 = (x32 - mu) * torch.rsqrt(var + eps)
    out = x32.reshape(B, C, H, W) * gamma[:, None, None] + beta[:, None, None]
    return out.to(x.dtype)


def _res_block_init(gen, cin, cout, temb_dim, dtype):
    p = {
        "gn1_g": torch.ones((cin,), dtype=dtype, device=gen.device),
        "gn1_b": torch.zeros((cin,), dtype=dtype, device=gen.device),
        "conv1": _conv_init(gen, (3, 3, cin, cout), dtype),
        "temb_w": layers.dense_init(gen, (temb_dim, cout), dtype),
        "gn2_g": torch.ones((cout,), dtype=dtype, device=gen.device),
        "gn2_b": torch.zeros((cout,), dtype=dtype, device=gen.device),
        # zero-init last conv
        "conv2": torch.zeros((3, 3, cout, cout), dtype=dtype, device=gen.device),
    }
    if cin != cout:
        p["skip"] = _conv_init(gen, (1, 1, cin, cout), dtype)
    return p


def _res_block(p, x, temb):
    h = F.silu(group_norm(x, p["gn1_g"], p["gn1_b"]))
    h = conv2d(h, p["conv1"])
    h = h + (F.silu(temb) @ p["temb_w"])[:, :, None, None]
    h = F.silu(group_norm(h, p["gn2_g"], p["gn2_b"]))
    h = conv2d(h, p["conv2"])
    skip = conv2d(x, p["skip"]) if "skip" in p else x
    return skip + h


def _attn_init(gen, c, dtype):
    return {"gn_g": torch.ones((c,), dtype=dtype, device=gen.device),
            "gn_b": torch.zeros((c,), dtype=dtype, device=gen.device),
            "qkv": layers.dense_init(gen, (c, 3 * c), dtype),
            "out": torch.zeros((c, c), dtype=dtype, device=gen.device)}


def _attn_block(p, x):
    B, C, H, W = x.shape
    h = group_norm(x, p["gn_g"], p["gn_b"]).flatten(2).transpose(1, 2)
    qkv = (h @ p["qkv"]).reshape(B, H * W, 3, 1, C)
    att = layers.attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    out = att.reshape(B, H * W, C) @ p["out"]
    return x + out.transpose(1, 2).reshape(B, C, H, W)


def init_params(gen: torch.Generator, cfg: UNetConfig):
    """Untrained UNet params drawn from ``gen`` on its device, in the
    reference's tree (its ``jax.random`` draws differ; tests carry the
    reference's params through :mod:`repro_torch.bridge`)."""
    dt = _torch_dtype(cfg.param_dtype)
    temb_dim = cfg.base_width * 4
    p = {
        "t_w1": layers.dense_init(gen, (256, temb_dim), dt),
        "t_w2": layers.dense_init(gen, (temb_dim, temb_dim), dt),
        "cond": layers.embed_init(gen, (cfg.n_classes, temb_dim), dt),
        "conv_in": _conv_init(gen, (3, 3, cfg.channels, cfg.base_width), dt),
        "down": [], "up": [],
    }
    widths = [cfg.base_width * m for m in cfg.channel_mults]
    cin = cfg.base_width
    for lvl, w in enumerate(widths):
        blocks = []
        for _ in range(cfg.n_res_blocks):
            blk = {"res": _res_block_init(gen, cin, w, temb_dim, dt)}
            if lvl in cfg.attn_levels:
                blk["attn"] = _attn_init(gen, w, dt)
            blocks.append(blk)
            cin = w
        p["down"].append({"blocks": blocks,
                          "downsample": _conv_init(gen, (3, 3, w, w), dt)
                          if lvl < len(widths) - 1 else None})
    p["mid1"] = _res_block_init(gen, cin, cin, temb_dim, dt)
    p["mid_attn"] = _attn_init(gen, cin, dt)
    p["mid2"] = _res_block_init(gen, cin, cin, temb_dim, dt)
    for lvl, w in reversed(list(enumerate(widths))):
        blocks = []
        for _ in range(cfg.n_res_blocks):
            blk = {"res": _res_block_init(gen, cin + w, w, temb_dim, dt)}
            if lvl in cfg.attn_levels:
                blk["attn"] = _attn_init(gen, w, dt)
            blocks.append(blk)
            cin = w
        p["up"].append({"blocks": blocks})
    p["gn_out_g"] = torch.ones((cin,), dtype=dt, device=gen.device)
    p["gn_out_b"] = torch.zeros((cin,), dtype=dt, device=gen.device)
    p["conv_out"] = torch.zeros((3, 3, cin, cfg.channels), dtype=dt,
                                device=gen.device)
    return p


def forward(params, cfg: UNetConfig, x, t, cond=None):
    """[B, H, W, C] -> eps [B, H, W, C]; ``t`` a number or one timestep a
    row, ``cond`` None or class ids broadcastable to [B]."""
    B = x.shape[0]
    dev = x.device
    t = torch.as_tensor(t, dtype=torch.float32, device=dev).expand(B)
    temb = layers.sinusoidal_embedding(t, 256).to(x.dtype)
    temb = F.silu(temb @ params["t_w1"]) @ params["t_w2"]
    if cond is not None:
        idx = torch.as_tensor(cond, device=dev).to(torch.int64).expand(B)
        temb = temb + params["cond"][idx]

    h = conv2d(x.permute(0, 3, 1, 2), params["conv_in"])
    skips = []
    for level in params["down"]:
        for blk in level["blocks"]:
            h = _res_block(blk["res"], h, temb)
            if "attn" in blk:
                h = _attn_block(blk["attn"], h)
        skips.append(h)
        if level["downsample"] is not None:
            h = conv2d(h, level["downsample"], stride=2)
    h = _res_block(params["mid1"], h, temb)
    h = _attn_block(params["mid_attn"], h)
    h = _res_block(params["mid2"], h, temb)
    for level in params["up"]:
        skip = skips.pop()
        if h.shape[2:] != skip.shape[2:]:
            # jax.image.resize's "nearest": source index floor((i + 0.5) s)
            h = F.interpolate(h, size=skip.shape[2:], mode="nearest-exact")
        h = torch.cat([h, skip], dim=1)
        for blk in level["blocks"]:
            h = _res_block(blk["res"], h, temb)
            if "attn" in blk:
                h = _attn_block(blk["attn"], h)
    h = F.silu(group_norm(h, params["gn_out_g"], params["gn_out_b"]))
    return conv2d(h, params["conv_out"]).permute(0, 2, 3, 1)
