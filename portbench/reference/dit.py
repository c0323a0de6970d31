"""Plain float32 DiT denoiser (arXiv:2212.09748), the yardstick the
benchmark holds the port's images to.

Written from the paper's equations in plain PyTorch: adaLN-zero blocks of
self-attention and a GELU MLP over row-major patch tokens, a sin-cos 2-D
position embedding, a sinusoidal timestep MLP, a class embedding (id -1 is
the unconditional branch: a zero embedding) or, for a text-conditioned
model, a prompt cross-attention read in every block between self-attention
and the MLP plus the prompt's masked mean pooled into the conditioning
vector (PixArt-alpha's layout, arXiv:2310.00426). A patch forward reads
its own rows' keys and values fresh and every other row's from the stale
buffers it is given (DistriFusion's stale activations, STADI's Algorithm 1).

Every matrix product goes through a :class:`Precision`, which is exact
float32 for the reference and rounds both operands for the control
(float8 e4m3, or TF32's 10-bit mantissa). The reference imports nothing of
the program and takes no tensor the program made.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: the class id of the unconditional branch
NULL_CLASS = -1
#: key rows of one attention block of scores (bounds the scores' memory)
HEADS_PER_BLOCK = 4


class Precision:
    """How the matrix products round their operands: ``fp32`` (exact),
    ``fp8`` (each operand scaled by its largest magnitude to the e4m3
    range, rounded to float8 e4m3 and back) or ``tf32`` (each operand's
    mantissa rounded to 10 bits, to nearest even)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def round(self, x):
        if self.mode == "fp32":
            return x
        if self.mode == "tf32":
            i = x.contiguous().view(torch.int32)
            i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
            return i.view(torch.float32)
        amax = x.abs().amax()
        scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a, b):
        return self.round(a) @ self.round(b)


FP32 = Precision("fp32")


def layer_norm(x, eps: float = 1e-6):
    """Affine-free layer norm, population variance."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def timestep_features(t, dim: int = 256):
    """[B] timesteps -> [B, dim] sinusoidal features, cos half first."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def position_embedding(n: int, dim: int, device):
    """[n*n, dim] sin-cos 2-D embedding of a row-major n x n token grid:
    the first half of the channels the row's, the second the column's,
    each axis sin half first."""
    def axis(d):
        pos = torch.arange(n, dtype=torch.float32, device=device)
        omega = torch.exp(-math.log(10_000.0) * torch.arange(
            d // 2, dtype=torch.float32, device=device) / (d // 2))
        out = pos[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)
    e = axis(dim // 2)
    grid = torch.cat([e[:, None].expand(n, n, dim // 2),
                      e[None, :].expand(n, n, dim // 2)], dim=-1)
    return grid.reshape(n * n, dim)


def to_tokens(x, p: int):
    """[B, H, W, C] -> [B, (H/p)(W/p), p*p*C], row-major patches."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def from_tokens(tok, p: int, rows: int, cols: int, channels: int):
    B = tok.shape[0]
    x = tok.reshape(B, rows, cols, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, rows * p, cols * p, channels)


def attention(q, k, v, prec: Precision, mask=None):
    """softmax(q k^T / sqrt(hd)) v per head. q [B, S, H, hd]; k, v [B, T,
    H, hd]; mask [B, T] bool (True = attend) or None. A row whose keys are
    all masked reads uniform weights (the -1e30 fill), as over zero
    values it adds 0. Heads in blocks so that the scores fit."""
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    for h0 in range(0, H, HEADS_PER_BLOCK):
        hs = slice(h0, min(h0 + HEADS_PER_BLOCK, H))
        for b in range(B):
            qh = q[b, :, hs].transpose(0, 1)              # [h, S, hd]
            kh = k[b, :, hs].permute(1, 2, 0)             # [h, hd, T]
            vh = v[b, :, hs].transpose(0, 1)              # [h, T, hd]
            s = prec.mm(qh, kh) / math.sqrt(hd)
            if mask is not None:
                s = torch.where(mask[b][None, None], s,
                                torch.full_like(s, -1e30))
            out[b, :, hs] = prec.mm(torch.softmax(s, dim=-1), vh).transpose(0, 1)
    return out


def conditioning(P, cfg, t, cond, prec: Precision):
    """The adaLN conditioning vector c [B, D]: timestep MLP plus the class
    embedding (zero for NULL_CLASS) or the pooled prompt."""
    B = cond.shape[0]
    tt = torch.full((B,), float(t), device=P["t_w1"].device)
    temb = prec.mm(F.silu(prec.mm(timestep_features(tt), P["t_w1"])), P["t_w2"])
    if cond.dim() >= 2:                              # prompt tokens [B, L, Dc+1]
        toks, w = cond[..., :-1], cond[..., -1:]
        pooled = (toks * w).sum(1) / w.sum(1).clamp(min=1.0)
        cemb = prec.mm(pooled, P["ctx_pool"])
    else:
        ids = cond.long()
        cemb = P["cond_embed"][ids.clamp(min=0)] * (ids >= 0)[:, None].float()
    return F.silu(temb + cemb)


def forward(P, cfg, x_rows, t, cond, row_start: int, context=None,
            prec: Precision = FP32):
    """One denoiser evaluation of the token rows ``x_rows`` [B, rows, W, C]
    starting at latent token row ``row_start``, at timestep ``t``.

    context: None (the rows are the whole image and attend to themselves)
    or (k, v), each [L, B, N, H, hd]: the stale keys and values of the
    whole image, whose rows of this patch are replaced by the fresh ones.
    Returns (eps [B, rows, W, C], (k, v) fresh [L, B, Nl, H, hd])."""
    B = x_rows.shape[0]
    p, D, H = cfg["patch_size"], cfg["d_model"], cfg["n_heads"]
    hd = D // H
    side = cfg["latent_size"] // p
    tok = to_tokens(x_rows, p)
    Nl = tok.shape[1]
    start = row_start * side
    pe = position_embedding(side, D, x_rows.device)[start:start + Nl]
    x = prec.mm(tok, P["patch_embed"]) + P["patch_bias"] + pe
    c = conditioning(P, cfg, t, cond, prec)
    prompt = cond.dim() >= 2
    if prompt:
        ck, cmask = cond[..., :-1], cond[..., -1] > 0.5
    ks, vs = [], []
    B_ = P["blocks"]
    for i in range(cfg["n_layers"]):
        mod = prec.mm(c, B_["mod_w"][i]) + B_["mod_b"][i]
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        xn = layer_norm(x) * (1 + sc1[:, None]) + sh1[:, None]
        qkv = prec.mm(xn, B_["qkv"][i]).reshape(B, Nl, 3, H, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if context is None:
            kc, vc = k, v
        else:
            kc, vc = context[0][i].clone(), context[1][i].clone()
            kc[:, start:start + Nl] = k
            vc[:, start:start + Nl] = v
        att = attention(q, kc, vc, prec).reshape(B, Nl, D)
        x2 = x + g1[:, None] * prec.mm(att, B_["wo"][i])
        if prompt:
            kv = prec.mm(ck, B_["xkv"][i]).reshape(B, -1, 2, H, hd)
            xq = prec.mm(layer_norm(x2), B_["xq"][i]).reshape(B, Nl, H, hd)
            xa = attention(xq, kv[:, :, 0], kv[:, :, 1], prec, mask=cmask)
            x2 = x2 + prec.mm(xa.reshape(B, Nl, D), B_["xo"][i])
        xn = layer_norm(x2) * (1 + sc2[:, None]) + sh2[:, None]
        x = x2 + g2[:, None] * prec.mm(gelu_tanh(prec.mm(xn, B_["w1"][i])),
                                       B_["w2"][i])
        ks.append(k)
        vs.append(v)
    mod = prec.mm(c, P["final_mod_w"]) + P["final_mod_b"]
    sh, sc = mod.chunk(2, dim=-1)
    out = prec.mm(layer_norm(x) * (1 + sc[:, None]) + sh[:, None], P["final_proj"])
    eps = from_tokens(out, p, Nl // side, side, cfg["channels"])
    return eps, (torch.stack(ks), torch.stack(vs))


def null_like(cond):
    """The unconditional branch of a cond: NULL_CLASS ids, or the empty
    prompt (every channel zero, the mask too)."""
    if cond.dim() >= 2:
        return torch.zeros_like(cond)
    return torch.full_like(cond, NULL_CLASS)


def fp32_params(params, device) -> dict:
    """A float32 copy of a parameter tree on ``device``."""
    return {k: (fp32_params(v, device) if isinstance(v, dict)
                else v.to(device=device, dtype=torch.float32))
            for k, v in params.items()}
