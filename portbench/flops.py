"""The yardstick's arithmetic: the chip's peaks, the operations a DiT
forward needs, and the operations and bytes of the stale-K/V attention
kernels (K1, K2), each computed from shapes.

A forward of B rows of Nl query tokens over an N-token context, L blocks
of width D and MLP width F, counts per token and block 2 (3D^2 + D^2 + 2DF)
for the projections and MLP and 4 N D for the scores and the weighted
values; a prompt read of Lc tokens adds 4 D^2 + 4 Lc D a token and
2 Dc 2D Lc a row; the adaLN, timestep, embedding and head products are
counted too. A multiply-add is two operations.

A kernel's least time is the larger of its operations at the bf16 peak
and its bytes at the memory peak, with each input byte read once and each
output byte written once: the query, fresh key and value and output rows
of the Nl real queries, and the stale key and value rows of the other
N - Nl context tokens (the kernel reads the fresh rows in their place).
"""
from __future__ import annotations

from typing import Optional

#: published dense peaks of the SXM part (NVIDIA's data sheet): bf16
#: operations/s, HBM bytes/s, at the 700 W limit
PEAKS = {"H100": {"bf16": 989e12, "hbm": 3.35e12}}


def peaks(kind: str) -> Optional[dict]:
    """The peaks of a device by its name, or None for a chip not listed."""
    for part, p in PEAKS.items():
        if part in kind:
            return p
    return None


def dit_forward(cfg: dict, B: int, Nl: int, N: int, Lc: int = 0) -> float:
    """Operations of one DiT forward (see the module docstring)."""
    D, L = cfg["d_model"], cfg["n_layers"]
    Fd = int(cfg["mlp_ratio"] * D)
    td = cfg["channels"] * cfg["patch_size"] ** 2
    Dc = cfg["cond_dim"]
    tok_block = 2 * (4 * D * D + 2 * D * Fd) + 4 * N * D
    row_block = 2 * D * 6 * D
    row = 2 * 256 * D + 2 * D * D + 2 * D * 2 * D
    if Lc:
        tok_block += 4 * D * D + 4 * Lc * D
        row_block += 2 * Dc * 2 * D * Lc
        row += 2 * Dc * D
    tok = 2 * td * D + 2 * D * td
    return float(B * (Nl * (L * tok_block + tok) + L * row_block + row))


def attention_kernel(B: int, H: int, Nl: int, N: int, hd: int,
                     elem_bytes: int = 2):
    """(operations, bytes) of one stale-K/V attention launch: Nl real
    query rows a row of the batch over an N-token context."""
    ops = 4.0 * B * H * Nl * N * hd
    nbytes = float(elem_bytes * B * H * hd * (2 * N + 2 * Nl))
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, peak: dict) -> float:
    return max(ops / peak["bf16"], nbytes / peak["hbm"])
