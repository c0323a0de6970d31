"""The denoiser's weights and the run's latents, made on the device from
the seed in a few large draws, in the type they are served in.

The weights follow the tree the port's DiT reads (``patch_embed``,
``blocks.qkv`` [L, D, 3D], ...). Every matrix is a fan-in normal (the MLP's
output at 1 / sqrt(2 L fan_in)). The scales that decide how much attention
moves an image are raised, so that the comparison with the reference sees
the attention (kernel K1) at all: at the fan-in scales with adaLN-zero's
gates drawn at 0.02, dropping every attention read moved a small DiT's
image by 0.2 %, under bf16's own 0.7 %; with the adaLN modulation at
2 / sqrt(D) (gates of about 0.6), the attention's output projection at
4 / sqrt(2 L D) and the query, key and value projections at 2 / sqrt(D)
(peaked softmax), it moves it by 26 to 40 %. The output head and the
prompt read's output are small draws in place of adaLN-zero's zeros. One
normal draw fills one flat buffer, and each leaf is a scaled view of it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def stream(seed: int, name: str) -> int:
    """A 63-bit generator seed for the named stream of a run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in name]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def layout(cfg: dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, std) of every leaf; std 0 is a zero leaf."""
    D, L = cfg["d_model"], cfg["n_layers"]
    Fd = int(cfg["mlp_ratio"] * D)
    td = cfg["channels"] * cfg["patch_size"] ** 2
    Dc = cfg["cond_dim"]
    out = [
        ("patch_embed", (td, D), 1 / math.sqrt(td)),
        ("patch_bias", (D,), 0.0),
        ("t_w1", (256, D), 1 / math.sqrt(256)),
        ("t_w2", (D, D), 1 / math.sqrt(D)),
        ("cond_embed", (cfg["n_classes"], D), 0.02),
        ("blocks.qkv", (L, D, 3 * D), 2 / math.sqrt(D)),
        ("blocks.wo", (L, D, D), 4 / math.sqrt(2 * L * D)),
        ("blocks.w1", (L, D, Fd), 1 / math.sqrt(D)),
        ("blocks.w2", (L, Fd, D), 1 / math.sqrt(2 * L * Fd)),
        ("blocks.mod_w", (L, D, 6 * D), 2 / math.sqrt(D)),
        ("blocks.mod_b", (L, 6 * D), 0.2),
        ("final_mod_w", (D, 2 * D), 0.02),
        ("final_mod_b", (2 * D,), 0.0),
        ("final_proj", (D, td), 0.05),
    ]
    if cfg.get("cross_attn"):
        out += [("blocks.xq", (L, D, D), 1 / math.sqrt(D)),
                ("blocks.xkv", (L, Dc, 2 * D), 1 / math.sqrt(Dc)),
                ("blocks.xo", (L, D, D), 0.05),
                ("ctx_pool", (Dc, D), 1 / math.sqrt(Dc))]
    return out


def make(cfg: dict, seed: int, device) -> Dict:
    """The weight tree of ``cfg`` for ``seed``, on ``device``, in
    ``cfg["param_dtype"]``."""
    dt = DTYPES[cfg["param_dtype"]]
    leaves = layout(cfg)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(stream(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=dt)
    tree: Dict = {}
    at = 0
    for path, shape, std in leaves:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        leaf.zero_() if std == 0.0 else leaf.mul_(std)
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def latents(cfg: dict, seed: int, n: int, device) -> torch.Tensor:
    """[n, H, W, C] starting latents x_T in the activation dtype: request i
    takes row i."""
    gen = torch.Generator(device=device).manual_seed(stream(seed, "latents"))
    H, C = cfg["latent_size"], cfg["channels"]
    return torch.randn(n, H, H, C, generator=gen, device=device,
                       dtype=DTYPES[cfg["dtype"]])
