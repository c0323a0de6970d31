"""Hymba-1.5B [hybrid]: parallel attention and Mamba heads (reference:
``repro.configs.hymba_1_5b``; arXiv:2411.13676).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16. Each
block runs attention heads and Mamba (SSM) heads in parallel on the same
input and fuses them (mean of per-branch normed outputs). 128 learnable meta
tokens are prepended. Attention is sliding-window (1024) everywhere, with
the meta tokens visible outside the window.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676 (Hymba)",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_conv=4,
    n_meta_tokens=128,
    sliding_window=1024,
)
