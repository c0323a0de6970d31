"""Llama-3.1-405B [dense] — GQA, 128k vocab [arXiv:2407.21783].
(reference: ``repro.configs.llama3_405b``, field for field).

Assigned: 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
Full attention; long_500k decode uses the sliding-window variant
(long_context_window=4096) — recorded in DESIGN.md shape-applicability.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama3-405b",
    family="dense",
    source="arXiv:2407.21783 (Llama 3)",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    dtype="bfloat16",
)
