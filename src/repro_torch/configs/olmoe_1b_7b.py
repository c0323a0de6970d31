"""OLMoE-1B-7B [moe] — 64 experts top-8 [arXiv:2409.02060].
(reference: ``repro.configs.olmoe_1b_7b``, field for field).

Assigned: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 (expert width)
vocab=50304, MoE 64e top-8, no shared experts.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060 (OLMoE)",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    n_shared_experts=0,
)
