"""DeepSeekMoE-16B [moe] — 2 shared + 64 routed top-6, fine-grained
(reference: ``repro.configs.deepseek_moe_16b``, field for field).
[arXiv:2401.06066].

Assigned: 28L d_model=2048 16H (GQA kv=16) d_ff=1408 (expert width)
vocab=102400, MoE 64e top-6 + 2 shared experts.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066 (DeepSeekMoE)",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
)
