"""Yi-9B [dense] — llama-arch GQA [arXiv:2403.04652].
(reference: ``repro.configs.yi_9b``, field for field).

Assigned: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="yi-9b",
    family="dense",
    source="arXiv:2403.04652 (Yi)",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
)
