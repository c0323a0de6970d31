"""Gemma-2B [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295].
(reference: ``repro.configs.gemma_2b``, field for field).

Assigned: 18L d_model=2048 8H (GQA kv=1 => MQA) d_ff=16384 vocab=256000.
head_dim=256 (explicit, attn_dim = 8*256 = 2048).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma-2b",
    family="dense",
    source="arXiv:2403.08295 (Gemma)",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    activation="geglu",
    tie_embeddings=True,
    logit_softcap=30.0,
)
