"""Minitron-8B [dense] — pruned Nemotron [arXiv:2407.14679].
(reference: ``repro.configs.minitron_8b``, field for field).

Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="minitron-8b",
    family="dense",
    source="arXiv:2407.14679 (Minitron)",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    activation="swiglu",   # nemotron uses squared-relu; swiglu width kept per assignment
)
