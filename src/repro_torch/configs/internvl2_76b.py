"""InternVL2-76B [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].
(reference: ``repro.configs.internvl2_76b``, field for field).

Assigned: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Per the brief, the vision frontend (InternViT-6B + MLP projector) is a STUB:
``input_specs`` provides 1024 precomputed patch embeddings of shape
(batch, n_vision_tokens, d_model); this module implements the language
decoder that consumes them interleaved with text tokens.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2)",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    n_vision_tokens=1024,
    param_dtype="bfloat16",
    dtype="bfloat16",
)
