"""SeamlessM4T-medium [audio] — encoder-decoder, multimodal [arXiv:2308.11596]
(reference: ``repro.configs.seamless_m4t_medium``, field for field).

Assigned: 12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.
Interpreted as 12 encoder + 12 decoder layers (the text-to-text backbone);
the speech frontend (mel-spectrogram + conformer feature extractor) is a
stub: the encoder takes precomputed frame embeddings of shape
(batch, src_len, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="seamless-m4t-medium",
    family="encdec",
    source="arXiv:2308.11596 (SeamlessM4T)",
    n_layers=12,           # decoder layers
    n_enc_layers=12,       # encoder layers
    cross_attention=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    activation="geglu",
)
