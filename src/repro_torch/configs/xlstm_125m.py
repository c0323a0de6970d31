"""xLSTM-125M [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]
(reference: ``repro.configs.xlstm_125m``, field for field).

Assigned: 12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304.
d_ff=0 => no separate FFN; xLSTM blocks carry their own up/down projection
(proj_factor=2, as in the paper's mLSTM block). Every 4th block is an sLSTM
block (xLSTM[.., 1] style mixing), the rest are mLSTM blocks.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517 (xLSTM)",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    proj_factor=2.0,
    slstm_every=4,
    ssm_conv=4,
    tie_embeddings=False,
)
