"""The paper's own diffusion model at full width (reference:
``repro.configs.sdxl_dit``; DESIGN.md §2).

The paper serves SDXL (2.3B UNet) at 1024x1024 => 128x128 latents. Our
distributed denoiser is a DiT of comparable scale class (DiT-XL/2-like) on a
128x128x4 latent grid — P_total = 32 patch rows of 2-pixel granularity matches
the paper's ``P_total = 32`` operator constraint (latent 128 / patch_size 2 /
"power-of-two friendly" rows = 64 tokens-per-side, grouped into 32 allocatable
slabs of 2 token-rows each).
"""
from repro_torch.configs.diffusion import DiTConfig

CONFIG = DiTConfig(
    arch_id="sdxl-dit",
    source="arXiv:2307.01952 (SDXL) adapted to DiT-XL/2 [arXiv:2212.09748]",
    latent_size=128,
    channels=4,
    patch_size=2,
    n_layers=28,
    d_model=1152,
    n_heads=16,
    mlp_ratio=4.0,
    cond_dim=256,
    n_classes=1000,
    param_dtype="bfloat16",
    dtype="bfloat16",
)
