"""Tiny DiT denoiser — the small model of the tests (reference:
``repro.configs.tiny_dit``)."""
from repro_torch.configs.diffusion import DiTConfig

CONFIG = DiTConfig(
    arch_id="tiny-dit",
    latent_size=32,
    channels=3,
    patch_size=2,
    n_layers=4,
    d_model=192,
    n_heads=6,
    mlp_ratio=4.0,
    cond_dim=64,
    n_classes=16,
)
