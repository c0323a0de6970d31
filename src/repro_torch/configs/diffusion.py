"""Diffusion-model (denoiser) configs of the port, field for field those of
``repro.configs.diffusion`` so one config drives both packages."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    arch_id: str = "tiny-dit"
    family: str = "dit"
    source: str = "arXiv:2212.09748 (DiT)"
    # latent grid
    latent_size: int = 32            # H = W (latent resolution)
    channels: int = 4                # latent channels
    patch_size: int = 2              # patchify
    # transformer
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    mlp_ratio: float = 4.0
    cond_dim: int = 64               # class/prompt conditioning embedding dim
    n_classes: int = 16              # synthetic conditioning vocabulary
    # prompt conditioning (DESIGN.md §17): cond_seq_len > 0 declares the
    # workload prompt-conditioned (its largest prompt bucket) and cross_attn
    # interleaves a prompt cross-attention read into every DiT block
    cond_seq_len: int = 0
    cross_attn: bool = False
    # numerics
    param_dtype: str = "float32"
    dtype: str = "float32"
    # kept for parity with the reference config, where it routes buffered
    # attention through the Pallas kernel. In the port it changes nothing:
    # the DEVICE picks the path — CUDA tensors always run the hand-written
    # kernel, CPU tensors its plain version (repro_torch.kernels.ops).
    use_pallas_attention: bool = False

    @property
    def tokens_per_side(self) -> int:
        return self.latent_size // self.patch_size

    @property
    def n_tokens(self) -> int:
        return self.tokens_per_side ** 2

    @property
    def token_dim(self) -> int:
        return self.channels * self.patch_size ** 2

    def replace(self, **kw) -> "DiTConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "DiTConfig":
        return self.replace(n_layers=2, d_model=128, n_heads=4, latent_size=16)

    def text_conditioned(self, cond_seq_len: int = 32) -> "DiTConfig":
        """Prompt-conditioned variant (DESIGN.md §17): enables the per-block
        prompt cross-attention and declares the max prompt-token bucket."""
        return self.replace(cond_seq_len=cond_seq_len, cross_attn=True)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    arch_id: str = "tiny-unet"
    family: str = "unet"
    source: str = "arXiv:2307.01952 (SDXL; scaled-down)"
    image_size: int = 32
    channels: int = 3
    base_width: int = 32
    channel_mults: tuple = (1, 2, 2)
    attn_levels: tuple = (2,)        # attention at these downsample levels
    n_res_blocks: int = 1
    cond_dim: int = 64
    n_classes: int = 16
    param_dtype: str = "float32"
    dtype: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
