"""Architecture configuration of the language models (reference:
``repro.configs.base``), field for field, so one config drives both
packages. ``ArchConfig.reduced()`` gives the smoke-test variant (<=2
layers, d_model<=512) of the same family.

``attn_impl`` and ``attn_chunk`` stay for parity with the reference, where
they pick the naive or the chunked attention. In the port they change
nothing: the DEVICE picks the path, as with ``DiTConfig.use_pallas_attention``
(CUDA tensors run the hand-written kernel K6, CPU tensors its plain version;
``repro_torch.kernels.ops.flash_attention``). ``act_shard`` is a JAX
sharding constraint in the reference; the port reads it only when its
residual stream is a DTensor (``layers.constrain_residual``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""                 # paper / model-card citation

    # transformer core
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None   # default: d_model // n_heads
    d_ff: int = 1024                 # dense FFN width (for moe: expert width)
    vocab: int = 1024
    activation: str = "swiglu"       # swiglu | geglu
    norm: str = "rmsnorm"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0       # gemma-style soft capping (0 = off)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM / recurrent
    ssm_state: int = 0               # mamba state size N
    ssm_conv: int = 4                # depthwise conv width
    slstm_every: int = 0             # xLSTM: every k-th block is sLSTM (0=never)
    proj_factor: float = 2.0         # xLSTM up-projection factor

    # hybrid (hymba)
    n_meta_tokens: int = 0

    # enc-dec (seamless)
    n_enc_layers: int = 0            # 0 => decoder-only
    cross_attention: bool = False

    # vlm
    n_vision_tokens: int = 0

    # attention variant for long-context decode (sub-quadratic carve-out)
    sliding_window: int = 0          # 0 = full attention
    long_context_window: int = 4096  # window used when shape requires sub-quadratic

    # numerics / implementation selection
    param_dtype: str = "float32"
    dtype: str = "float32"
    attn_impl: str = "naive"         # naive | chunked: read by the reference
    attn_chunk: int = 512            # only (see the module docstring)
    act_shard: str = ""              # "" | batch | seqpar: the residual
                                     # stream's sharding (DTensor runs)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run long_500k decode natively (O(1)/O(w) state)?"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant of the same family: tiny but structurally identical."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        hd = max(8, d_model // n_heads)
        kv = max(1, min(self.n_kv_heads, n_heads))
        # keep GQA ratio structure: kv divides heads
        while n_heads % kv:
            kv -= 1
        kw = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=max(32, min(self.d_ff, 512)) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(2, self.top_k),
                      n_shared_experts=min(self.n_shared_experts, 1))
        if self.n_enc_layers:
            kw.update(n_enc_layers=2)
        if self.n_vision_tokens:
            kw.update(n_vision_tokens=16)
        if self.n_meta_tokens:
            kw.update(n_meta_tokens=8)
        if self.sliding_window:
            kw.update(sliding_window=64)
        kw.update(long_context_window=min(self.long_context_window, 64))
        return self.replace(**kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (for 6*N*D roofline bookkeeping)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, K, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        if self.activation in ("swiglu", "geglu"):
            ffn = 3 * D * F
        else:
            ffn = 2 * D * F
        if self.n_experts:
            moe = self.n_experts * ffn + D * self.n_experts
            moe += self.n_shared_experts * ffn
            block = attn + moe
        elif self.family == "ssm":
            # xLSTM block approximation: up/down proj + qkv + gates
            dp = int(self.proj_factor * D)
            block = 2 * D * dp + 3 * dp * dp // max(1, self.n_heads) + 4 * dp
            block = 2 * D * dp + 3 * dp * hd * self.n_heads // max(1, self.n_heads) + 4 * dp
        else:
            block = attn + ffn
        if self.family == "hybrid":
            dp = D  # mamba inner ~ D
            block += 2 * D * dp + dp * self.ssm_state * 2
        total = L * block + V * D * (1 if self.tie_embeddings else 2)
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + ffn)      # encoder stack
            total += L * attn                               # cross attention
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top_k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, K, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        ffn = 3 * D * F
        act_block = attn + (self.top_k + self.n_shared_experts) * ffn + D * self.n_experts
        return int(L * act_block + V * D * 2)
