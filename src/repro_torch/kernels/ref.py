"""Plain PyTorch versions of the port's kernels (reference:
``repro.kernels.ref``). The kernel wrappers in :mod:`repro_torch.kernels.ops`
run these for CPU tensors, the CPU tests hold them to the JAX package, and
``chip_smoke.py`` holds each CUDA kernel to them on the card."""
from __future__ import annotations

from typing import Optional

from repro_torch.models import layers


def stale_kv_attention_ref(q, k_fresh, v_fresh, k_stale, v_stale,
                           tok_start: int, scale: Optional[float] = None):
    """Plain version of kernel K1, in the public [B, S, H, hd] layout.

    q/k_fresh/v_fresh: [B, Nl, H, hd] local patch; k_stale/v_stale:
    [B, N, H, hd] whole-image stale buffer. Clones the stale buffer, writes
    the fresh rows at ``tok_start`` and attends with an fp32 softmax; the
    output has q's dtype (``repro.kernels.ref.stale_kv_attention_ref``)."""
    Nl = q.shape[1]
    full_k = k_stale.clone()
    full_v = v_stale.clone()
    full_k[:, tok_start:tok_start + Nl] = k_fresh.to(k_stale.dtype)
    full_v[:, tok_start:tok_start + Nl] = v_fresh.to(v_stale.dtype)
    out = layers.attend(q.float(), full_k.float(), full_v.float(), scale=scale)
    return out.to(q.dtype)


def cfg_epilogue_ref(eps_c, eps_u, scale):
    """Plain version of kernel K3: ``(combine, delta)`` with ``delta =
    f32(eps_c) - f32(eps_u)`` and ``combine = eps_dtype(f32(eps_u) + scale *
    delta)``, the same fp32 op order as ``repro_torch.core.sampler.
    cfg_combine``/``cfg_delta`` (``repro.kernels.ops._cfg_epilogue_ref``)."""
    ec = eps_c.float()
    eu = eps_u.float()
    d = ec - eu
    return (eu + scale * d).to(eps_c.dtype), d
