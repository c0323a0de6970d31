"""Plain PyTorch versions of the port's kernels (reference:
``repro.kernels.ref``). The kernel wrappers in :mod:`repro_torch.kernels.ops`
run these for CPU tensors, the CPU tests hold them to the JAX package, and
``chip_smoke.py`` holds each CUDA kernel to them on the card."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers

#: the finite masked-score sentinel of the reference's kernels
#: (``repro.kernels.stale_kv_attention.NEG_INF``): exp(NEG_INF - m) is 0 and
#: NEG_INF - NEG_INF is 0, where -inf would give NaN
NEG_INF = -1e30


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


def stale_kv_attention_padded_ref(q, k_fresh, v_fresh, k_stale, v_stale,
                                  tok_start: int, valid_tokens: int,
                                  n_tokens: int, scale: Optional[float] = None):
    """Plain version of kernel K2, in the public [B, S, H, hd] layout: the
    reference's SPMD branch of ``dit.block_stack`` (mask-blend, update-slice,
    masked attend).

    q/k_fresh/v_fresh: [B, Nl_max, H, hd] slab, its first ``valid_tokens``
    rows real; k_stale/v_stale: [B, Npad, H, hd] buffer, keys from
    ``n_tokens`` on scratch. The slab's rows past ``valid_tokens`` are
    blended back to the buffer's current values before the slab is written
    at ``tok_start``, and scratch keys are masked out of the fp32 softmax.
    Returns [B, Nl_max, H, hd] in q's dtype, scratch query rows included."""
    Nl = q.shape[1]
    fresh = (torch.arange(Nl, device=q.device) < valid_tokens)[None, :, None, None]
    full_k = k_stale.clone()
    full_v = v_stale.clone()
    rows = slice(tok_start, tok_start + Nl)
    full_k[:, rows] = torch.where(fresh, k_fresh.to(k_stale.dtype), k_stale[:, rows])
    full_v[:, rows] = torch.where(fresh, v_fresh.to(v_stale.dtype), v_stale[:, rows])
    keys = (torch.arange(k_stale.shape[1], device=q.device) < n_tokens)
    out = layers.attend(q.float(), full_k.float(), full_v.float(),
                        mask=keys[None, None, None, :], scale=scale)
    return out.to(q.dtype)


def stale_kv_attention_guided_ref(q, k_fresh, v_fresh, k_stale, v_stale,
                                  tok_start: int, valid_tokens: int,
                                  uncond_fresh: int, n_tokens: int,
                                  scale: Optional[float] = None):
    """Plain version of kernel K5: :func:`stale_kv_attention_padded_ref` for
    each of the two guidance branches of the leading axis (0 conditional,
    1 unconditional); the unconditional branch's fresh rows are
    ``valid_tokens * uncond_fresh`` (0: it attends the stale buffer as is).
    Operands [2, B, S, H, hd]; returns [2, B, Nl_max, H, hd]."""
    valid = (valid_tokens, valid_tokens * int(uncond_fresh))
    return torch.stack([
        stale_kv_attention_padded_ref(q[g], k_fresh[g], v_fresh[g],
                                      k_stale[g], v_stale[g], tok_start,
                                      valid[g], n_tokens, scale)
        for g in range(2)])


def lse_attention_ref(q, k, v, valid_len: int,
                      scale: Optional[float] = None):
    """Plain version of kernel K4, in the public [B, S, H, hd] layout: q's
    attention over the first ``valid_len`` keys of one ring segment,
    returning (the normalized output in q's dtype, its fp32 log-sum-exp
    [B, S, H]), as the reference's ``_segment_partial`` (``spmd.py``)
    computes them, in fp32. An empty segment (``valid_len == 0``) gives
    out = 0 and lse = NEG_INF, exactly zero weight in the cross-hop merge
    (the reference's out there is the mean of V, which the merge also
    weighs by 0)."""
    B, S, H, hd = q.shape
    if valid_len == 0:
        return (torch.zeros_like(q),
                torch.full((B, S, H), NEG_INF, dtype=torch.float32,
                           device=q.device))
    scale = hd ** -0.5 if scale is None else scale
    kf = k[:, :valid_len].float()
    vf = v[:, :valid_len].float()
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf) * scale
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    out = torch.einsum("bhst,bthd->bshd", p / l[..., None], vf)
    return out.to(q.dtype), (m + torch.log(l)).transpose(1, 2)


def cfg_epilogue_ref(eps_c, eps_u, scale):
    """Plain version of kernel K3: ``(combine, delta)`` with ``delta =
    f32(eps_c) - f32(eps_u)`` and ``combine = eps_dtype(f32(eps_u) + scale *
    delta)``, the same fp32 op order as ``repro_torch.core.sampler.
    cfg_combine``/``cfg_delta`` (``repro.kernels.ops._cfg_epilogue_ref``)."""
    ec = eps_c.float()
    eu = eps_u.float()
    d = ec - eu
    return (eu + scale * d).to(eps_c.dtype), d
