"""Plain PyTorch versions of the port's kernels (reference:
``repro.kernels.ref``). The kernel wrappers in :mod:`repro_torch.kernels.ops`
run these for CPU tensors, the CPU tests hold them to the JAX package, and
``chip_smoke.py`` holds each CUDA kernel to them on the card."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers
from repro_torch.sharding.shardwise import FoldedLoop

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
    cfg_combine``/``cfg_delta`` (``repro.kernels.ops._cfg_epilogue_ref``).
    ``scale``: a number, a 0-d tensor, or a 1-d tensor of one scale a lane
    of eps [G, ...] (lane g takes ``scale[g]``, rounded to fp32)."""
    ec = eps_c.float()
    eu = eps_u.float()
    d = ec - eu
    if isinstance(scale, torch.Tensor) and scale.dim():
        scale = scale.to(device=d.device, dtype=torch.float32).reshape(
            (-1,) + (1,) * (d.dim() - 1))
    return (eu + scale * d).to(eps_c.dtype), d


def flash_mask(S: int, T: int, *, causal: bool, window: int = 0,
               prefix_len: int = 0, device=None):
    """[S, T] bool: which keys query row i sees under kernel K6's mask.
    Query i sits at position i and key j at position j: ``causal`` keeps
    j <= i; ``window > 0`` keeps j in ``(i - window, ...)``, except the
    ``prefix_len`` leading keys, which stay visible outside the window."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= (kj > qi - window) | (kj < prefix_len)
    return mask


def flash_attention_ref(q, k, v, *, causal: bool, window: int = 0,
                        prefix_len: int = 0, scale: Optional[float] = None):
    """Plain version of kernel K6, in the public layout: q [B, S, H, hd],
    k/v [B, T, K, hd] with K | H (query head h reads KV head h // (H/K)).
    A materialized fp32 softmax over :func:`flash_mask`, masked scores at
    NEG_INF, as ``repro.kernels.ref.attention_ref`` (which has no prefix);
    the output has q's dtype."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    kf = layers.repeat_kv(k, H // k.shape[2]).float()
    vf = layers.repeat_kv(v, H // v.shape[2]).float()
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf) * scale
    mask = flash_mask(S, k.shape[1], causal=causal, window=window,
                      prefix_len=prefix_len, device=q.device)
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, NEG_INF)), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def ssm_scan_ref(x, dt, b_t, c_t, a, d_skip, h0=None):
    """Plain version of kernel K7: the selective-SSM recurrence, one step
    at a time in fp32,

        h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T,  y_t = <h_t, C_t> + D x_t

    x, dt: [B, S, Di]; b_t, c_t: [B, S, N]; a: [Di, N]; d_skip: [Di]; h0:
    [B, Di, N] (zeros when None). Returns (y [B, S, Di] in x's dtype, the
    final state [B, Di, N] float32). With h0 None, y is
    ``repro.kernels.ref.ssm_scan_ref``; with h0, the pair is
    ``repro.models.mamba.ssm_scan_ref``."""
    B, S, Di = x.shape
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b_t, c_t))
    a, d_skip = a.float(), d_skip.float()
    h = (torch.zeros(B, Di, b_t.shape[-1], dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    loop = FoldedLoop(S, x)
    xf, dtf, bf, cf, a, d_skip, h = loop.enter(xf, dtf, bf, cf, a, d_skip, h)
    ys = []
    with loop:
        for t in loop.steps:
            da = torch.exp(dtf[:, t, :, None] * a[None])
            h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]) + d_skip * xf[:, t])
            h, = loop.carry(h)
    ys = loop.stack(ys, 1)
    h, = loop.leave(h)
    return ys.to(x.dtype), h


#: planted faults of :func:`ssm_scan_chunked_ref` at its first chunk
#: boundary, for showing that a bar rejects them: the carry into the second
#: chunk dropped (zero), or entering without its first step's decay
SCAN_FAULTS = ("carry dropped", "carry undecayed")


def ssm_scan_chunked_ref(x, dt, b_t, c_t, a, d_skip, h0=None, *,
                         chunk: int = 128, fault: Optional[str] = None):
    """Kernel K7's scan body in PyTorch: :func:`ssm_scan_ref`'s function,
    computed in the kernel's order. The step ``h -> a h + b`` (``a =
    exp(dt A)``, per step; ``b = dt x B``) is an affine map, and maps
    compose associatively. The sequence is cut into chunks of ``chunk``
    steps (the last one padded with identity steps, dt = 0), each chunk
    into 32 runs (a warp's lanes) of ``chunk // 32`` consecutive steps. Per
    chunk:
    each run's prefix composites in order; an inclusive Hillis-Steele scan
    of the runs' composites (offsets 1, 2, 4, ..., the warp's shuffle
    scan); the composite of the runs before a run applied to the chunk's
    carry-in state gives the state before its first step, and each step's
    state is its prefix applied to that; the chunk's last state is the
    carry into the next. ``fault`` (one of :data:`SCAN_FAULTS`) plants that
    fault at step ``chunk``. Returns (y in x's dtype, the final state
    fp32)."""
    if fault not in (None,) + SCAN_FAULTS:
        raise ValueError(f"fault {fault!r} is not one of {SCAN_FAULTS}")
    lanes = 32
    if chunk % lanes:
        raise ValueError(f"chunk {chunk} must be a multiple of {lanes}")
    items = chunk // lanes
    B, S, Di = x.shape
    N = b_t.shape[-1]
    pad = -S % chunk
    xf, dtf, bf, cf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
                       for t in (x, dt, b_t, c_t))
    a, d_skip = a.float(), d_skip.float()
    h = (torch.zeros(B, Di, N, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t0 in range(0, S + pad, chunk):
        cut = lambda t, w: t[:, t0:t0 + chunk].reshape(B, lanes, items, w)
        xk, dtk, bk, ck = cut(xf, Di), cut(dtf, Di), cut(bf, N), cut(cf, N)
        dec = torch.exp(dtk[..., None] * a)                   # [B, L, I, Di, N]
        if t0 == chunk and fault == "carry dropped":
            h = torch.zeros_like(h)
        if t0 == chunk and fault == "carry undecayed":
            dec[:, 0, 0] = 1.0
        inp = (dtk * xk)[..., None] * bk[:, :, :, None, :]
        pa, pb = [dec[:, :, 0]], [inp[:, :, 0]]
        for i in range(1, items):
            pa.append(dec[:, :, i] * pa[-1])
            pb.append(dec[:, :, i] * pb[-1] + inp[:, :, i])
        pa, pb = torch.stack(pa, 2), torch.stack(pb, 2)
        sa, sb = pa[:, :, -1], pb[:, :, -1]                   # [B, L, Di, N]
        off = 1
        while off < lanes:                                    # earlier runs first
            sa, sb = (torch.cat([sa[:, :off], sa[:, off:] * sa[:, :-off]], 1),
                      torch.cat([sb[:, :off], sa[:, off:] * sb[:, :-off] + sb[:, off:]], 1))
            off *= 2
        ea = torch.cat([torch.ones_like(sa[:, :1]), sa[:, :-1]], 1)
        eb = torch.cat([torch.zeros_like(sb[:, :1]), sb[:, :-1]], 1)
        h_before = ea * h[:, None] + eb
        hs = pa * h_before[:, :, None] + pb                   # [B, L, I, Di, N]
        yk = torch.einsum("blidn,blin->blid", hs, ck) + d_skip * xk
        ys.append(yk.reshape(B, chunk, Di))
        h = hs[:, -1, -1]
    return torch.cat(ys, 1)[:, :S].to(x.dtype), h
