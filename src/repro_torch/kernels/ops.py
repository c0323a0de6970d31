"""Public kernel wrappers of the port, the build of the CUDA library, and
the per-kernel launch counters (reference: ``repro.kernels.ops``).

Every wrapper takes the plain PyTorch version (:mod:`repro_torch.kernels.
ref`) for CPU tensors and launches its hand-written CUDA kernel for CUDA
tensors, or raises; there is no fallback from one to the other. K6 and K7
also take DTensors, shard by shard over batch and heads or channels
(``repro_torch.sharding.shardwise``): each shard goes through the wrapper,
except ``meta`` shards (the dry-run's trace of shapes, where nothing runs),
which go through the plain version.

The CUDA sources under ``csrc/`` are compiled by ``nvcc`` at first use, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library's file
name carries a hash of the sources, headers and flags, so an edited source
is rebuilt. ``nvcc`` is found the way PyTorch finds it
(``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``).

Launch counters differ from the JAX package's kernel counters: JAX counts
when a kernel call is TRACED (once per compiled program), the port counts
every launch of a kernel (once per call on the card).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import numbers
import os
import pathlib
import subprocess
import time
from typing import Dict

import torch

from repro_torch import spans
from repro_torch.kernels import cfg_epilogue as cfe
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels import stale_kv_attention as skv
from repro_torch.sharding.shardwise import (heads_shardwise, is_dtensor,
                                            shardwise, stand_in)

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# ----------------------------------------------------------------------
# launch counters
# ----------------------------------------------------------------------

def launch_counts() -> Dict[str, int]:
    """Copy of the process-wide launch counters, by kernel name: the
    always-on ``launch.`` part of the span recorder's counter table."""
    return {k[len(spans.LAUNCH):]: n for k, n in spans.counters().items()
            if k.startswith(spans.LAUNCH)}


def reset_launch_counts() -> None:
    spans.reset(spans.LAUNCH)


# ----------------------------------------------------------------------
# build and load
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float          # 0.0 when an up-to-date build was reused
    ptxas_log: str                # nvcc/ptxas report of this build ("" if reused)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return nvcc


@functools.lru_cache(maxsize=1)
def load_library() -> Library:
    """Build (if needed) and load the kernels' shared library."""
    if not torch.cuda.is_available():
        raise RuntimeError("the port's CUDA kernels need a CUDA device; "
                           "CPU tensors take the plain versions")
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    path = BUILD_DIR / f"libstadi_kernels-{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                                       str(src)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(sources, objects)]
            logs = [proc.communicate()[0] for proc in procs]
            log = "".join(logs)
            failed = [src.name for src, proc in zip(sources, procs) if proc.returncode]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                   *map(str, objects)], capture_output=True,
                                  text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)     # atomic: concurrent builders never see half a file
    lib = ctypes.CDLL(str(path))
    for module in (skv, cfe, fa, ss):
        module.bind(lib)
    return Library(lib, path, seconds, log)


# ----------------------------------------------------------------------
# kernel K1: stale-KV patch attention (and the checks K2 and K5 share)
# ----------------------------------------------------------------------

def _refuse_untracked_grad(kernel: str, tensors) -> None:
    """A kernel launched through ctypes returns a tensor autograd knows
    nothing of: a gradient asked of its operands would come back missing
    (None, or zero through the rest of the graph), silently. So an operand
    that requires grad while grad mode is on is refused; K1 differentiates
    through :func:`stale_kv_attention_autograd`, whose forward runs the
    kernel with grad mode off (K6 and K7 route a grad operand through their
    Functions themselves)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward: an operand requires grad "
            "and autograd would drop its gradient (use "
            "stale_kv_attention_autograd for K1, or torch.no_grad())")


def _check_cuda_operands(kernel: str, tensors,
                         head_dims=skv.SUPPORTED_HEAD_DIMS) -> None:
    """What the CUDA attention bodies take: one CUDA device, float32 or
    bfloat16 for all, a head dim in ``head_dims``, a contiguous head dim,
    and for bf16 16-byte rows; and no operand that needs a gradient."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for {q.device}")
    _refuse_untracked_grad(kernel, tensors)
    if len({t.dtype for t in tensors}) != 1 or q.dtype not in (torch.float32,
                                                               torch.bfloat16):
        raise ValueError("operands must all be float32 or all bfloat16, got "
                         f"{[t.dtype for t in tensors]}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"head dim {q.shape[-1]} not instantiated; the "
                         f"{kernel} kernel takes {head_dims}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the head dim (last axis) must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1])
            for t in tensors):
        raise ValueError("the bf16 kernel reads its operands through TMA in "
                         "16-byte units: pointers must be 16-byte aligned, "
                         "strides multiples of 8")


def _check_padded_layout(q, k_fresh, v_fresh, k_stale, v_stale, tok_start,
                         valid_tokens, n_tokens) -> None:
    """Shapes and run-time layout of K2 (and of each K5 branch)."""
    B, Nl, H, hd = q.shape
    Npad = k_stale.shape[1]
    if k_fresh.shape != q.shape or v_fresh.shape != q.shape:
        raise ValueError(f"fresh K/V {tuple(k_fresh.shape)}/"
                         f"{tuple(v_fresh.shape)} must match q {tuple(q.shape)}")
    if k_stale.shape != (B, Npad, H, hd) or v_stale.shape != k_stale.shape:
        raise ValueError(f"stale K/V {tuple(k_stale.shape)}/"
                         f"{tuple(v_stale.shape)} must be [B, Npad, H, hd] = "
                         f"[{B}, Npad, {H}, {hd}]")
    if not 0 < n_tokens <= Npad:
        raise ValueError(f"n_tokens={n_tokens} must lie in (0, {Npad}], the "
                         "buffer's rows")
    if not 0 <= valid_tokens <= Nl:
        raise ValueError(f"valid_tokens={valid_tokens} must lie in [0, {Nl}], "
                         "the slab's rows")
    if not 0 <= tok_start <= Npad - Nl:
        raise ValueError(f"tok_start={tok_start} puts the {Nl}-row slab "
                         f"outside the {Npad}-row scratch-padded buffer")
    if len({t.device for t in (q, k_fresh, v_fresh, k_stale, v_stale)}) != 1:
        raise ValueError("all operands must lie on one device")


def stale_kv_attention(q, k_fresh, v_fresh, k_stale, v_stale, *,
                       tok_start: int):
    """Kernel K1, the DistriFusion hot op (reference
    ``repro.kernels.ops.stale_kv_attention``).

    q/k_fresh/v_fresh: [B, Nl, H, hd] local fresh; k_stale/v_stale:
    [B, N, H, hd] whole-image stale buffer. Returns [B, Nl, H, hd] in q's
    dtype: attention of q over the stale context with rows
    ``tok_start .. tok_start + Nl`` replaced by the fresh K/V. Any strides
    with a contiguous last dim are read in place on the card."""
    B, Nl, H, hd = q.shape
    N = k_stale.shape[1]
    if k_fresh.shape != q.shape or v_fresh.shape != q.shape:
        raise ValueError(f"fresh K/V {tuple(k_fresh.shape)}/"
                         f"{tuple(v_fresh.shape)} must match q {tuple(q.shape)}")
    if k_stale.shape != (B, N, H, hd) or v_stale.shape != k_stale.shape:
        raise ValueError(f"stale K/V {tuple(k_stale.shape)}/"
                         f"{tuple(v_stale.shape)} must be [B, N, H, hd] = "
                         f"[{B}, N, {H}, {hd}]")
    if not 0 <= tok_start <= N - Nl:
        raise ValueError(f"tok_start={tok_start} puts the {Nl}-token patch "
                         f"outside the {N}-token context")
    tensors = (q, k_fresh, v_fresh, k_stale, v_stale)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must lie on one device")
    if q.device.type == "cpu":
        return ref.stale_kv_attention_ref(q, k_fresh, v_fresh, k_stale,
                                          v_stale, tok_start)
    _check_cuda_operands("stale_kv_attention", tensors)
    lib = load_library().lib
    out = torch.empty((B, Nl, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):      # launch on the operands' card
        err = skv.launch(lib, q, k_fresh, v_fresh, k_stale, v_stale, out,
                         tok_start, hd ** -0.5)
    if err != 0:
        raise RuntimeError(f"stale_kv_attention launch failed: CUDA error {err}")
    spans.count("launch.stale_kv_attention")
    return out


class _StaleKVAttention(torch.autograd.Function):
    """K1 under autograd. The forward is :func:`stale_kv_attention` (the
    CUDA kernel on the card, the plain version on the CPU), run with grad
    mode off. The backward recomputes the attention through the plain
    version (:func:`repro_torch.kernels.ref.stale_kv_attention_ref`) under
    ``enable_grad`` and differentiates that: the JAX package has no
    backward kernel either, and trains through XLA's autodiff of its plain
    attend. Only q, K and V are saved, never the [B, H, Nl, N] scores."""

    @staticmethod
    def forward(ctx, q, k_fresh, v_fresh, k_stale, v_stale, tok_start):
        ctx.save_for_backward(q, k_fresh, v_fresh, k_stale, v_stale)
        ctx.tok_start = tok_start
        return stale_kv_attention(q, k_fresh, v_fresh, k_stale, v_stale,
                                  tok_start=tok_start)

    @staticmethod
    def backward(ctx, grad_out):
        return (*_plain_grads(ctx, lambda *t: ref.stale_kv_attention_ref(
            *t, ctx.tok_start), (grad_out,)), None)


def _plain_grads(ctx, plain, grad_outputs):
    """The gradients of ``plain(*saved inputs)`` for the inputs a Function
    was asked for (None for the others), its outputs weighted by
    ``grad_outputs`` (an output whose gradient is None is left out): the
    backward of the kernels' Functions, which differentiate the plain
    version as the JAX package differentiates its plain attention and scan
    (it has no backward kernel)."""
    need = ctx.needs_input_grad[:len(ctx.saved_tensors)]
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        outs = plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        wanted = [t for t, n in zip(inputs, need) if n]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                         [g for _, g in pairs],
                                         allow_unused=True)
                     if pairs and wanted else [None] * len(wanted))
    return [next(grads) if n else None for n in need]


def stale_kv_attention_autograd(q, k_fresh, v_fresh, k_stale, v_stale, *,
                                tok_start: int):
    """K1 where a gradient may be asked for: through
    :class:`_StaleKVAttention` when grad mode is on and an operand requires
    grad, else :func:`stale_kv_attention` itself (one launch either way;
    only the backward is the plain version's)."""
    args = (q, k_fresh, v_fresh, k_stale, v_stale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _StaleKVAttention.apply(*args, tok_start)
    return stale_kv_attention(*args, tok_start=tok_start)


# ----------------------------------------------------------------------
# kernels K2 and K5: the multi-rank (padded) forms of K1
# ----------------------------------------------------------------------

def stale_kv_attention_padded(q, k_fresh, v_fresh, k_stale, v_stale,
                              tok_start: int, valid_tokens: int, *,
                              n_tokens: int):
    """Kernel K2, the padded-layout DistriFusion hot op of the multi-rank
    executors (reference ``repro.kernels.ops.stale_kv_attention_padded``).

    q/k_fresh/v_fresh: [B, Nl_max, H, hd] local slab padded to the largest
    patch, its first ``valid_tokens`` rows real; k_stale/v_stale:
    [B, Npad, H, hd] whole-image stale buffer, scratch-padded past
    ``n_tokens`` real keys. Key t is fresh when ``0 <= t - tok_start <
    valid_tokens``, stale otherwise, and masked when ``t >= n_tokens``.
    Returns [B, Nl_max, H, hd] in q's dtype; rows past ``valid_tokens`` are
    scratch, for the caller to drop. ``tok_start`` and ``valid_tokens`` are
    launch arguments: one build serves every rank's layout."""
    tok_start, valid_tokens = int(tok_start), int(valid_tokens)
    _check_padded_layout(q, k_fresh, v_fresh, k_stale, v_stale, tok_start,
                         valid_tokens, n_tokens)
    if q.device.type == "cpu":
        return ref.stale_kv_attention_padded_ref(
            q, k_fresh, v_fresh, k_stale, v_stale, tok_start, valid_tokens,
            n_tokens)
    tensors = (q, k_fresh, v_fresh, k_stale, v_stale)
    _check_cuda_operands("stale_kv_attention_padded", tensors)
    lib = load_library().lib
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = skv.launch_padded(lib, *tensors, out, tok_start, valid_tokens,
                                n_tokens, q.shape[-1] ** -0.5)
    if err != 0:
        raise RuntimeError("stale_kv_attention_padded launch failed: CUDA "
                           f"error {err}")
    spans.count("launch.stale_kv_attention_padded")
    return out


def stale_kv_attention_guided(q, k_fresh, v_fresh, k_stale, v_stale,
                              tok_start: int, valid_tokens: int,
                              uncond_fresh: int, *, n_tokens: int):
    """Kernel K5, K2 over both guidance branches in one launch (reference
    ``repro.kernels.ops.stale_kv_attention_guided``).

    Operands carry a leading branch axis of 2 (0 conditional, 1
    unconditional): q/fresh [2, B, Nl_max, H, hd], stale [2, B, Npad, H,
    hd]. The unconditional branch's fresh rows are ``valid_tokens *
    uncond_fresh``: with 0 it attends the stale buffer as is (interleaved
    guidance's reuse). Returns [2, B, Nl_max, H, hd]. The branch axis is
    folded into the batch; an operand whose two leading axes do not fold
    into one stride is copied."""
    tok_start, valid_tokens = int(tok_start), int(valid_tokens)
    if uncond_fresh not in (0, 1):
        raise ValueError(f"uncond_fresh must be 0 or 1, got {uncond_fresh!r}")
    uncond_fresh = int(uncond_fresh)
    if q.dim() != 5 or q.shape[0] != 2:
        raise ValueError(f"q {tuple(q.shape)} must be [2, B, Nl_max, H, hd]: "
                         "the leading axis is the guidance branch")
    tensors = (q, k_fresh, v_fresh, k_stale, v_stale)
    if any(t.dim() != 5 or t.shape[0] != 2 for t in tensors):
        raise ValueError("every operand needs the leading branch axis of 2")
    _check_padded_layout(*(t[0] for t in tensors), tok_start, valid_tokens,
                         n_tokens)
    if any(t.shape != u.shape for t, u in zip(tensors, (q, q, q, k_stale, k_stale))):
        raise ValueError("operand shapes disagree between the branches")
    if q.device.type == "cpu":
        return ref.stale_kv_attention_guided_ref(
            *tensors, tok_start, valid_tokens, uncond_fresh, n_tokens)
    folded = tuple(t.flatten(0, 1) for t in tensors)
    _check_cuda_operands("stale_kv_attention_guided", folded)
    lib = load_library().lib
    out = torch.empty(folded[0].shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = skv.launch_guided(lib, *folded, out, tok_start, valid_tokens,
                                uncond_fresh, n_tokens, q.shape[-1] ** -0.5)
    if err != 0:
        raise RuntimeError("stale_kv_attention_guided launch failed: CUDA "
                           f"error {err}")
    spans.count("launch.stale_kv_attention_guided")
    return out.unflatten(0, (2, q.shape[1]))


# ----------------------------------------------------------------------
# kernel K4: one ring segment of sequence-parallel attention, with its LSE
# ----------------------------------------------------------------------

def lse_attention(q, k, v, valid_len: int):
    """Kernel K4, the per-hop partial of ring attention (reference
    ``repro.kernels.ops.lse_attention``): q's attention over ONE K/V
    segment whose first ``valid_len`` keys are real.

    q: [B, S, H, hd]; k/v: [B, T, H, hd], 0 <= valid_len <= T. Returns
    (out [B, S, H, hd] in q's dtype, normalized; lse [B, S, H] float32), the
    pair the cross-hop online-softmax merge combines. ``valid_len == 0``
    gives out 0 and lse -1e30: exactly zero merge weight. ``valid_len`` is
    a launch argument; k and v are read in place with any strides whose
    last dim is contiguous (a head slice of a wider segment, say)."""
    valid_len = int(valid_len)
    B, S, H, hd = q.shape
    T = k.shape[1]
    if k.shape != (B, T, H, hd) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} must be "
                         f"[B, T, H, hd] = [{B}, T, {H}, {hd}]")
    if not 0 <= valid_len <= T:
        raise ValueError(f"valid_len={valid_len} must lie in [0, {T}], the "
                         "segment's keys")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("all operands must lie on one device")
    if q.device.type == "cpu":
        return ref.lse_attention_ref(q, k, v, valid_len)
    _check_cuda_operands("lse_attention", (q, k, v))
    lib = load_library().lib
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = skv.launch_lse(lib, q, k, v, out, lse, valid_len, hd ** -0.5)
    if err != 0:
        raise RuntimeError(f"lse_attention launch failed: CUDA error {err}")
    spans.count("launch.lse_attention")
    return out, lse


# ----------------------------------------------------------------------
# kernel K3: classifier-free-guidance epilogue
# ----------------------------------------------------------------------

def cfg_epilogue(eps_c, eps_u, scale, *, with_delta: bool = True):
    """Fused CFG epilogue (reference ``repro.kernels.ops.cfg_epilogue``):
    ``(combine, delta)`` in one elementwise pass over the branch pair, with
    ``delta = f32(eps_c) - f32(eps_u)`` (float32) and ``combine = f32(eps_u)
    + scale * delta`` cast to eps's dtype; the combine alone when
    ``with_delta`` is False.

    eps_c/eps_u: contiguous tensors of one shape and dtype (the two halves
    of a branch-batched eps are). scale: a Python number, a 0-d tensor, or
    a 1-d tensor of one scale a lane when eps is a lane group [G, ...]:
    lane g combines with ``scale[g]``, and the whole group is one launch.
    On the card a tensor scale is read where it lies: a 1-d one must be
    float32 on eps's card (no copy a launch); a 0-d one on the CPU is read
    as a number."""
    shape, dtype, dev = eps_c.shape, eps_c.dtype, eps_c.device
    if eps_u.shape != shape or eps_u.dtype != dtype:
        raise ValueError(f"eps_c {tuple(shape)} {dtype} and eps_u "
                         f"{tuple(eps_u.shape)} {eps_u.dtype} must match in "
                         "shape and dtype")
    if eps_u.device != dev:
        raise ValueError("eps_c and eps_u must lie on one device")
    per_lane = isinstance(scale, torch.Tensor)
    if per_lane:
        if scale.dim() > 1 or (scale.dim() == 1 and (
                not shape or scale.shape[0] != shape[0])):
            raise ValueError(
                f"scale {tuple(scale.shape)}: a tensor scale is 0-d, or 1-d "
                f"with one entry a lane of eps {tuple(shape)} (its leading "
                "dim)")
    elif not isinstance(scale, numbers.Real):
        raise TypeError(f"scale must be a number or a tensor, got "
                        f"{type(scale).__name__}")
    if dev.type == "cpu":
        comb, d = ref.cfg_epilogue_ref(eps_c, eps_u, scale)
        return (comb, d) if with_delta else comb
    if dev.type != "cuda":
        raise ValueError(f"no cfg_epilogue kernel for {dev}")
    _refuse_untracked_grad("cfg_epilogue", (eps_c, eps_u))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"eps must be float32 or bfloat16, got {dtype}")
    if not (eps_c.is_contiguous() and eps_u.is_contiguous()):
        raise ValueError("cfg_epilogue reads eps_c and eps_u as flat "
                         "contiguous arrays")
    n = eps_c.numel()
    w, scales, lane_n = 0.0, None, n
    if not per_lane:
        w = float(scale)
    elif scale.device.type == "cpu" and not scale.dim():
        w = float(scale)                 # a host number: no device read
    elif scale.device != dev or scale.dtype != torch.float32:
        raise ValueError(f"a tensor scale on the card must be float32 on "
                         f"{dev} (got {scale.dtype} on {scale.device}): the "
                         "kernel reads it in place")
    else:                                # a lane vector, or a 0-d one-lane one
        scales = scale
        lane_n = n // shape[0] if scale.dim() and shape[0] else n
    out = torch.empty_like(eps_c)
    delta = torch.empty(shape, dtype=torch.float32, device=dev) \
        if with_delta else None
    if n:
        lib = load_library().lib
        if dev.index == torch.cuda.current_device():
            err = cfe.launch(lib, eps_c, eps_u, out, delta, scales, lane_n, w)
        else:
            with torch.cuda.device(dev):
                err = cfe.launch(lib, eps_c, eps_u, out, delta, scales,
                                 lane_n, w)
        if err != 0:
            raise RuntimeError(f"cfg_epilogue launch failed: CUDA error {err}")
        spans.count("launch.cfg_epilogue")
    return (out, delta) if with_delta else out


# ----------------------------------------------------------------------
# kernel K6: causal / sliding-window flash attention (the LM prefill)
# ----------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix_len: int = 0):
    """Kernel K6, the language models' full-sequence attention (reference
    ``repro.kernels.ops.flash_attention``).

    q: [B, S, H, hd]; k, v: [B, T, K, hd] with K | H (GQA: query head h
    reads KV head h // (H/K), in place). Query i sits at position i, key j
    at position j. ``causal`` hides keys after the query; ``window > 0``
    keeps keys in ``(i - window, ...)``, and ``prefix_len`` leading keys
    (Hymba's meta tokens) stay visible outside the window. Returns
    [B, S, H, hd] in q's dtype; softmax scale hd ** -0.5. A mask that
    leaves some query row no key is refused (the reference's kernel and its
    oracle disagree there). When grad mode is on and q, k or v requires
    grad, the call goes through :class:`_FlashAttention` (one launch; its
    backward is the plain version's)."""
    window, prefix_len = int(window), int(prefix_len)
    if is_dtensor(q):
        return _flash_attention_sharded(q, k, v, causal, window, prefix_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, prefix_len)
    return _flash_attention(q, k, v, causal, window, prefix_len)


def _flash_attention(q, k, v, causal, window, prefix_len):
    """:func:`flash_attention` outside autograd: the checks, then the plain
    version on the CPU or one kernel launch on the card."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, hd) or v.shape != k.shape or K == 0 or H % K:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} must be "
                         f"[B, T, K, hd] = [{B}, T, K, {hd}] with K | {H}")
    if window < 0 or prefix_len < 0:
        raise ValueError(f"window={window} and prefix_len={prefix_len} must "
                         "be >= 0")
    if T == 0:
        raise ValueError("k/v hold no key (T = 0)")
    if window > 0 and prefix_len == 0 and S >= T + window:
        raise ValueError(f"the mask leaves query rows from {T + window - 1} "
                         f"on no key (S={S}, T={T}, window={window})")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("all operands must lie on one device")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       prefix_len=prefix_len)
    _check_cuda_operands("flash_attention", (q, k, v), fa.SUPPORTED_HEAD_DIMS)
    lib = load_library().lib
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fa.launch(lib, q, k, v, out, causal, window, prefix_len,
                        hd ** -0.5)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    spans.count("launch.flash_attention")
    return out


def _flash_attention_sharded(q, k, v, causal, window, prefix_len):
    """:func:`flash_attention` of DTensors, shard by shard
    (:func:`repro_torch.sharding.shardwise.heads_shardwise`); on ``meta`` shards the plain version stands
    in for the kernel."""
    mask = dict(causal=causal, window=window, prefix_len=prefix_len)
    return heads_shardwise(lambda q, k, v: stand_in(
        lambda *t: ref.flash_attention_ref(*t, **mask), q, k, v) if q.is_meta
        else flash_attention(q, k, v, **mask), q, k, v)


class _FlashAttention(torch.autograd.Function):
    """K6 under autograd, as :class:`_StaleKVAttention` is K1's: the forward
    is :func:`_flash_attention` (one launch on the card, the plain version
    on the CPU) with grad mode off; the backward recomputes
    :func:`repro_torch.kernels.ref.flash_attention_ref` under
    ``enable_grad`` and differentiates it (the JAX package trains through
    XLA's autodiff of its plain ``attend``). Only q, K and V are saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, prefix_len=prefix_len)
        return _flash_attention(q, k, v, causal, window, prefix_len)

    @staticmethod
    def backward(ctx, grad_out):
        return (*_plain_grads(ctx, lambda *t: ref.flash_attention_ref(
            *t, **ctx.mask), (grad_out,)), None, None, None)


# ----------------------------------------------------------------------
# kernel K7: the selective-SSM (Mamba) scan
# ----------------------------------------------------------------------

_SCAN_DTYPES = (torch.float32, torch.bfloat16)


def ssm_scan(x, dt, b_t, c_t, a, d_skip, *, h0=None, final_state: bool = False):
    """Kernel K7, the Mamba recurrence (reference
    ``repro.kernels.ops.ssm_scan``; with ``h0`` and ``final_state``,
    ``repro.models.mamba.ssm_scan_ref``).

    x, dt: [B, S, Di]; b_t, c_t: [B, S, N]; a: [Di, N]; d_skip: [Di]; h0:
    [B, Di, N] float32 or None (zeros). Runs
    ``h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t^T``,
    ``y_t = <h_t, c_t> + d_skip x_t`` in float32 and returns y [B, S, Di]
    in x's dtype, or (y, the final state [B, Di, N] float32) when
    ``final_state``. On the card x, dt, b_t and c_t share one dtype
    (float32 or bfloat16) and may have any strides with a contiguous last
    axis; a, d_skip and h0 are float32. When grad mode is on and an
    operand requires grad, the call goes through :class:`_SSMScan` (one
    launch; its backward is the plain version's)."""
    if is_dtensor(x):
        # per batch row and channel: b_t / c_t whole, a / d_skip / h0 by channel
        bc, ch = (0, 2), (None, 0)
        return shardwise(
            lambda *t: _ssm_scan_shard(*t, final_state=final_state),
            (x, dt, b_t, c_t, a, d_skip, h0),
            (bc, bc, (0, None), (0, None), ch, ch, (0, 1)),
            (bc, (0, 1)) if final_state else (bc,))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, b_t, c_t, a, d_skip, h0)):
        return _SSMScan.apply(x, dt, b_t, c_t, a, d_skip, h0, final_state)
    return _ssm_scan(x, dt, b_t, c_t, a, d_skip, h0, final_state)


def _ssm_scan(x, dt, b_t, c_t, a, d_skip, h0, final_state):
    """:func:`ssm_scan` outside autograd: the checks, then the plain
    version on the CPU or one kernel launch on the card."""
    B, S, Di = x.shape
    N = b_t.shape[-1]
    if (dt.shape != x.shape or b_t.shape != (B, S, N) or c_t.shape != b_t.shape
            or a.shape != (Di, N) or d_skip.shape != (Di,)
            or (h0 is not None and h0.shape != (B, Di, N))):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, b_t "
            f"{tuple(b_t.shape)}, c_t {tuple(c_t.shape)}, a {tuple(a.shape)}, "
            f"d_skip {tuple(d_skip.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} do not fit x [B, S, Di]"
            ", b_t/c_t [B, S, N], a [Di, N], d_skip [Di], h0 [B, Di, N]")
    tensors = [t for t in (x, dt, b_t, c_t, a, d_skip, h0) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must lie on one device")
    if x.device.type == "cpu":
        y, h = ref.ssm_scan_ref(x, dt, b_t, c_t, a, d_skip, h0)
        return (y, h) if final_state else y
    if x.device.type != "cuda":
        raise ValueError(f"no ssm_scan kernel for {x.device}")
    # decode calls this 32 times a token at S = 1, where the host's time per
    # call is the cost: the checks read each attribute once
    dtype = x.dtype
    if (dtype not in _SCAN_DTYPES or dt.dtype != dtype or b_t.dtype != dtype
            or c_t.dtype != dtype):
        raise ValueError("x, dt, b_t and c_t must all be float32 or all "
                         f"bfloat16, got {[t.dtype for t in (x, dt, b_t, c_t)]}")
    if (a.dtype != torch.float32 or d_skip.dtype != torch.float32
            or (h0 is not None and h0.dtype != torch.float32)):
        raise ValueError("a, d_skip and h0 must be float32")
    if N not in ss.SUPPORTED_STATE_SIZES:
        raise ValueError(f"state size {N} not instantiated; the ssm_scan "
                         f"kernel takes {ss.SUPPORTED_STATE_SIZES}")
    if S == 0 or (x.stride(-1), dt.stride(-1), b_t.stride(-1),
                  c_t.stride(-1)) != (1, 1, 1, 1):
        raise ValueError("S must be positive and the last axis of x, dt, "
                         "b_t and c_t contiguous")
    if not (a.is_contiguous() and d_skip.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        raise ValueError("a, d_skip and h0 must be contiguous")
    lib = load_library().lib
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    h = (torch.empty((B, Di, N), dtype=torch.float32, device=x.device)
         if final_state else None)
    if x.device.index == torch.cuda.current_device():
        err = ss.launch(lib, x, dt, b_t, c_t, a, d_skip, h0, y, h)
    else:
        with torch.cuda.device(x.device):
            err = ss.launch(lib, x, dt, b_t, c_t, a, d_skip, h0, y, h)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {err}")
    spans.count("launch.ssm_scan")
    return (y, h) if final_state else y


def _ssm_scan_shard(x, dt, b_t, c_t, a, d_skip, h0, *, final_state):
    """One shard of a DTensor :func:`ssm_scan`: the wrapper, or on ``meta``
    shards the plain version."""
    if not x.is_meta:
        return ssm_scan(x, dt, b_t, c_t, a, d_skip, h0=h0, final_state=final_state)
    y, h = stand_in(ref.ssm_scan_ref, x, dt, b_t, c_t, a, d_skip, h0)
    return (y, h) if final_state else y


class _SSMScan(torch.autograd.Function):
    """K7 under autograd: the forward is :func:`_ssm_scan` (one launch on
    the card) with grad mode off, returning y, or (y, the final state) with
    ``final_state``; the backward recomputes
    :func:`repro_torch.kernels.ref.ssm_scan_ref` under ``enable_grad`` and
    differentiates it for the outputs given a gradient (either may have
    none), ``h0`` included. Only the inputs are saved."""

    @staticmethod
    def forward(ctx, x, dt, b_t, c_t, a, d_skip, h0, final_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, b_t, c_t, a, d_skip, h0)
        return _ssm_scan(x, dt, b_t, c_t, a, d_skip, h0, final_state)

    @staticmethod
    def backward(ctx, grad_y, grad_h=None):
        return (*_plain_grads(ctx, ref.ssm_scan_ref, (grad_y, grad_h)), None)
