"""Stale-KV patch attention (kernel K1) on Hopper: the ctypes binding of
``csrc/stale_kv_attention.cu``.

Reference: ``repro.kernels.stale_kv_attention.stale_kv_attention_bhsd``, the
TPU kernel it replaces. Q comes from the local fresh patch; keys and values
for the whole image come from the stale buffer except the patch's own rows,
which come from the fresh K/V of this step. The CUDA kernel chooses the
source pointer per key row, so it needs no tile alignment of ``tok_start``
(the TPU form selected per block and refused unaligned layouts). bf16 inputs
run a tensor-core body (``mma.sync``, with the probabilities fed as two bf16
terms so P·V keeps them to about 16 bits), float32 inputs a CUDA-core FMA
body that keeps full fp32 precision.

This module only marshals arguments; :func:`repro_torch.kernels.ops.
stale_kv_attention` is the public wrapper that validates inputs, picks the
plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

#: head dims the CUDA source instantiates (tiny-dit and its reduced form: 32;
#: sdxl-dit: 72)
SUPPORTED_HEAD_DIMS = (32, 72)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature of ``stale_kv_attention_launch``."""
    fn = lib.stale_kv_attention_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, q, k_fresh, v_fresh, k_stale, v_stale,
           out, tok_start: int, scale: float) -> int:
    """Launch the kernel on the current stream; returns the CUDA error code
    of the launch (0 = launched). All tensors are [B, S, H, hd] CUDA tensors
    of one dtype with a contiguous last dim (checked by the caller)."""
    B, Nl, H, hd = q.shape
    N = k_stale.shape[1]
    strides = []
    for t in (q, k_fresh, v_fresh, k_stale, v_stale, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    c_strides = (ctypes.c_int64 * len(strides))(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return lib.stale_kv_attention_launch(
        _DTYPE_CODES[q.dtype], hd, q.data_ptr(), k_fresh.data_ptr(),
        v_fresh.data_ptr(), k_stale.data_ptr(), v_stale.data_ptr(),
        out.data_ptr(), c_strides, B, H, Nl, N, tok_start, scale, stream)
