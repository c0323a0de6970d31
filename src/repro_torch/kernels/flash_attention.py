"""Causal / sliding-window flash attention on Hopper (kernel K6): the ctypes
binding of ``csrc/flash_attention.cu``.

Reference: ``repro.kernels.flash_attention.flash_attention_bhsd``, the TPU
kernel it replaces. The CUDA kernel reads K/V heads in place for GQA (query
head h reads KV head h // (H/K)), takes the ``prefix_len`` always-visible
leading keys of Hymba's meta tokens as a launch argument, and bounds its
key loop by T, so nothing is repeated or padded. bf16 inputs run K1's
tensor-core body, float32 inputs its CUDA-core FMA body.

This module only marshals arguments; :func:`repro_torch.kernels.ops.
flash_attention` is the public wrapper that validates inputs, picks the
plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

#: head dims the CUDA source instantiates (Hymba-1.5B and its reduced form)
SUPPORTED_HEAD_DIMS = (64,)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature of the entry point."""
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, q, k, v, out, causal: bool, window: int,
           prefix_len: int, scale: float) -> int:
    """Launch K6 on the current stream; returns the CUDA error code of the
    launch (0 = launched). q/out [B, S, H, hd], k/v [B, T, K, hd] CUDA
    tensors of one dtype with a contiguous last dim (checked by the
    caller)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    tensors = (q, k, v, out)
    strides = [st for t in tensors for st in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return lib.flash_attention_launch(
        _DTYPE_CODES[q.dtype], hd, *(t.data_ptr() for t in tensors),
        (ctypes.c_int64 * len(strides))(*strides), B, H, K, S, T, int(causal),
        window, prefix_len, scale, stream)
