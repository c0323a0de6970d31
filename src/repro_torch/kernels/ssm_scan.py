"""Selective-SSM (Mamba) scan on Hopper (kernel K7): the ctypes binding of
``csrc/ssm_scan.cu``.

Reference: ``repro.kernels.ssm_scan.ssm_scan_chunked``, the TPU kernel it
replaces. The CUDA kernel runs the same fp32 recurrence with one lane per
(batch row, channel, state), the state in a register for the whole
sequence; it can also start from a state ``h0`` and write the final state,
as Mamba's prefill and decode need.

This module only marshals arguments; :func:`repro_torch.kernels.ops.
ssm_scan` is the public wrapper that validates inputs, picks the plain
version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

#: state sizes N the CUDA source instantiates (Hymba-1.5B and its reduced form)
SUPPORTED_STATE_SIZES = (16,)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature of the entry point."""
    lib.ssm_scan_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
        + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.ssm_scan_launch.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, x, dt, b_t, c_t, a, d_skip, h0, y, h_final) -> int:
    """Launch K7 on the current stream; returns the CUDA error code of the
    launch (0 = launched). x/dt/y [B, S, Di] and b_t/c_t [B, S, N] share a
    dtype and have a contiguous last dim; a [Di, N], d_skip [Di] and h0 /
    h_final [B, Di, N] (either may be None) are contiguous float32 (checked
    by the caller)."""
    B, S, Di = x.shape
    strides = [st for t in (x, dt, b_t, c_t, y) for st in t.stride()[:2]]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return lib.ssm_scan_launch(
        _DTYPE_CODES[x.dtype], b_t.shape[-1],
        *(None if t is None else t.data_ptr()
          for t in (x, dt, b_t, c_t, a, d_skip, h0, y, h_final)),
        (ctypes.c_int64 * len(strides))(*strides), B, S, Di, stream)
