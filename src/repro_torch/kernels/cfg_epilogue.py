"""Classifier-free-guidance epilogue (kernel K3) on Hopper: the ctypes
binding of ``csrc/cfg_epilogue.cu``.

Reference: ``repro.kernels.cfg_epilogue.cfg_epilogue_2d``, the TPU kernel it
replaces. In one elementwise pass over the two guidance branches it writes
the combine ``eps_u + w * (eps_c - eps_u)`` in eps's dtype and the guidance
direction ``eps_c - eps_u`` in float32, each branch read once. The TPU form
works on padded ``[M, 128]`` tiles; this one on the flat element count.

This module only marshals arguments; :func:`repro_torch.kernels.ops.
cfg_epilogue` is the public wrapper that validates inputs, picks the plain
version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signature of ``cfg_epilogue_launch``."""
    fn = lib.cfg_epilogue_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int64, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, eps_c, eps_u, out, delta, w: float) -> int:
    """Launch the kernel on the current stream; returns the CUDA error code
    of the launch (0 = launched). eps_c/eps_u/out are contiguous CUDA
    tensors of one dtype, delta a contiguous float32 tensor of the same
    shape or None (checked by the caller)."""
    stream = torch.cuda.current_stream(eps_c.device).cuda_stream
    return lib.cfg_epilogue_launch(
        _DTYPE_CODES[eps_c.dtype], eps_c.data_ptr(), eps_u.data_ptr(),
        out.data_ptr(), None if delta is None else delta.data_ptr(),
        eps_c.numel(), w, stream)
