"""Classifier-free-guidance epilogue (kernel K3) on Hopper: the ctypes
binding of ``csrc/cfg_epilogue.cu``.

Reference: ``repro.kernels.cfg_epilogue.cfg_epilogue_2d``, the TPU kernel it
replaces. In one elementwise pass over the two guidance branches it writes
the combine ``eps_u + w * (eps_c - eps_u)`` in eps's dtype and the guidance
direction ``eps_c - eps_u`` in float32, each branch read once. The TPU form
works on padded ``[M, 128]`` tiles, one lane at a time under the serving
engine's lane vmap; this one on the flat element count of a whole lane
group, each lane with its own scale: ``w`` a number, or a device vector of
one fp32 scale a lane (``lane_n`` elements each).

This module only marshals arguments; :func:`repro_torch.kernels.ops.
cfg_epilogue` is the public wrapper that validates inputs, picks the plain
version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of the entry points."""
    fn = lib.cfg_epilogue_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cfg_epilogue_empty_launch.argtypes = [ctypes.c_void_p]
    lib.cfg_epilogue_empty_launch.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, eps_c, eps_u, out, delta, scales, lane_n: int,
           w: float) -> int:
    """Launch the kernel on the current stream of eps's card; returns the
    CUDA error code of the launch (0 = launched). eps_c/eps_u/out are
    contiguous CUDA tensors of one dtype, delta a contiguous float32 tensor
    of the same shape or None; scales None (every element takes ``w``) or a
    float32 vector on the same card, element i taking
    ``scales[i // lane_n]`` (checked by the caller)."""
    # the current stream's handle without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(eps_c.device.index)
    return lib.cfg_epilogue_launch(
        _DTYPE_CODES[eps_c.dtype], eps_c.data_ptr(), eps_u.data_ptr(),
        out.data_ptr(), None if delta is None else delta.data_ptr(),
        eps_c.numel(), None if scales is None else scales.data_ptr(),
        lane_n, w, stream)


def launch_empty(lib: ctypes.CDLL, device) -> int:
    """One empty kernel on the current stream of ``device``: the card's
    launch floor, which K3's time is read against. Not counted as K3."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return lib.cfg_epilogue_empty_launch(
        torch._C._cuda_getCurrentRawStream(index))
