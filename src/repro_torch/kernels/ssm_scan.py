"""Selective-SSM (Mamba) scan on Hopper (kernel K7): the ctypes binding of
``csrc/ssm_scan.cu``.

Reference: ``repro.kernels.ssm_scan.ssm_scan_chunked``, the TPU kernel it
replaces. The CUDA kernel runs the same fp32 recurrence; it can also start
from a state ``h0`` and write the final state, as Mamba's prefill and decode
need. Sequences longer than :data:`SEQ_MAX_S` run a scan parallel over
time: chunks of :data:`SCAN_CHUNK` steps, a warp per channel, each lane
composing :data:`SCAN_ITEMS` consecutive steps' affine maps, a shuffle scan
across the lanes and the state carried from chunk to chunk
(``ref.ssm_scan_chunked_ref`` is the same decomposition in PyTorch);
shorter ones (decode's S = 1) a lane per state stepping through time.

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

#: the scan's shape (``kSeqMaxS``, ``kScanChunk`` and ``kItems`` in
#: ``csrc/ssm_scan.cu``; checked at bind time): the longest sequence the
#: sequential body takes, the chunk of the scan body, the steps a lane owns
SEQ_MAX_S, SCAN_CHUNK, SCAN_ITEMS = 16, 128, 4



def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of the entry points, and check that the
    library's scan shape is the one this module names."""
    lib.ssm_scan_shape.argtypes = [ctypes.c_int]
    lib.ssm_scan_shape.restype = ctypes.c_int
    shape = tuple(lib.ssm_scan_shape(i) for i in range(3))
    if shape != (SEQ_MAX_S, SCAN_CHUNK, SCAN_ITEMS):
        raise RuntimeError(f"the library's K7 shape {shape} is not "
                           f"{(SEQ_MAX_S, SCAN_CHUNK, SCAN_ITEMS)}")
    lib.ssm_scan_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
        + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.ssm_scan_launch.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, x, dt, b_t, c_t, a, d_skip, h0, y, h_final) -> int:
    """Launch K7 on the current stream of x's card; returns the CUDA error
    code of the launch (0 = launched). x/dt/y [B, S, Di] and b_t/c_t
    [B, S, N] share a dtype and have a contiguous last dim; a [Di, N],
    d_skip [Di] and h0 / h_final [B, Di, N] (either may be None) are
    contiguous float32 (checked by the caller)."""
    B, S, Di = x.shape
    strides = [st for t in (x, dt, b_t, c_t, y) for st in t.stride()[:2]]
    # the current stream's handle without building a torch.cuda.Stream
    # (torch.cuda.current_stream(device).cuda_stream): a few µs a call
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    return lib.ssm_scan_launch(
        _DTYPE_CODES[x.dtype], b_t.shape[-1],
        *(None if t is None else t.data_ptr()
          for t in (x, dt, b_t, c_t, a, d_skip, h0, y, h_final)),
        (ctypes.c_int64 * len(strides))(*strides), B, S, Di, stream)
