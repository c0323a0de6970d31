"""Causal / sliding-window flash attention on Hopper (kernel K6): the ctypes
binding of ``csrc/flash_attention.cu``, and the Python mirror of its tile
walk.

Reference: ``repro.kernels.flash_attention.flash_attention_bhsd``, the TPU
kernel it replaces. The CUDA kernel reads K/V heads in place for GQA (query
head h reads KV head h // (H/K)), takes the ``prefix_len`` always-visible
leading keys of Hymba's meta tokens as a launch argument, and bounds its
key loop by T, so nothing is repeated or padded. bf16 inputs run the TMA +
``wgmma`` pipeline that K1 shares (``csrc/hopper_tiles.cuh``) over the key
tiles :func:`tile_classes` describes (:func:`key_tile` keys a tile: 128,
or 64 at head dim 256); float32 inputs a CUDA-core FMA body.

This module only marshals arguments; :func:`repro_torch.kernels.ops.
flash_attention` is the public wrapper that validates inputs, picks the
plain version for CPU tensors and counts launches.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

#: head dims the CUDA source instantiates: 64 (Hymba-1.5B and every reduced
#: LM), 128 (yi-9b, minitron-8b, llama3-405b, internvl2-76b, olmoe-1b-7b,
#: deepseek-moe-16b) and 256 (gemma-2b)
SUPPORTED_HEAD_DIMS = (64, 128, 256)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: query rows of a block and keys of a tile up to head dim 128 in the bf16
#: body (``kBQ`` and ``kBK`` in ``csrc/hopper_tiles.cuh``; checked at bind
#: time)
QUERY_TILE = KEY_TILE = 128
SKIPPED, FULL, MASKED = 0, 1, 2


def key_tile(hd: int) -> int:
    """Keys of a bf16 tile at head dim ``hd`` (``HeadTiles<HD>::BK``): 64
    above head dim 128, where a 128-key tile's scores would not fit a
    consumer thread's registers beside the output."""
    return 64 if hd > 128 else KEY_TILE


def tile_walk(T: int, causal: bool, window: int, prefix_len: int, q0: int,
              q1: int, tile: int = KEY_TILE) -> List[int]:
    """The key tiles (of ``tile`` keys) query rows ``[q0, q1)`` visit, in
    the kernel's order: the tiles holding prefix keys, then the window's
    tiles up to the diagonal (``tile_walk`` in ``csrc/flash_attention.cu``).
    The tiles left out hold no key any of the rows sees."""
    nt = -(-T // tile)
    end = min(nt, (q1 - 1) // tile + 1) if causal else nt
    if window <= 0:
        return list(range(end))
    n_prefix = min(-(-prefix_len // tile), end)
    first = max(max(0, q0 - window + 1) // tile, n_prefix)
    return list(range(n_prefix)) + list(range(first, end))


def tile_full(T: int, causal: bool, window: int, prefix_len: int, q0: int,
              q1: int, c0: int, tile: int = KEY_TILE) -> bool:
    """Whether every pair of a row in ``[q0, q1)`` and a key in ``[c0, c0 +
    tile)`` is visible, so the kernel applies no per-element mask there
    (``tile_full`` in ``csrc/flash_attention.cu``)."""
    if c0 + tile > T or (causal and c0 + tile - 1 > q0):
        return False
    lo = max(c0, prefix_len)                 # the tile's first non-prefix key
    return window <= 0 or lo >= c0 + tile or lo > q1 - 1 - window


def tile_classes(S: int, T: int, causal: bool, window: int = 0,
                 prefix_len: int = 0, q_tile: int = QUERY_TILE,
                 k_tile: int = KEY_TILE) -> List[List[int]]:
    """How the bf16 body treats each key tile in each query tile's block
    (query tiles in row order): :data:`SKIPPED`, :data:`FULL` (visited, no
    mask) or :data:`MASKED` (visited, the per-element test). The C entry
    point ``flash_attention_tile_class`` gives the same from the kernel's
    own functions."""
    out = []
    for q0 in range(0, S, q_tile):
        q1 = min(q0 + q_tile, S)
        row = [SKIPPED] * -(-T // k_tile)
        for kt in tile_walk(T, causal, window, prefix_len, q0, q1, k_tile):
            row[kt] = FULL if tile_full(T, causal, window, prefix_len, q0, q1,
                                        kt * k_tile, k_tile) else MASKED
        out.append(row)
    return out


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of the entry points, and check that the
    library's tiles at each head dim are the ones :func:`tile_classes`
    computes for."""
    lib.flash_attention_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_tile.restype = ctypes.c_int
    for hd in SUPPORTED_HEAD_DIMS:
        tiles = (lib.flash_attention_tile(hd, 0), lib.flash_attention_tile(hd, 1))
        if tiles != (QUERY_TILE, key_tile(hd)):
            raise RuntimeError(f"the library's K6 tiles {tiles} at head dim "
                               f"{hd} are not ({QUERY_TILE}, {key_tile(hd)})")
    lib.flash_attention_tile_class.argtypes = [ctypes.c_int] * 8
    lib.flash_attention_tile_class.restype = ctypes.c_int
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
