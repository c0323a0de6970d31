"""Stale-KV patch attention on Hopper (kernels K1, K2, K4 and K5): the ctypes
binding of ``csrc/stale_kv_attention.cu``.

Reference: ``repro.kernels.stale_kv_attention.stale_kv_attention_bhsd`` (K1),
``stale_kv_attention_padded_bhsd`` (K2), ``lse_attention_bhsd`` (K4) and
``stale_kv_attention_guided_bhsd`` (K5), the TPU kernels they replace. K4 is
the same body over one ring segment of the sequence-parallel executor: every
key from one source, the key loop ending at the run-time ``valid_len``, and
an fp32 log-sum-exp written beside the normalized output. K2 is K1 for the multi-rank executors:
the slab is padded to the largest patch, only its first ``valid_tokens``
rows are fresh, and the stale buffer's scratch tail (keys from ``n_tokens``
on) is masked; ``tok_start`` and ``valid_tokens`` are launch arguments, so
one build serves every rank. K5 is K2 over both guidance branches, the
unconditional one fresh only when ``uncond_fresh``; it runs as K2 at batch
2B with a fresh-row count per branch. Q comes from the local fresh patch; keys and values
for the whole image come from the stale buffer except the patch's own rows,
which come from the fresh K/V of this step. Without a causal mask the order
of the keys does not matter, so the bf16 kernel walks them as at most three
runs, each from one source (:func:`key_runs`), and needs no tile alignment
of ``tok_start`` (the TPU form selected per block and refused unaligned
layouts). bf16 inputs run a tensor-core body (TMA loads, ``wgmma``, the
probabilities fed to P·V as two bf16 terms so it keeps them to about 16
bits), float32 inputs a CUDA-core FMA body that keeps full fp32 precision.

This module only marshals arguments; :func:`repro_torch.kernels.ops.
stale_kv_attention`, ``stale_kv_attention_padded``,
``stale_kv_attention_guided`` and ``lse_attention`` are the public wrappers that validate inputs,
pick the plain version for CPU tensors and count launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

#: head dims the CUDA source instantiates (tiny-dit and its reduced form: 32;
#: sdxl-dit: 72)
SUPPORTED_HEAD_DIMS = (32, 72)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


#: keys per tile of the bf16 body (``kBK`` in the CUDA source; checked at
#: bind time)
KEY_TILE = 128
STALE, FRESH = 0, 1
MAX_RUNS = 3


class Run(NamedTuple):
    """``length`` keys read from rows ``first ..`` of one source."""
    source: int          # STALE or FRESH
    first: int
    length: int


def key_runs(n_keys: int, tok_start: int = 0, fresh: int = 0) -> Tuple[Run, ...]:
    """The keys ``0 .. n_keys`` of the context as runs of one source each:
    stale ``[0, tok_start)``, fresh rows ``[0, fresh)`` standing at
    ``tok_start ..``, stale from ``tok_start + fresh`` on; a fresh row at or
    past ``n_keys`` is masked like any key there. Empty runs are dropped.

    K1: ``key_runs(N, tok_start, Nl)``; K2: ``key_runs(n_tokens, tok_start,
    valid_tokens)``; K5: that per branch, the unconditional one with
    ``valid_tokens * uncond_fresh``; K4: ``key_runs(valid_len)``. Attention
    over the runs' keys in this order is attention over the context, since
    no mask depends on the keys' order."""
    end = min(tok_start + fresh, n_keys)
    runs = (Run(STALE, 0, min(tok_start, n_keys)),
            Run(FRESH, 0, max(0, end - tok_start)),
            Run(STALE, tok_start + fresh, max(0, n_keys - tok_start - fresh)))
    return tuple(r for r in runs if r.length > 0)


def tile_origin(run: Run, tile: int = KEY_TILE) -> int:
    """Source row of the first key of the run's first tile. A run that
    starts at row 0 is tiled back from its end, any other forward from its
    start, so the ragged part of its partial tile lies outside the source's
    rows (negative, or past the last real key), where TMA reads nothing and
    writes zeros; the kernel masks it by key index."""
    if run.first == 0:
        return run.length - -(-run.length // tile) * tile
    return run.first


def _runs_arg(*classes: Sequence[Run]):
    """The kernel's ``runs`` argument: for batch rows below ``b_split``,
    then for the rest (the first class again when one is given), a count
    and (source, first, length, origin) per run, 26 int."""
    flat = []
    for runs in (classes * 2)[:2]:
        flat.append(len(runs))
        for i in range(MAX_RUNS):
            r = runs[i] if i < len(runs) else Run(STALE, 0, 0)
            flat += [r.source, r.first, r.length, tile_origin(r) if r.length else 0]
    return (ctypes.c_int * len(flat))(*flat)


@functools.lru_cache(maxsize=1024)
def _layout_runs_arg(*layouts: Tuple[int, int, int]):
    """:func:`_runs_arg` of ``key_runs(*layout)`` per batch-row class, kept
    per layout: a path repeats a few layouts thousands of times, and
    building the argument costs more host time than the kernel's launch."""
    return _runs_arg(*(key_runs(*layout) for layout in layouts))


_COMMON = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C signatures of the four entry points, and check that the
    library's key tile is the one :func:`tile_origin` computes for."""
    lib.stale_kv_attention_key_tile.restype = ctypes.c_int
    if lib.stale_kv_attention_key_tile() != KEY_TILE:
        raise RuntimeError(f"the library's key tile "
                           f"{lib.stale_kv_attention_key_tile()} is not KEY_TILE "
                           f"{KEY_TILE}")
    for name, n_ints in (("stale_kv_attention_launch", 5),
                         ("stale_kv_attention_padded_launch", 6),
                         ("stale_kv_attention_guided_launch", 7)):
        fn = getattr(lib, name)
        fn.argtypes = (_COMMON + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.lse_attention_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.lse_attention_launch.restype = ctypes.c_int


def _pointers_and_strides(*tensors):
    """Data pointers, then the (b, s, h) element strides of every tensor."""
    strides = [st for t in tensors for st in t.stride()[:3]]
    return ([t.data_ptr() for t in tensors],
            (ctypes.c_int64 * len(strides))(*strides))


def launch(lib: ctypes.CDLL, q, k_fresh, v_fresh, k_stale, v_stale,
           out, tok_start: int, scale: float) -> int:
    """Launch K1 on the current stream; returns the CUDA error code of the
    launch (0 = launched). All tensors are [B, S, H, hd] CUDA tensors of one
    dtype with a contiguous last dim (checked by the caller)."""
    B, Nl, H, hd = q.shape
    ptrs, strides = _pointers_and_strides(q, k_fresh, v_fresh, k_stale,
                                          v_stale, out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return lib.stale_kv_attention_launch(
        _DTYPE_CODES[q.dtype], hd, *ptrs, strides,
        _layout_runs_arg((k_stale.shape[1], tok_start, Nl)), B, H, Nl,
        k_stale.shape[1], tok_start, scale, stream)


def launch_padded(lib: ctypes.CDLL, q, k_fresh, v_fresh, k_stale, v_stale,
                  out, tok_start: int, valid_tokens: int, n_tokens: int,
                  scale: float) -> int:
    """Launch K2: q/fresh/out [B, Nl_max, H, hd], stale [B, Npad, H, hd]."""
    B, Nl, H, hd = q.shape
    ptrs, strides = _pointers_and_strides(q, k_fresh, v_fresh, k_stale,
                                          v_stale, out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return lib.stale_kv_attention_padded_launch(
        _DTYPE_CODES[q.dtype], hd, *ptrs, strides,
        _layout_runs_arg((n_tokens, tok_start, valid_tokens)), B, H, Nl,
        n_tokens, tok_start, valid_tokens, scale, stream)


def launch_guided(lib: ctypes.CDLL, q, k_fresh, v_fresh, k_stale, v_stale,
                  out, tok_start: int, valid_tokens: int, uncond_fresh: int,
                  n_tokens: int, scale: float) -> int:
    """Launch K5 on the branch-folded views: q/fresh/out [2B, Nl_max, H, hd],
    stale [2B, Npad, H, hd], the conditional branch's B rows first."""
    B2, Nl, H, hd = q.shape
    ptrs, strides = _pointers_and_strides(q, k_fresh, v_fresh, k_stale,
                                          v_stale, out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return lib.stale_kv_attention_guided_launch(
        _DTYPE_CODES[q.dtype], hd, *ptrs, strides,
        _layout_runs_arg((n_tokens, tok_start, valid_tokens),
                         (n_tokens, tok_start, valid_tokens * uncond_fresh)),
        B2 // 2, H, Nl, n_tokens, tok_start, valid_tokens, uncond_fresh, scale,
        stream)


def launch_lse(lib: ctypes.CDLL, q, k, v, out, lse, valid_len: int,
               scale: float) -> int:
    """Launch K4: q/out [B, Sq, H, hd], k/v [B, T, H, hd] (their first
    ``valid_len`` keys real), lse [B, Sq, H] float32."""
    B, Sq, H, hd = q.shape
    ptrs, strides = _pointers_and_strides(q, k, v, out, lse)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return lib.lse_attention_launch(
        _DTYPE_CODES[q.dtype], hd, *ptrs, strides,
        _layout_runs_arg((valid_len, 0, 0)), B, H, Sq, valid_len, scale, stream)
