"""The tile walk of kernel K6's bf16 body and the chunked algebra of kernel
K7's scan body, on the CPU.

K6 (causal / sliding-window flash attention with a meta-token prefix) visits
only the key tiles a query tile can see and applies the per-element mask
only in the tiles that need it; ``flash_attention.tile_classes`` is the
Python mirror of that classification (skipped, full, masked). These tests
hold it exactly to ``ref.flash_mask``: every visible (row, key) pair lies in
a visited tile, and no full tile holds a hidden pair (keys past T count as
hidden), over a grid of lengths, masks and prefixes that includes Hymba's,
at the 128-key tiles of head dims up to 128 and the 64-key tiles of head
dim 256 (gemma-2b).

K7 runs the Mamba recurrence as a scan over time: chunks of 128 steps, 32
lanes of 4 steps each, the lanes' composites combined by a shuffle scan and
the state carried from chunk to chunk. ``ref.ssm_scan_chunked_ref`` is that
decomposition in PyTorch; these tests hold it to ``ref.ssm_scan_ref`` and to
the JAX package (its Pallas scan in interpret mode; with a start state,
``mamba.ssm_scan_ref``) at 5e-5, at the chunk's edges, and show that the
bar rejects the planted chunk-boundary faults the card checks use. The
kernels themselves run in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

BAR = dict(rtol=0.0, atol=5e-5)

# ----------------------------------------------------------------------
# K6: the tile walk
# ----------------------------------------------------------------------

# (S, T): Hymba's prefill, lengths aligned to no tile, S != T both ways, a
# single row, one tile and one key past it
LENGTHS = [(2048, 2048), (200, 200), (130, 130), (96, 160), (160, 96),
           (75, 75), (1, 1), (129, 257), (384, 384)]
# (causal, window, prefix_len): Hymba's mask, causal only, windows narrower
# than a tile, mid-tile and tile-aligned, a prefix overlapping the window,
# a prefix longer than a tile, non-causal windows
MASKS = [(True, 1024, 128), (True, 0, 0), (True, 48, 8), (True, 128, 0),
         (True, 100, 200), (True, 64, 130), (False, 0, 0), (False, 40, 0),
         (False, 100, 8)]


def _blocks(mask, bq, bk, fill):
    """[n_qt, n_kt, bq, bk] blocks of a [S, T] mask, padded with ``fill``."""
    S, T = mask.shape
    n_qt, n_kt = -(-S // bq), -(-T // bk)
    padded = torch.full((n_qt * bq, n_kt * bk), fill, dtype=torch.bool)
    padded[:S, :T] = mask
    return padded.reshape(n_qt, bq, n_kt, bk).transpose(1, 2)


def _check_tile_classes(S, T, causal, window, prefix, bk):
    mask = ref.flash_mask(S, T, causal=causal, window=window,
                          prefix_len=prefix)
    classes = torch.tensor(fa.tile_classes(S, T, causal, window, prefix,
                                           k_tile=bk))
    bq = fa.QUERY_TILE
    assert classes.shape == (-(-S // bq), -(-T // bk))
    # rows past S pad as "no pair"; keys past T as hidden
    any_visible = _blocks(mask, bq, bk, False).flatten(2).any(-1)
    row_real = torch.arange(-(-S // bq) * bq).reshape(-1, 1, bq, 1) < S
    hidden = (~_blocks(mask, bq, bk, False)) & row_real
    any_hidden = hidden.flatten(2).any(-1)
    visited = classes != fa.SKIPPED
    assert not (any_visible & ~visited).any(), "a visible pair in a skipped tile"
    assert not (any_hidden & (classes == fa.FULL)).any(), "a hidden pair in a full tile"
    # what the kernel computes: masked tiles per element, full tiles whole
    effective = torch.zeros_like(any_visible[..., None, None].expand(-1, -1, bq, bk))
    effective = torch.where((classes == fa.FULL)[..., None, None], True, effective)
    effective = torch.where((classes == fa.MASKED)[..., None, None],
                            _blocks(mask, bq, bk, False), effective)
    got = effective.transpose(1, 2).reshape(classes.shape[0] * bq, -1)[:S, :T]
    assert torch.equal(got, mask)


def _check_walk_order(S, T, causal, window, prefix, bk):
    bq = fa.QUERY_TILE
    for qt, row in enumerate(fa.tile_classes(S, T, causal, window, prefix,
                                             k_tile=bk)):
        q0 = qt * bq
        walk = fa.tile_walk(T, causal, window, prefix, q0, min(q0 + bq, S), bk)
        assert walk == sorted(set(walk))
        assert walk == [kt for kt, c in enumerate(row) if c != fa.SKIPPED]


@pytest.mark.parametrize("S,T", LENGTHS)
@pytest.mark.parametrize("causal,window,prefix", MASKS)
def test_k6_tile_classes_match_the_mask(S, T, causal, window, prefix):
    _check_tile_classes(S, T, causal, window, prefix, fa.KEY_TILE)


@pytest.mark.parametrize("S,T", LENGTHS)
@pytest.mark.parametrize("causal,window,prefix", MASKS)
def test_k6_tile_classes_match_the_mask_at_hd_256(S, T, causal, window, prefix):
    """Head dim 256's 64-key tiles (two to a query tile's 128 rows)."""
    assert fa.key_tile(256) == 64 and fa.key_tile(128) == fa.KEY_TILE
    _check_tile_classes(S, T, causal, window, prefix, fa.key_tile(256))


@pytest.mark.parametrize("S,T", LENGTHS)
@pytest.mark.parametrize("causal,window,prefix", MASKS)
def test_k6_tile_walk_order(S, T, causal, window, prefix):
    """Each query tile visits its prefix tiles, then its window's tiles in
    ascending order, each once, and nothing else (at both key tiles)."""
    for bk in (fa.KEY_TILE, fa.key_tile(256)):
        _check_walk_order(S, T, causal, window, prefix, bk)


def test_k6_gemma_walk_is_the_reckoned_one():
    """gemma-2b's causal prefill (S = T = 2048) at 64-key tiles: query tile
    i visits 2i + 2 tiles (272 a head), and only the two that cross its
    diagonal take the mask."""
    classes = fa.tile_classes(2048, 2048, True, 0, 0, k_tile=fa.key_tile(256))
    visited = [sum(c != fa.SKIPPED for c in row) for row in classes]
    masked = [sum(c == fa.MASKED for c in row) for row in classes]
    assert visited == [2 * i + 2 for i in range(16)] and sum(visited) == 272
    assert masked == [2] * 16


def test_k6_hymba_walk_is_the_reckoned_one():
    """Hymba's prefill mask (S = T = 2048, window 1024, prefix 128): 115 key
    tiles a head, at most 10 a block, the masked ones the diagonal, the
    window's lower edge and nothing else (PERF.md's wave reckoning)."""
    classes = fa.tile_classes(2048, 2048, True, 1024, 128)
    visited = [sum(c != fa.SKIPPED for c in row) for row in classes]
    masked = [sum(c == fa.MASKED for c in row) for row in classes]
    assert sum(visited) == 115 and max(visited) == 10
    assert visited == [1, 2, 3, 4, 5, 6, 7, 8, 9] + [10] * 7
    assert masked == [1] * 9 + [2] * 7


# ----------------------------------------------------------------------
# K7: the chunked scan
# ----------------------------------------------------------------------

CHUNK = ss.SCAN_CHUNK


def _scan_inputs(S, B=1, Di=40, N=16, seed=5):
    """x, dt (a softplus, as Mamba's delta), B_t and C_t as strided halves
    of one projection, A negative, D and a nonzero h0 (numpy, fp32). Di 40
    fills no 8-channel group of the kernel."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, Di)
    dt = np.log1p(np.exp(f(B, S, Di) - 2.0)).astype(np.float32)
    bc = f(B, S, 2 * N)
    a = -np.exp(0.5 * f(Di, N)).astype(np.float32)
    return x, dt, bc[..., :N], bc[..., N:], a, f(Di), f(B, Di, N)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **BAR)


@pytest.mark.parametrize("S", [1, CHUNK - 1, CHUNK, CHUNK + 1, 2048])
@pytest.mark.parametrize("with_h0", [False, True])
def test_k7_chunked_scan_matches_ref_and_jax(S, with_h0):
    x, dt, b, c, a, d, h0 = _scan_inputs(S)
    h0 = h0 if with_h0 else None
    t = lambda *arrs: [None if z is None else torch.from_numpy(np.ascontiguousarray(z))
                       for z in arrs]
    tb = torch.from_numpy(np.concatenate([b, c], -1))   # strided halves, as on the path
    N = b.shape[-1]
    tx, tdt, ta, td, th0 = t(x, dt, a, d, h0)
    y, h = ref.ssm_scan_chunked_ref(tx, tdt, tb[..., :N], tb[..., N:], ta, td, th0,
                                    chunk=CHUNK)
    wy, wh = ref.ssm_scan_ref(tx, tdt, tb[..., :N], tb[..., N:], ta, td, th0)
    _close(y, wy)
    _close(h, wh)
    j = lambda *arrs: [jnp.asarray(z) for z in arrs]
    if h0 is None:      # the TPU kernel's function (interpret mode)
        _close(y, jops.ssm_scan(*j(x, dt, b, c, a, d)))
    else:               # the reference's Mamba scan, from h0
        jy, jh = jmamba.ssm_scan_ref(*j(x, b, c, dt, a, d, h0))
        _close(y, jy)
        _close(h, jh)


@pytest.mark.parametrize("chunk", [32, 64, 96, 256])
def test_k7_chunked_scan_any_chunk(chunk):
    """The chunk length is an argument: other chunks give the same
    function."""
    x, dt, b, c, a, d, h0 = map(torch.from_numpy, _scan_inputs(200, B=2))
    y, h = ref.ssm_scan_chunked_ref(x, dt, b, c, a, d, h0, chunk=chunk)
    wy, wh = ref.ssm_scan_ref(x, dt, b, c, a, d, h0)
    _close(y, wy)
    _close(h, wh)


@pytest.mark.parametrize("S", [CHUNK + 1, 2048])
@pytest.mark.parametrize("fault", ref.SCAN_FAULTS)
def test_k7_bar_rejects_chunk_boundary_faults(S, fault):
    """The carry dropped at the first chunk boundary, or entering it without
    its decay, puts y (and the final state, unless the sequence decays it
    away) outside the 5e-5 bar."""
    x, dt, b, c, a, d, h0 = map(torch.from_numpy, _scan_inputs(S))
    want = ref.ssm_scan_ref(x, dt, b, c, a, d, h0)
    bad = ref.ssm_scan_chunked_ref(x, dt, b, c, a, d, h0, chunk=CHUNK, fault=fault)
    within = [torch.allclose(g, w, **BAR) for g, w in zip(bad, want)]
    assert not all(within), fault
    with pytest.raises(ValueError, match="not one of"):
        ref.ssm_scan_chunked_ref(x, dt, b, c, a, d, fault="carry lost")
