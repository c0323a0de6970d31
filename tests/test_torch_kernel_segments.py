"""The key runs of the bf16 stale-KV body (kernels K1, K2, K4, K5) on the
CPU. The kernel walks the keys of a launch as at most three runs, each read
from one source (``stale_kv_attention.key_runs``), in 128-key tiles from
``tile_origin``. These tests hold that arithmetic, the very numbers the
launch passes to the kernel, to the reference: the runs cover exactly the
keys the reference attends, in context order, with no stale row under the
fresh patch; no tile reads a real row outside its run; and attention over
the keys concatenated in run order matches the JAX package's plain
reference to 5e-5 (fp32). The kernel itself runs in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import stale_kv_attention as skv  # noqa: E402

BAR = dict(rtol=0.0, atol=5e-5)
FRESH, STALE, TILE = skv.FRESH, skv.STALE, skv.KEY_TILE

# K1 (N, Nl, tok_start): the main path's patches and warm-up, an unaligned
# layout, the patch at the context's start and at its end
K1_LAYOUTS = [(4096, 2304, 0), (4096, 1792, 2304), (4096, 4096, 0),
              (4096, 200, 72), (4096, 200, 0), (4096, 200, 3896)]
# K2 (n_tokens, Npad, Nl_max, tok_start, valid_tokens): the spmd rank
# layouts, valid 0, n_tokens cutting the slab, the slab at the end, and a
# buffer of exactly n_tokens rows
K2_LAYOUTS = [(4096, 6400, 2304, 0, 2304), (4096, 6400, 2304, 2304, 1792),
              (4096, 6400, 2304, 0, 1792), (4096, 6400, 2304, 1000, 0),
              (3000, 6400, 2304, 2304, 1792), (4096, 6400, 2304, 4096, 1792),
              (4096, 4096, 2304, 1792, 2304)]
K4_VALIDS = [0, 1, 896, 1001, 3200]


def _k2_runs(layout):
    n_tokens, _, _, tok, valid = layout
    return skv.key_runs(n_tokens, tok, valid)


def _expected(n_keys, tok, fresh):
    """(source, row) of every key the reference attends, in context order:
    fresh rows where the patch's valid rows cover the key, stale elsewhere,
    nothing from n_keys on."""
    return [(FRESH, t - tok) if tok <= t < tok + fresh else (STALE, t)
            for t in range(n_keys)]


def _run_keys(runs):
    return [(r.source, r.first + i) for r in runs for i in range(r.length)]


def _cases():
    """(name, n_keys, tok_start, fresh rows, runs) of every layout."""
    out = [(f"k1 {lay}", lay[0], lay[2], lay[1], skv.key_runs(*lay[:1], lay[2], lay[1]))
           for lay in K1_LAYOUTS]
    out += [(f"k2 {lay}", lay[0], lay[3], lay[4], _k2_runs(lay)) for lay in K2_LAYOUTS]
    for lay in K2_LAYOUTS[:3]:                       # K5's branches
        for uncond_fresh in (0, 1):
            out.append((f"k5 uncond {uncond_fresh} {lay}", lay[0], lay[3],
                        lay[4] * uncond_fresh,
                        skv.key_runs(lay[0], lay[3], lay[4] * uncond_fresh)))
    out += [(f"k4 {v}", v, 0, 0, skv.key_runs(v)) for v in K4_VALIDS]
    return out


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_runs_cover_the_attended_keys(case):
    _, n_keys, tok, fresh, runs = case
    assert 0 < len(runs) <= skv.MAX_RUNS or n_keys == 0
    assert all(r.length > 0 for r in runs)
    keys = _run_keys(runs)
    assert keys == _expected(n_keys, tok, fresh)
    assert not any(src == STALE and tok <= row < tok + fresh for src, row in keys)
    assert len({src for src, _ in keys}) <= 2 and all(
        r.source in (STALE, FRESH) for r in runs)


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_tiles_read_no_real_row_outside_their_run(case):
    """Every tile row outside its run lies outside the source's rows: a
    negative row, or (stale) a row from n_keys on. The kernel's maps have
    those extents, so TMA fills such rows with zeros and reads nothing."""
    _, n_keys, _, _, runs = case
    for run in runs:
        origin = skv.tile_origin(run)
        n_tiles = -(-(run.first + run.length - origin) // TILE)
        assert origin <= run.first and run.first - origin < TILE
        assert origin + n_tiles * TILE - (run.first + run.length) < TILE
        for row in range(origin, origin + n_tiles * TILE):
            if not run.first <= row < run.first + run.length:
                assert row < 0 or (run.source == STALE and row >= n_keys), (run, row)


def test_runs_argument_is_what_the_kernel_reads():
    """The 26 ints of the launch: per batch-row class a count and (source,
    first, length, origin) per run; one class given fills both."""
    a, b = skv.key_runs(4096, 72, 200), skv.key_runs(4096, 72, 0)
    for classes, want in (((a,), (a, a)), ((a, b), (a, b))):
        flat = list(skv._runs_arg(*classes))
        assert len(flat) == 2 * (1 + 4 * skv.MAX_RUNS)
        for c, runs in enumerate(want):
            row = flat[13 * c:13 * (c + 1)]
            assert row[0] == len(runs)
            for i, r in enumerate(runs):
                assert row[1 + 4 * i:5 + 4 * i] == [r.source, r.first, r.length,
                                                     skv.tile_origin(r)]
    assert list(skv._runs_arg(()))[0] == 0         # K4's empty segment


def _attend_runs(q, k_fresh, v_fresh, k_stale, v_stale, runs):
    """fp32 attention of q [S, hd] over the keys of ``runs`` concatenated
    in run order (the kernel's order)."""
    src_k, src_v = {FRESH: k_fresh, STALE: k_stale}, {FRESH: v_fresh, STALE: v_stale}
    k = torch.cat([src_k[r.source][r.first:r.first + r.length] for r in runs])
    v = torch.cat([src_v[r.source][r.first:r.first + r.length] for r in runs])
    s = (q @ k.T) * q.shape[-1] ** -0.5
    return s.softmax(-1) @ v


def _arrays(n_q, n_fresh, n_stale, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda n, std: (std * rng.standard_normal((n, hd))).astype(np.float32)
    return mk(n_q, 1.5), mk(n_fresh, 1.5), mk(n_fresh, 1.0), mk(n_stale, 1.5), mk(n_stale, 1.0)


def _jax_context(k_fresh, k_stale, tok, valid, n_tokens):
    """The reference's context of K2 (the SPMD branch of dit.block_stack):
    the slab's rows past valid blended back to the buffer's, the slab
    written at tok_start, keys from n_tokens on dropped (masked keys weigh
    exactly 0)."""
    Nl = k_fresh.shape[0]
    cur = jax.lax.dynamic_slice_in_dim(k_stale, tok, Nl, axis=0)
    keep = (jnp.arange(Nl) < valid)[:, None]
    full = jax.lax.dynamic_update_slice_in_dim(k_stale, jnp.where(keep, k_fresh, cur),
                                               tok, axis=0)
    return full[:n_tokens]


def _jax_attend(q, k, v):
    bhsd = lambda x: jnp.asarray(x)[None, None]
    return np.asarray(jref.attention_ref(bhsd(q), bhsd(k), bhsd(v)))[0, 0]


@pytest.mark.parametrize("layout", K1_LAYOUTS, ids=str)
def test_k1_attention_in_run_order_matches_reference(layout):
    N, Nl, tok = layout
    arrs = _arrays(Nl, Nl, N)
    got = _attend_runs(*map(torch.from_numpy, arrs), skv.key_runs(N, tok, Nl))
    bhsd = [jnp.asarray(a)[None, None] for a in arrs]
    want = np.asarray(jref.stale_kv_attention_ref(*bhsd, tok))[0, 0]
    np.testing.assert_allclose(got.numpy(), want, **BAR)


@pytest.mark.parametrize("layout", K2_LAYOUTS, ids=str)
@pytest.mark.parametrize("uncond_fresh", [None, 0])
def test_k2_k5_attention_in_run_order_matches_reference(layout, uncond_fresh):
    """K2, and K5's unconditional branch when it is not fresh (its
    conditional branch and a fresh unconditional one are K2's layout)."""
    n_tokens, Npad, Nl, tok, valid = layout
    fresh = valid if uncond_fresh is None else valid * uncond_fresh
    q, kf, vf, ks, vs = _arrays(Nl, Nl, Npad, seed=1)
    got = _attend_runs(*map(torch.from_numpy, (q, kf, vf, ks, vs)),
                       skv.key_runs(n_tokens, tok, fresh))
    kc = _jax_context(jnp.asarray(kf), jnp.asarray(ks), tok, fresh, n_tokens)
    vc = _jax_context(jnp.asarray(vf), jnp.asarray(vs), tok, fresh, n_tokens)
    np.testing.assert_allclose(got.numpy(), _jax_attend(q, kc, vc), **BAR)


@pytest.mark.parametrize("valid", [v for v in K4_VALIDS if v], ids=str)
def test_k4_attention_in_run_order_matches_reference(valid):
    q, _, _, k, v = _arrays(300, 0, 3200, seed=2)
    got = _attend_runs(torch.from_numpy(q), None, None, torch.from_numpy(k),
                       torch.from_numpy(v), skv.key_runs(valid))
    np.testing.assert_allclose(got.numpy(), _jax_attend(q, k[:valid], v[:valid]), **BAR)
