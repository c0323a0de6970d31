"""The port's DiT against the reference's on the same weights (carried by
the bridge) and the same inputs: per-forward parity with and without stale
buffers on nondegenerate params, at fp32 ``atol=1e-5`` (the reference's own
per-forward bar), with the reference's Pallas kernel both off and on
(interpret mode on the CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.diffusion import dit as tdit  # noqa: E402

BAR = dict(rtol=0.0, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-dit").reduced()      # 16x16 latent, 8 token rows
    jparams = jdit.nondegenerate_params(jdit.init_params(jax.random.PRNGKey(0),
                                                         jcfg))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                     device="cpu")
    tcfg = DiTConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    shape = jdit.buffer_shape(jcfg, 2)
    bk = rng.standard_normal(shape).astype(np.float32)
    bv = rng.standard_normal(shape).astype(np.float32)
    return jcfg, jparams, tcfg, tparams, x, bk, bv


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("rows,buffered,pallas", [
    ((0, 16), False, False),        # the full image: exact single-device forward
    ((4, 12), False, False),        # a patch attending to itself only
    ((4, 12), True, False),         # stale buffers, reference rewrite path
    ((4, 12), True, True),          # stale buffers, reference Pallas kernel
    ((10, 16), True, True),         # last patch, 8-token kernel tiles
])
def test_forward_patch_parity(model, rows, buffered, pallas):
    jcfg, jparams, tcfg, tparams, x, bk, bv = model
    jcfg = jcfg.replace(use_pallas_attention=pallas)
    lo, hi = rows
    row_start = lo // jcfg.patch_size
    cond = np.array([1, tdit.NULL_COND])           # a class and the null class
    jbuf = (jnp.asarray(bk), jnp.asarray(bv)) if buffered else None
    tbuf = (torch.from_numpy(bk), torch.from_numpy(bv)) if buffered else None
    eps_j, kv_j = jdit.forward_patch(jparams, jcfg, jnp.asarray(x[:, lo:hi]),
                                     37, jnp.asarray(cond), row_start,
                                     buffers=jbuf)
    eps_t, kv_t = tdit.forward_patch(tparams, tcfg, torch.from_numpy(x[:, lo:hi]),
                                     37, torch.from_numpy(cond), row_start,
                                     buffers=tbuf)
    np.testing.assert_allclose(_np(eps_t), _np(eps_j), **BAR)
    for a, b in zip(kv_t, kv_j):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), **BAR)


def test_forward_and_degenerate_init_shapes(model):
    """Untrained (adaLN-zero) params: eps is exactly zero in both packages,
    and the port's own init draws the reference's leaf names and shapes."""
    jcfg, _, tcfg, _, x, _, _ = model
    jp = jdit.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tdit.init_params(torch.Generator().manual_seed(0), tcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    shapes_j = {jax.tree_util.keystr(k): v.shape for k, v in flat_j}
    shapes_t = {f"['blocks']['{k}']": tuple(v.shape)
                for k, v in tp["blocks"].items()}
    shapes_t.update({f"['{k}']": tuple(v.shape) for k, v in tp.items()
                     if k != "blocks"})
    assert shapes_t == shapes_j
    eps = tdit.forward(tp, tcfg, torch.from_numpy(x), 5, torch.tensor([0, 1]))
    assert torch.count_nonzero(eps) == 0
    nd = tdit.nondegenerate_params(tp, torch.Generator().manual_seed(7))
    assert all(nd["blocks"][k].dtype == tp["blocks"][k].dtype for k in tp["blocks"])
    assert torch.count_nonzero(tdit.forward(nd, tcfg, torch.from_numpy(x), 5)) > 0


def test_building_blocks_parity():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    tok = tdit.patchify(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(_np(tok), np.asarray(jdit.patchify(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(_np(tdit.unpatchify(tok, 2, 4, 3, 3)), x)
    np.testing.assert_allclose(_np(tdit.pos_embed_2d(4, 3, 16)),
                               np.asarray(jdit.pos_embed_2d(4, 3, 16)), **BAR)
    t = np.array([0.0, 37.0, 999.0], np.float32)
    np.testing.assert_allclose(
        _np(tlayers.sinusoidal_embedding(torch.from_numpy(t), 256)),
        np.asarray(jlayers.sinusoidal_embedding(jnp.asarray(t), 256)),
        rtol=0.0, atol=2e-4)          # cos/sin of args up to 999 rad in f32
    q, k, v = (rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((2, 1, 5, 5)) > 0.3
    mask[..., 0] = True
    np.testing.assert_allclose(
        _np(tlayers.attend(*map(torch.from_numpy, (q, k, v)),
                           mask=torch.from_numpy(mask))),
        np.asarray(jlayers.attend(*map(jnp.asarray, (q, k, v)),
                                  mask=jnp.asarray(mask))), **BAR)
    x = rng.standard_normal((3, 7)).astype(np.float32) * 4 + 1
    np.testing.assert_allclose(_np(tdit._ln(torch.from_numpy(x))),
                               np.asarray(jdit._ln(jnp.asarray(x))), **BAR)


def test_block_stack_refuses_later_slices(model):
    _, _, tcfg, tparams, *_ = model
    h = torch.zeros(1, 8, tcfg.d_model)
    c = torch.zeros(1, tcfg.d_model)
    for kw in ({"enable": torch.ones(2, dtype=torch.bool)},
               {"prompt_ctx": (h, None)}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdit.block_stack(tparams["blocks"], tcfg, h, c, 0, **kw)
    # attend_fn is ported (the sequence-parallel slice): it receives the
    # blended context, a copy, and what it returns is the attention
    L, H = tcfg.n_layers, tcfg.n_heads
    hd = tcfg.d_model // H
    bk = torch.randn(L, 1, tcfg.n_tokens, H, hd)
    seen = []

    def attend_fn(q, full_k, full_v, key_mask):
        seen.append((full_k.shape, key_mask))
        return torch.zeros_like(q)
    tdit.block_stack(tparams["blocks"], tcfg, h, c, 0, buffers=(bk, bk.clone()),
                     attend_fn=attend_fn)
    assert seen == [((1, tcfg.n_tokens, H, hd), None)] * L
    # ctx_tokens is ported (the frames slice): the scratch mask of a padded
    # 2N context ends at ctx_tokens, not at the image's n_tokens
    seen.clear()
    N2 = 2 * tcfg.n_tokens
    bk2 = torch.randn(L, 1, N2 + 8, H, hd)
    tdit.block_stack(tparams["blocks"], tcfg, h, c, 0, buffers=(bk2, bk2),
                     valid_tokens=8, attend_fn=attend_fn, ctx_tokens=N2)
    assert [int(m.sum()) for _, m in seen] == [N2] * L
