"""The port's conv UNet (``repro_torch.models.diffusion.unet``) against the
reference's on the CPU, with the reference's weights carried through the
bridge (its levels are lists, its last ``downsample`` None): the forward
within 1e-5, the gradients of a loss within 1e-4 of each leaf's largest
gradient, XLA's "SAME" padding (at stride 2 on an even input (0, 1), not
(1, 1)) against ``lax.conv_general_dilated``, and a planted symmetric
stride-2 padding rejected by the forward's bar. ``tiny-unet`` at its
published widths (32 x 32 x 3, widths 32 / 64 / 64, attention at the last
level), fp32; the zero-initialised leaves get small draws so every path
carries signal."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.diffusion import UNetConfig as JUNetConfig  # noqa: E402
from repro.models.diffusion import unet as junet  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.diffusion import UNetConfig  # noqa: E402
from repro_torch.models.diffusion import unet as tunet  # noqa: E402

FORWARD_BAR = 1e-5
GRAD_BAR = 1e-4
ZERO_INIT = ("conv2", "out", "conv_out")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nondegenerate(params, key):
    """The zero-initialised convs and projections get 0.05 x N(0, 1)."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = jax.random.split(key, len(paths))
    out = []
    for (path, leaf), k in zip(paths, keys):
        name = getattr(path[-1], "key", None)
        out.append(0.05 * jax.random.normal(k, leaf.shape, leaf.dtype)
                   if name in ZERO_INIT else leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.fixture(scope="module")
def model():
    jcfg = JUNetConfig()
    jparams = jax.tree_util.tree_map(np.asarray, _nondegenerate(
        jax.jit(junet.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg),
        jax.random.PRNGKey(1)))
    tparams = bridge.params_from_jax(jparams, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([37.0, 610.0], np.float32)
    cond = np.array([3, 11])
    return jcfg, jparams, UNetConfig(), tparams, x, t, cond


def test_init_params_and_bridge_keep_the_reference_tree(model):
    jcfg, jparams, tcfg, tparams, _, _, _ = model
    own = tunet.init_params(torch.Generator().manual_seed(0), tcfg)
    want = str(jax.tree_util.tree_structure(jparams))
    assert tree_lib.treedef_str(own) == tree_lib.treedef_str(tparams) == want
    assert own["down"][-1]["downsample"] is None
    assert [tuple(t.shape) for t in tree_lib.leaves(own)] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(jparams)]
    back = bridge.params_to_numpy(tparams)
    for a, b in zip(tree_lib.leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size,kernel,stride", [
    (32, 3, 1), (32, 3, 2), (16, 3, 2), (8, 3, 1), (9, 3, 2), (7, 1, 1)])
def test_conv2d_same_padding_matches_xla(size, kernel, stride):
    rng = np.random.default_rng(size + kernel + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 5, 6)).astype(np.float32)
    want = np.asarray(junet.conv2d(jnp.asarray(x), jnp.asarray(w), stride))
    got = tunet.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0.0, atol=FORWARD_BAR)
    if stride == 2 and size % 2 == 0 and kernel == 3:
        assert tunet.same_padding(size, kernel, stride) == (0, 1)


@pytest.mark.parametrize("channels", [4, 32, 64])
def test_group_norm_matches_reference(channels):
    rng = np.random.default_rng(channels)
    x = (3.0 + rng.standard_normal((2, 8, 8, channels))).astype(np.float32)
    g = rng.standard_normal(channels).astype(np.float32)
    b = rng.standard_normal(channels).astype(np.float32)
    want = np.asarray(junet.group_norm(*map(jnp.asarray, (x, g, b))))
    got = tunet.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0.0, atol=FORWARD_BAR)


def _forward_both(model):
    jcfg, jparams, tcfg, tparams, x, t, cond = model
    want = np.asarray(jax.jit(junet.forward, static_argnums=1)(
        jparams, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond)))
    got = tunet.forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(cond))
    return got.detach().numpy(), want


def test_forward_matches_reference(model):
    got, want = _forward_both(model)
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert np.abs(want).max() > 1e-2              # the output carries signal
    np.testing.assert_allclose(got, want, rtol=0.0, atol=FORWARD_BAR)


def test_symmetric_stride2_padding_fails_the_bar(model, monkeypatch):
    """padding=1 at stride 2 samples the other phase of the grid: the
    forward leaves the bar far behind."""
    monkeypatch.setattr(tunet, "same_padding",
                        lambda size, k, s: (k // 2, k // 2))
    got, want = _forward_both(model)
    assert np.abs(got - want).max() > 100 * FORWARD_BAR


def test_gradients_match_reference(model):
    """The mean square of the output against a fixed target: every leaf's
    gradient within 1e-4 of that leaf's largest reference gradient."""
    jcfg, jparams, tcfg, tparams, x, t, cond = model
    target = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        out = junet.forward(p, jcfg, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(cond))
        return jnp.mean(jnp.square(out - jnp.asarray(target)))
    jgrads = jax.jit(jax.grad(jloss))(jparams)
    p = tree_lib.tree_map(lambda a: a.detach().requires_grad_(), tparams)
    out = tunet.forward(p, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(cond))
    loss = torch.mean(torch.square(out - torch.from_numpy(target)))
    tgrads = torch.autograd.grad(loss, tree_lib.leaves(p))
    want_leaves = jax.tree_util.tree_leaves(jgrads)
    assert len(tgrads) == len(want_leaves)
    for g, w in zip(tgrads, want_leaves):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g.numpy() - w).max() / scale < GRAD_BAR
    assert math.isfinite(float(loss.detach()))
