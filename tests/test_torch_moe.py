"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
(``repro.models.moe``) on the CPU, on the same inputs and weights: the
parameter tree, the router's choices (``top_k`` order included), the queue
places and the kept set under a capacity that drops tokens, the output and
the Switch aux loss. The port dispatches with indices where the reference
contracts one-hot tensors; per forward the bar is fp32 ``atol=1e-5``.

Configs: olmoe-1b-7b and deepseek-moe-16b reduced (4 experts, top 2;
deepseek with one shared expert), fp32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.set_num_threads(1)
FWD_BAR = dict(rtol=0.0, atol=1e-5)
ARCHS = ["olmoe-1b-7b", "deepseek-moe-16b"]


def _cfgs(arch, **kw):
    return tuple(get(arch).reduced().replace(**kw)
                 for get in (jax_get_config, get_config))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _weights(jcfg, seed=0):
    """The reference's init_moe leaves as numpy, and as port tensors."""
    leaves = jax.tree_util.tree_map(
        np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    return leaves, bridge.params_from_jax(leaves, device="cpu")


def _x(B, S, D, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _reference_routing(jp, x, jcfg):
    """The reference's idx and per-pair keep, by its own formula
    (``repro.models.moe.moe_ffn``'s first lines)."""
    B, S, _ = x.shape
    E, K = jcfg.n_experts, jcfg.top_k
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(jp["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    sel = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    flat = sel.reshape(B, S * K, E)
    pos_in_e = (jnp.cumsum(flat, axis=1) - flat).reshape(B, S, K, E)
    keep = (sel * (pos_in_e < jmoe._capacity(S, jcfg))).sum(-1) > 0
    return np.asarray(idx), np.asarray(keep)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_tree(arch, dtype):
    """Names, shapes and dtypes of init_moe's tree; the router stays fp32,
    and the bridge keeps it so under dtype=None."""
    jcfg, tcfg = _cfgs(arch, param_dtype=dtype)
    want = _flatten(jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg),
                                   jax.random.PRNGKey(0)))
    got = _flatten(moe.init_moe(torch.Generator().manual_seed(0), tcfg))
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == spec.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(spec.dtype), name
    assert ("shared/w_gate" in got) == bool(tcfg.n_shared_experts)
    bridged = _flatten(_weights(jcfg)[1])
    assert bridged["router"].dtype == torch.float32
    assert bridged["experts/w_up"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_reference(arch, capacity_factor):
    """Output and aux loss within the per-forward bar, and the router's
    experts, their order and the kept set equal to the reference's. At a
    capacity factor of 0.5 the queues overflow and tokens are dropped."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, tp = _weights(jcfg)
    x = _x(2, 24, jcfg.d_model)
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    wy, waux = jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, jp),
                            jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **FWD_BAR)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6, atol=0)
    _, _, idx, pos, keep = moe.route(tp, torch.from_numpy(x), tcfg)
    widx, wkeep = _reference_routing(jp, x, jcfg)
    np.testing.assert_array_equal(idx.numpy(), widx)       # top_k order too
    np.testing.assert_array_equal(keep.numpy(), wkeep)
    n_pairs = keep.numel()
    if capacity_factor < 1:
        assert int(keep.sum()) < n_pairs                    # tokens dropped
        assert int(pos.max()) >= moe._capacity(24, tcfg)
    else:
        assert moe._capacity(24, tcfg) == moe._capacity(24, jcfg)


def test_dropped_pairs_change_the_output():
    """The drops are real: the same tokens at the full capacity give
    another output, and a dropped pair's token keeps only its other
    pairs' gates (no rerouting)."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", capacity_factor=0.5)
    _, tp = _weights(jcfg)
    x = torch.from_numpy(_x(2, 24, jcfg.d_model))
    y, _ = moe.moe_ffn(tp, x, tcfg)
    y_full, _ = moe.moe_ffn(tp, x, tcfg.replace(capacity_factor=4.0))
    _, _, _, _, keep = moe.route(tp, x, tcfg)
    all_dropped = ~keep.any(-1)                             # [B, S]
    assert bool(all_dropped.any())
    assert torch.equal(y[all_dropped], torch.zeros_like(y[all_dropped]))
    assert float((y - y_full).abs().max()) > 1e-2


def test_decode_shape_capacity():
    """One token (decode): capacity 1 a queue, the same output."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    jp, tp = _weights(jcfg, seed=3)
    x = _x(3, 1, jcfg.d_model, seed=4)
    assert moe._capacity(1, tcfg) == 1
    y, _ = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    wy, _ = jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, jp),
                         jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **FWD_BAR)
