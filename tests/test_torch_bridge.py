"""The parameter bridge: a JAX ``init_params`` pytree goes JAX -> numpy ->
torch -> numpy and comes back equal (``==``), with the same leaf names and
the same stacked ``[L, ...]`` shapes; and the two packages' configs agree
field for field."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,reduce,dtype", [
    ("tiny-dit", False, torch.float32),
    ("sdxl-dit", True, torch.bfloat16),       # bf16 leaves: ml_dtypes arrays
])
def test_params_round_trip(arch, reduce, dtype):
    cfg = jax_get_config(arch)
    if reduce:
        cfg = cfg.reduced()
    jparams = jdit.init_params(jax.random.PRNGKey(0), cfg)
    leaves = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = bridge.params_from_jax(leaves, device="cpu")
    back = bridge.params_to_numpy(tparams)
    want, got, tens = _flatten(leaves), _flatten(back), _flatten(tparams)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert tens[name].dtype == dtype, name
        assert tuple(tens[name].shape) == arr.shape, name
        np.testing.assert_array_equal(got[name], arr.astype(np.float32))
    L = cfg.n_layers
    assert all(v.shape[0] == L for v in tparams["blocks"].values())


def test_bridge_casts_on_request():
    leaves = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "blocks": {"b": np.ones((2, 4), np.float32)}}
    out = bridge.params_from_jax(leaves, device="cpu", dtype=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["blocks"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(), leaves["w"])


@pytest.mark.parametrize("arch", ["tiny-dit", "sdxl-dit"])
def test_configs_field_for_field(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jcfg.reduced()) == dataclasses.asdict(tcfg.reduced())
    for prop in ("tokens_per_side", "n_tokens", "token_dim"):
        assert getattr(jcfg, prop) == getattr(tcfg, prop)
