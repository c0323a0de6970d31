"""The port's xLSTM (``repro_torch.models.xlstm``) against the JAX package's
``repro.models.xlstm`` on the CPU, on the same inputs and weights: the
config field for field, the parameter tree (a list of heterogeneous block
dicts, carried by the bridge with each leaf's dtype), ``forward`` logits
and states with both block kinds, prefill then 8 teacher-forced decode
steps, prefill plus decode against one forward (the carried conv state),
and the serving engine against the reference's.

``reduced()`` keeps 2 layers and ``slstm_every`` 4 puts the sLSTM block at
layer 3, so the model here is ``reduced().replace(n_layers=4)``: mLSTM at
layers 0 to 2, sLSTM at 3 (d_model 256, 4 heads; mLSTM heads of 128, sLSTM
heads of 64). The zero-initialized norm scales are drawn from a seeded
normal so that a wrong scale shows. Bar: fp32 ``atol=1e-5``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model, xlstm  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)
FWD_BAR = dict(rtol=0.0, atol=1e-5)
ARCH = "xlstm-125m"


def _cfgs(dtype="float32"):
    return tuple(get(ARCH).reduced().replace(n_layers=4, dtype=dtype,
                                             param_dtype=dtype)
                 for get in (jax_get_config, get_config))


def _perturbed(tree, rng):
    """numpy leaves with the zero-initialized norm scales (``ln``,
    ``ln_f``) drawn from a normal of std 0.3."""
    if isinstance(tree, list):
        return [_perturbed(t, rng) for t in tree]
    return {k: (_perturbed(v, rng) if isinstance(v, (dict, list)) else
                (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in ("ln", "ln_f") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def model():
    """(jcfg, tcfg, reference params, port params) on the same weights."""
    jcfg, tcfg = _cfgs()
    leaves = jax.tree_util.tree_map(np.asarray, jxlstm.init_params(
        jax.random.PRNGKey(0), jcfg))
    leaves = _perturbed(leaves, np.random.default_rng(1))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, leaves),
            bridge.params_from_jax(leaves, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, bar=FWD_BAR):
    np.testing.assert_allclose(_np(got), _np(want), **bar)


def _close_states(tstates, jstates, bar=FWD_BAR):
    assert len(tstates) == len(jstates)
    for ts, js in zip(tstates, jstates):
        assert sorted(ts) == sorted(js)
        for key in js:
            _close(ts[key], js[key], bar)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# ----------------------------------------------------------------------
# config and tree
# ----------------------------------------------------------------------

def test_config_field_for_field_and_block_kinds():
    for reduce in (False, True):
        jcfg, tcfg = (get(ARCH) for get in (jax_get_config, get_config))
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert jcfg.param_count() == tcfg.param_count()
    jcfg, tcfg = _cfgs()
    assert [xlstm.is_slstm(tcfg, i) for i in range(4)] == \
        [jxlstm.is_slstm(jcfg, i) for i in range(4)] == [False, False, False, True]
    assert build_model(ARCH).family == "ssm"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_and_dtypes(dtype):
    """The port's own init has the reference's leaves, shapes and dtypes
    (``w_if``, ``b_if`` and the sLSTM's ``b`` float32 under bf16), and the
    bridge carries the reference's list of heterogeneous blocks with each
    leaf's dtype."""
    jcfg, tcfg = _cfgs(dtype)
    want = jax.eval_shape(lambda k: jxlstm.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    got = xlstm.init_params(torch.Generator().manual_seed(0), tcfg)
    carried = bridge.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jxlstm.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")
    for tree in (got, carried):
        assert isinstance(tree["blocks"], list) and len(tree["blocks"]) == 4
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_t]
        for (path, w), (_, t) in zip(flat_w, flat_t):
            assert tuple(t.shape) == w.shape, path
            assert str(t.dtype).removeprefix("torch.") == str(w.dtype), path
    assert got["blocks"][0]["w_if"].dtype == got["blocks"][3]["b"].dtype == torch.float32


# ----------------------------------------------------------------------
# forward, prefill, decode
# ----------------------------------------------------------------------

def test_forward_matches_reference(model):
    """Logits and every block's final state (mLSTM C, n, m, conv; sLSTM c,
    n, h, m) over a 12-token prompt, batch 2."""
    jcfg, tcfg, jp, tp = model
    tokens = _tokens(jcfg, 2, 12, seed=2)
    want, jstates = jax.jit(lambda p, t: jxlstm.forward(p, jcfg, t))(
        jp, jnp.asarray(tokens, jnp.int32))
    got, tstates = xlstm.forward(tp, tcfg, torch.from_numpy(tokens))
    _close(got, want)
    _close_states(tstates, jstates)


def test_prefill_and_decode_match_reference(model):
    """prefill of 10 tokens, then 8 teacher-forced decode steps: logits and
    states at each step against the reference's."""
    jcfg, tcfg, jp, tp = model
    tokens = _tokens(jcfg, 2, 10, seed=3)
    feed = _tokens(jcfg, 2, 8, seed=4)
    jdecode = jax.jit(lambda p, s, t: jxlstm.decode_step(p, jcfg, s, t))
    jlogits, jst = jax.jit(lambda p, t: jxlstm.prefill(p, jcfg, t))(
        jp, jnp.asarray(tokens, jnp.int32))
    tlogits, tst = xlstm.prefill(tp, tcfg, torch.from_numpy(tokens))
    _close(tlogits, jlogits)
    _close_states(tst, jst)
    for i in range(feed.shape[1]):
        jlogits, jst = jdecode(jp, jst, jnp.asarray(feed[:, i], jnp.int32))
        tlogits, tst = xlstm.decode_step(tp, tcfg, tst, torch.from_numpy(feed[:, i]))
        _close(tlogits, jlogits)
    _close_states(tst, jst)


def test_prefill_then_decode_equals_one_forward(model):
    """The decode continues the prefill: the conv state carries the last
    ssm_conv - 1 projected inputs and the recurrences their state, so the
    logits of prefill + 6 decode steps are one forward's over the same
    tokens. Dropping the conv state (a planted fault) breaks it."""
    _, tcfg, _, tp = model
    seq = torch.from_numpy(_tokens(tcfg, 1, 14, seed=5))
    fwd, _ = xlstm.forward(tp, tcfg, seq)
    logits, state = xlstm.prefill(tp, tcfg, seq[:, :8])
    _close(logits, fwd[:, 7])
    lost = [{**s, "conv": torch.zeros_like(s["conv"])} if "conv" in s else s
            for s in state]
    for t in range(8, 14):
        logits, state = xlstm.decode_step(tp, tcfg, state, seq[:, t])
        _close(logits, fwd[:, t])
    bad, _ = xlstm.decode_step(tp, tcfg, lost, seq[:, 8])
    assert np.abs(_np(bad) - _np(fwd[:, 8])).max() > 1e-3


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

def test_serving_engine_matches_reference(model):
    """3 requests over 2 slots through both engines: the same tokens (the
    port's logits are within 1e-5 of the reference's at every step, and
    the first tokens of these prompts are far from ties)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(6)
    specs = [(9, 4), (5, 6), (12, 3)]
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32) for n, _ in specs]
    jengine = JServingEngine(jax_build_model(jcfg), jp, slots=2, max_len=32)
    tengine = ServingEngine(build_model(tcfg), tp, slots=2, max_len=32)
    for uid, (prompt, (_, new)) in enumerate(zip(prompts, specs)):
        jengine.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=new))
        tengine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    jdone = {r.uid: r.out_tokens for r in jengine.run_to_completion()}
    tdone = {r.uid: r.out_tokens for r in tengine.run_to_completion()}
    assert tdone == jdone and sorted(tdone) == [0, 1, 2]


def test_model_api():
    """``api.Model`` for the ssm family: init, make_batch, init_cache (the
    per-block states), forward_logits, loss, prefill and decode_step; and
    ``serve --arch xlstm-125m`` on the CPU."""
    _, tcfg = _cfgs()
    m = build_model(tcfg)
    params = m.init(torch.Generator().manual_seed(0))
    batch = m.make_batch(torch.Generator().manual_seed(1), 2, 7)
    logits = m.forward_logits(params, batch)
    assert logits.shape == (2, 7, tcfg.vocab)
    assert torch.isfinite(m.loss(params, batch))
    cache = m.init_cache(2, 99, device="cpu")
    assert len(cache) == 4 and cache[0]["C"].shape == (2, 4, 128, 128)
    last, cache = m.prefill(params, batch, cache)
    _close(last, logits[:, -1])
    out, _ = m.decode_step(params, cache, batch["tokens"][:, 0])
    assert out.shape == (2, tcfg.vocab)
    done = tserve.main(["--arch", ARCH, "--requests", "3", "--slots", "2",
                        "--prompt-len", "6", "--max-new", "4", "--device", "cpu"])
    assert sorted(len(r.out_tokens) for r in done) == [4, 4, 4]
