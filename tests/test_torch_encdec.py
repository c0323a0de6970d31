"""The port's encoder-decoder LM (``repro_torch.models.encdec``,
SeamlessM4T-medium) against the JAX package's ``repro.models.encdec`` on
the CPU, on the same inputs and weights: the config field for field, the
parameter tree (two stacks), ``layer_norm``, ``bidirectional_attention``
and ``cross_attention`` against the reference's layers, ``encode`` and
``decode_forward``, prefill then 8 teacher-forced decode steps (the decode's
cross read is K6 at one query row), K6's non-causal plain version against
the reference's Pallas kernel in interpret mode (S != T, ragged T, S = 1),
and the ring: after a target prompt longer than a ring cache that the ring
does not divide, the port's decode equals the windowed ``decode_forward``
and the reference's does not (its prefill keeps the positions in order,
``src/repro/models/encdec.py:140-141``; ROADMAP.md queue 3).

Model: ``seamless-m4t-medium.reduced()`` (2 encoder + 2 decoder layers,
d_model 256, 4 heads of 64, GeGLU), fp32, its zero-initialized norm scales
drawn from a seeded normal. Bars: per forward fp32 ``atol=1e-5``; a
kernel's plain version 5e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model, encdec, layers  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)
KERNEL_BAR = dict(rtol=0.0, atol=5e-5)
FWD_BAR = dict(rtol=0.0, atol=1e-5)
ARCH = "seamless-m4t-medium"
NORM_LEAVES = ("ln1", "ln2", "lnx", "enc_ln_f", "dec_ln_f")


def _perturbed(tree, rng):
    return {k: (_perturbed(v, rng) if isinstance(v, dict) else
                (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in NORM_LEAVES else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def model():
    """(jcfg, tcfg, reference params, port params) on the same weights."""
    jcfg, tcfg = (get(ARCH).reduced() for get in (jax_get_config, get_config))
    leaves = jax.tree_util.tree_map(np.asarray, jax.jit(
        jencdec.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    leaves = _perturbed(leaves, np.random.default_rng(1))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, leaves),
            bridge.params_from_jax(leaves, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, bar=FWD_BAR):
    np.testing.assert_allclose(_np(got), _np(want), **bar)


def _src(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# ----------------------------------------------------------------------
# config, tree, layers
# ----------------------------------------------------------------------

def test_config_field_for_field_and_tree():
    for reduce in (False, True):
        jcfg, tcfg = (get(ARCH) for get in (jax_get_config, get_config))
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert jcfg.param_count() == tcfg.param_count()
    jcfg, tcfg = jcfg.replace(param_dtype="bfloat16"), tcfg.replace(param_dtype="bfloat16")
    want = jax.eval_shape(lambda k: jencdec.init_params(k, jcfg), jax.random.PRNGKey(0))
    got = encdec.init_params(torch.Generator().manual_seed(0), tcfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_t]
    for (path, w), (_, t) in zip(flat_w, flat_t):
        assert tuple(t.shape) == w.shape and str(t.dtype) == f"torch.{w.dtype}", path
    assert got["enc_blocks"]["attn"]["wq"].shape[0] == tcfg.n_enc_layers
    assert build_model(ARCH).family == "encdec"


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(2)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in
               ((3, 5, 48), (48,), (48,)))
    _close(layers.layer_norm(*map(torch.from_numpy, (x, w, b))),
           jlayers.layer_norm(*map(jnp.asarray, (x, w, b))))
    xb = torch.from_numpy(x).bfloat16()
    out = layers.layer_norm(xb, torch.from_numpy(w), torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    _close(out, jlayers.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                   jnp.asarray(b)), dict(rtol=0, atol=0))


def test_bidirectional_and_cross_attention_match_reference(model):
    """The encoder's attention over S = 11 and the cross read of S = 7 and
    S = 1 queries over T = 13 memory keys, against the reference's."""
    jcfg, tcfg, jp, tp = model
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["dec_blocks"]["xattn"])
    tattn = {k: v[0] for k, v in tp["dec_blocks"]["xattn"].items()}
    x = _src(jcfg, 2, 11, seed=3)
    _close(layers.bidirectional_attention(tattn, torch.from_numpy(x), tcfg),
           jlayers.bidirectional_attention(jattn, jnp.asarray(x), jcfg))
    kv = [np.random.default_rng(s).standard_normal(
        (2, 13, jcfg.n_kv_heads, jcfg.hd)).astype(np.float32) for s in (4, 5)]
    for S in (7, 1):
        q = _src(jcfg, 2, S, seed=6 + S)
        _close(layers.cross_attention(tattn, torch.from_numpy(q),
                                      tuple(map(torch.from_numpy, kv)), tcfg),
               jlayers.cross_attention(jattn, jnp.asarray(q),
                                       tuple(map(jnp.asarray, kv)), jcfg))


@pytest.mark.parametrize("S,T", [(64, 96), (96, 64), (1, 37), (5, 37), (250, 200)])
def test_k6_noncausal_plain_matches_reference_kernel(S, T):
    """K6's plain version without the causal mask against the reference's
    Pallas kernel in interpret mode: tile-aligned S != T through
    ``flash_attention_bhsd`` itself (32-row tiles), and ragged shapes
    (the decode's one query row, T = 37) through its wrapper, which pads,
    GQA 4/2."""
    rng = np.random.default_rng(S * 1000 + T)
    q = rng.standard_normal((1, S, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, T, 2, 64)).astype(np.float32) for _ in range(2))
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=False)
    if S % 32 == 0 and T % 32 == 0:
        rep = lambda a: jnp.repeat(jnp.moveaxis(jnp.asarray(a), 2, 1), 2, axis=1)
        want = jnp.moveaxis(jfa.flash_attention_bhsd(
            jnp.moveaxis(jnp.asarray(q), 2, 1), rep(k), rep(v), causal=False,
            bq=32, bk=32, interpret=True), 1, 2)
    else:
        want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False)
    _close(got, want, KERNEL_BAR)


# ----------------------------------------------------------------------
# encode, decode_forward, prefill, decode
# ----------------------------------------------------------------------

def test_encode_and_decode_forward_match_reference(model):
    jcfg, tcfg, jp, tp = model
    src, tgt = _src(jcfg, 2, 24, seed=10), _tokens(jcfg, 2, 9, seed=11)
    jmem = jax.jit(lambda p, s: jencdec.encode(p, jcfg, s))(jp, jnp.asarray(src))
    tmem = encdec.encode(tp, tcfg, torch.from_numpy(src))
    _close(tmem, jmem)
    for window in (0, 4):
        want, _, (jmk, _) = jax.jit(lambda p, t, m: jencdec.decode_forward(
            p, jcfg, t, m, window=window))(jp, jnp.asarray(tgt, jnp.int32), jmem)
        got, _, (tmk, _) = encdec.decode_forward(tp, tcfg, torch.from_numpy(tgt),
                                                 tmem, window=window)
        _close(got, want)
        _close(tmk, jmk)


def test_prefill_and_decode_match_reference(model):
    """A full cache: prefill of 40 source frames and 6 target tokens, then
    8 teacher-forced decode steps: logits, the self-attention cache and
    the cross K/V against the reference's."""
    jcfg, tcfg, jp, tp = model
    src, tgt = _src(jcfg, 2, 40, seed=12), _tokens(jcfg, 2, 6, seed=13)
    feed = _tokens(jcfg, 2, 8, seed=14)
    jc = jencdec.init_cache(jcfg, 2, 16, 40)
    tc = build_model(tcfg).init_cache(2, 16, src_len=40, device="cpu")
    jl, jc = jax.jit(lambda p, s, t, c: jencdec.prefill(p, jcfg, s, t, c))(
        jp, jnp.asarray(src), jnp.asarray(tgt, jnp.int32), jc)
    tl, tc = encdec.prefill(tp, tcfg, torch.from_numpy(src), torch.from_numpy(tgt), tc)
    _close(tl, jl)
    jdecode = jax.jit(lambda p, c, t: jencdec.decode_step(p, jcfg, c, t))
    for i in range(8):
        jl, jc = jdecode(jp, jc, jnp.asarray(feed[:, i], jnp.int32))
        tl, tc = encdec.decode_step(tp, tcfg, tc, torch.from_numpy(feed[:, i]))
        _close(tl, jl)
    assert tc["pos"] == int(jc["pos"]) == 14
    for key in ("k", "v", "mem_k", "mem_v"):
        _close(tc[key], jc[key])
    with pytest.raises(ValueError, match="past the cache"):
        for i in range(3):
            tl, tc = encdec.decode_step(tp, tcfg, tc, torch.from_numpy(feed[:, i]))


def test_ring_decode_matches_windowed_forward(model):
    """Window 4, a 10-token target prompt (10 % 4 = 2): prefill, then 6
    decode steps. Each step's logits equal the windowed ``decode_forward``
    over the prompt and the tokens fed (the port's and the reference's)
    at the per-forward bar; the reference's own decode misses by far more
    (its prefill keeps the last 4 positions in order, so the first step
    overwrites a key still inside the window)."""
    jcfg, tcfg, jp, tp = model
    W, S = 4, 10
    src, tgt = _src(jcfg, 1, 20, seed=15), _tokens(jcfg, 1, S, seed=16)
    feed = _tokens(jcfg, 1, 6, seed=17)
    full = np.concatenate([tgt, feed], axis=1)
    jmem = jencdec.encode(jp, jcfg, jnp.asarray(src))
    jwant = jencdec.decode_forward(jp, jcfg, jnp.asarray(full, jnp.int32), jmem,
                                   window=W)[0]
    twant = encdec.decode_forward(tp, tcfg, torch.from_numpy(full),
                                  encdec.encode(tp, tcfg, torch.from_numpy(src)),
                                  window=W)[0]
    _close(twant, jwant)
    tc = build_model(tcfg).init_cache(1, 32, window=W, src_len=20, device="cpu")
    _, tc = encdec.prefill(tp, tcfg, torch.from_numpy(src), torch.from_numpy(tgt),
                           tc, window=W)
    jc = jencdec.init_cache(jcfg, 1, 32, 20, window=W)
    _, jc = jencdec.prefill(jp, jcfg, jnp.asarray(src), jnp.asarray(tgt, jnp.int32),
                            jc, window=W)
    ported, reference = [], []
    for i in range(feed.shape[1]):
        tl, tc = encdec.decode_step(tp, tcfg, tc, torch.from_numpy(feed[:, i]),
                                    window=W)
        jl, jc = jencdec.decode_step(jp, jcfg, jc, jnp.asarray(feed[:, i], jnp.int32),
                                     window=W)
        ported.append(float(np.abs(_np(tl) - _np(jwant[:, S + i])).max()))
        reference.append(float(np.abs(_np(jl) - _np(jwant[:, S + i])).max()))
    assert max(ported) < FWD_BAR["atol"], ported
    assert max(reference) > 1e-2, reference


def test_model_api_and_engine_refusal(model):
    """``api.Model`` for encdec: make_batch (the target a quarter of the
    source, at least 16), forward_logits, loss, init_cache's ``src_len``
    (``max_len`` when 0); the serving engine refuses enc-dec requests, as
    the reference's does."""
    _, tcfg, _, tp = model
    m = build_model(tcfg)
    batch = m.make_batch(torch.Generator().manual_seed(0), 2, 72)
    assert batch["src_embeds"].shape == (2, 72, tcfg.d_model)
    assert batch["tgt_tokens"].shape == batch["labels"].shape == (2, 18)
    assert encdec.tgt_len_for(40) == 16
    logits = m.forward_logits(tp, batch)
    assert logits.shape == (2, 18, tcfg.vocab)
    assert torch.isfinite(m.loss(tp, batch))
    assert m.init_cache(1, 30, device="cpu")["mem_k"].shape[2] == 30
    assert m.init_cache(1, 30, src_len=8, device="cpu")["mem_k"].shape[2] == 8
    engine = ServingEngine(m, tp, slots=1, max_len=16)
    engine.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32)))
    with pytest.raises(NotImplementedError, match="enc-dec serving .* api.Model"):
        engine.run_to_completion()
