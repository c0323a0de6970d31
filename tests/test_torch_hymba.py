"""Hymba-1.5B serving on the CPU: the port against the JAX package on the same
inputs and weights. Kernel K6's plain version against the reference's Pallas
flash attention (interpret mode), its ``chunked_attend`` and its naive
``self_attention`` mask; K7's plain version against the reference's Pallas
scan (interpret mode) and ``mamba.ssm_scan_ref``; the layers, the Mamba
branch, ``hymba.forward`` / ``prefill`` / ``decode_step`` through the
meta-pinned ring's wrap, the serving engine, the config, ``init_params`` and
the bridge. Kernel bars: 5e-5 (DESIGN.md §15); per forward, fp32
``atol=1e-5``. The kernels themselves run in tests/test_torch_cuda.py.

The small model is ``hymba-1.5b`` reduced (2 layers, d_model 256, head dim
64, 8 meta tokens, window 64) with GQA at 4 query and 2 KV heads, fp32. The
reference initializes the norm scales (``ln1``, ``fuse_a``, ``fuse_m``,
``ln2``, ``ln_f``) to zero, a scale of 1 under ``(1 + w)``: the tests draw
them from a seeded normal, so a wrong scale shows."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import hymba as jhymba  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model, hymba, layers, mamba  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

KERNEL_BAR = dict(rtol=0.0, atol=5e-5)
FWD_BAR = dict(rtol=0.0, atol=1e-5)
NORM_LEAVES = ("ln1", "fuse_a", "fuse_m", "ln2", "ln_f")


def _cfgs(**kw):
    """(reference config, port config): hymba-1.5b reduced, GQA 4/2."""
    return tuple(get("hymba-1.5b").reduced().replace(n_kv_heads=2, **kw)
                 for get in (jax_get_config, get_config))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _perturbed(tree, rng):
    """numpy leaves with the zero-initialized norm scales drawn from a
    normal of std 0.3."""
    return {k: (_perturbed(v, rng) if isinstance(v, dict) else
                (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in NORM_LEAVES else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def model():
    """(jcfg, tcfg, reference params, port params) on the same weights."""
    jcfg, tcfg = _cfgs()
    leaves = jax.tree_util.tree_map(np.asarray, jax.jit(
        jhymba.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    leaves = _perturbed(leaves, np.random.default_rng(1))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, leaves),
            bridge.params_from_jax(leaves, device="cpu"))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, bar):
    np.testing.assert_allclose(_np(got), _np(want), **bar)


# ----------------------------------------------------------------------
# config, init, bridge
# ----------------------------------------------------------------------

def test_config_field_for_field():
    for reduce in (False, True):
        jcfg, tcfg = (get("hymba-1.5b") for get in (jax_get_config, get_config))
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for prop in ("hd", "attn_dim", "kv_dim", "is_subquadratic"):
            assert getattr(jcfg, prop) == getattr(tcfg, prop)
        assert jcfg.param_count() == tcfg.param_count()
        assert jcfg.active_param_count() == tcfg.active_param_count()
    with pytest.raises(KeyError, match="queue 1 item 15b"):
        get_config("gemma-2b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-model")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_shapes_and_dtypes(dtype):
    jcfg, tcfg = _cfgs(param_dtype=dtype)
    want = _flatten(jax.eval_shape(
        lambda k: jhymba.init_params(k, jcfg), jax.random.PRNGKey(0)))
    got = _flatten(hymba.init_params(torch.Generator().manual_seed(0), tcfg))
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == spec.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(spec.dtype), name
    assert got["blocks/mamba/A_log"].dtype == torch.float32
    # the zero-initialized scales and the float32 leaves' values
    assert all(not got[n].any() for n in got if n.split("/")[-1] in NORM_LEAVES)
    Di = tcfg.d_model
    torch.testing.assert_close(got["blocks/mamba/D_skip"],
                               torch.ones(tcfg.n_layers, Di))
    dt_init = torch.nn.functional.softplus(got["blocks/mamba/b_dt"])
    assert bool(((dt_init > 0.9e-3) & (dt_init < 1.1e-1)).all())


def test_bridge_carries_the_hymba_tree():
    """bf16 weights come over as bf16; A_log, D_skip and b_dt stay float32,
    values exact."""
    jcfg, _ = _cfgs(param_dtype="bfloat16")
    leaves = jax.tree_util.tree_map(np.asarray, jax.jit(
        jhymba.init_params, static_argnums=1)(jax.random.PRNGKey(2), jcfg))
    tparams = bridge.params_from_jax(leaves, device="cpu")
    want, got = _flatten(leaves), _flatten(tparams)
    back = _flatten(bridge.params_to_numpy(tparams))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        f32 = name.split("/")[-1] in ("A_log", "D_skip", "b_dt")
        assert got[name].dtype == (torch.float32 if f32 else torch.bfloat16), name
        assert tuple(got[name].shape) == arr.shape, name
        np.testing.assert_array_equal(back[name], arr.astype(np.float32))
    assert all(v.shape[0] == jcfg.n_layers
               for v in _flatten(tparams["blocks"]).values())


# ----------------------------------------------------------------------
# kernel K6's plain version
# ----------------------------------------------------------------------

def _qkv(S, T, H, K, hd=64, B=1, seed=0):
    rng = np.random.default_rng(seed)
    return ((0.7 * rng.standard_normal((B, S, H, hd))).astype(np.float32),
            (0.7 * rng.standard_normal((B, T, K, hd))).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32))


@pytest.mark.parametrize("causal,window,K", [
    (True, 0, 4), (True, 48, 4), (True, 48, 2), (True, 0, 1),
    (False, 0, 2), (False, 48, 4),
])
def test_k6_plain_matches_pallas(causal, window, K):
    """prefix_len 0 is the TPU kernel's function (interpret mode, S = T a
    tile multiple, so its wrapper takes the kernel and not _masked_ref)."""
    arrs = _qkv(256, 256, 4, K)
    got = ops.flash_attention(*map(torch.from_numpy, arrs), causal=causal,
                              window=window)
    want = jops.flash_attention(*map(jnp.asarray, arrs), causal=causal,
                                window=window)
    _close(got, want, KERNEL_BAR)


@pytest.mark.parametrize("S,window,prefix", [(200, 64, 8), (96, 32, 40),
                                              (130, 0, 8)])
def test_k6_prefix_matches_chunked_and_naive(S, window, prefix):
    """prefix_len > 0: the meta-token mask of the reference's chunked
    attention and of its naive self_attention path."""
    q, k, v = _qkv(S, S, 4, 2, seed=1)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                              window=window, prefix_len=prefix)
    chunked = jattention.chunked_attend(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        window=window, prefix_len=prefix,
                                        chunk=64)
    if window:
        kj, qi = jnp.arange(S)[None, :], jnp.arange(S)[:, None]
        mask = jlayers.window_mask(S, S, 0, window) | (
            (kj < prefix) & (kj <= qi))[None, None]
    else:
        mask = jlayers.causal_mask(S, S, 0)
    naive = jlayers.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           mask=mask)
    _close(got, chunked, KERNEL_BAR)
    _close(got, naive, KERNEL_BAR)


def test_k6_wrapper_checks():
    q, k, v = map(torch.from_numpy, _qkv(64, 64, 4, 2))
    with pytest.raises(ValueError, match="K | 4"):
        ops.flash_attention(q, k[:, :, :1].expand(1, 64, 3, 64), v)
    with pytest.raises(ValueError, match="no key"):
        ops.flash_attention(q, k[:, :16], v[:, :16], causal=False, window=48)
    with pytest.raises(ValueError, match=">= 0"):
        ops.flash_attention(q, k, v, window=-1)
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v, window=16, prefix_len=4)
    assert ops.launch_counts() == {}          # the plain version launches nothing
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        ops.flash_attention(*(t.to("meta") for t in (q, k, v)))


# ----------------------------------------------------------------------
# kernel K7's plain version
# ----------------------------------------------------------------------

def _scan_inputs(B=2, S=40, Di=24, N=16, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, Di)
    dt = np.log1p(np.exp(f(B, S, Di) - 2.0)).astype(np.float32)   # softplus
    a = -np.exp(0.5 * f(Di, N)).astype(np.float32)
    return x, dt, f(B, S, N), f(B, S, N), a, f(Di), f(B, Di, N)


def test_k7_plain_matches_pallas_and_mamba_ref():
    x, dt, b, c, a, d, h0 = _scan_inputs()
    t = lambda *arrs: [torch.from_numpy(z) for z in arrs]
    j = lambda *arrs: [jnp.asarray(z) for z in arrs]
    # zero h0: the TPU kernel's function (its wrapper pads S and Di)
    got = ops.ssm_scan(*t(x, dt, b, c, a, d))
    _close(got, jops.ssm_scan(*j(x, dt, b, c, a, d)), KERNEL_BAR)
    # a nonzero h0 and the final state: mamba.ssm_scan_ref (its argument order)
    y, h = ops.ssm_scan(*t(x, dt, b, c, a, d), h0=torch.from_numpy(h0),
                        final_state=True)
    wy, wh = jmamba.ssm_scan_ref(*j(x, b, c, dt, a, d, h0))
    _close(y, wy, KERNEL_BAR)
    _close(h, wh, KERNEL_BAR)
    ty, th = mamba.ssm_scan_ref(*t(x, b, c, dt, a, d, h0))
    torch.testing.assert_close(ty, y, rtol=0, atol=0)
    torch.testing.assert_close(th, h, rtol=0, atol=0)
    # one step (decode) carries the state
    y1, h1 = ops.ssm_scan(*t(x[:, :1], dt[:, :1], b[:, :1], c[:, :1], a, d),
                          h0=torch.from_numpy(h0), final_state=True)
    wy1, wh1 = jmamba.ssm_scan_ref(*j(x[:, :1], b[:, :1], c[:, :1], dt[:, :1],
                                      a, d, h0))
    _close(y1, wy1, KERNEL_BAR)
    _close(h1, wh1, KERNEL_BAR)


def test_k7_wrapper_checks():
    x, dt, b, c, a, d, h0 = map(torch.from_numpy, _scan_inputs())
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssm_scan(x, dt, b, c, a[:, :8], d)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssm_scan(x, dt, b, c, a, d, h0=h0[:1])
    with pytest.raises(ValueError, match="no ssm_scan kernel"):
        ops.ssm_scan(*(t.to("meta") for t in (x, dt, b, c, a, d)))


# ----------------------------------------------------------------------
# layers and the Mamba branch
# ----------------------------------------------------------------------

def test_rms_norm_and_rope():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)), FWD_BAR)
    pos = np.arange(100, 107)[None].repeat(2, 0).astype(np.int32)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), FWD_BAR)


def test_masks():
    """causal_mask and window_mask as the reference's, and K6's flash_mask
    the same masks where they overlap (causal, no prefix)."""
    for S, T, off in ((5, 9, 4), (16, 16, 0)):
        np.testing.assert_array_equal(_np(layers.causal_mask(S, T, off)),
                                      np.asarray(jlayers.causal_mask(S, T, off)))
        np.testing.assert_array_equal(_np(layers.window_mask(S, T, off, 3)),
                                      np.asarray(jlayers.window_mask(S, T, off, 3)))
    assert torch.equal(ref.flash_mask(16, 16, causal=True, window=3),
                       layers.window_mask(16, 16, 0, 3)[0, 0])
    assert torch.equal(ref.flash_mask(16, 16, causal=True),
                       layers.causal_mask(16, 16, 0)[0, 0])


def test_mlp_activations():
    jcfg, _ = _cfgs()
    p = jax.tree_util.tree_map(np.asarray,
                               jlayers.init_mlp(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(5).standard_normal((1, 5, 256)).astype(np.float32)
    tp = bridge.params_from_jax(p, device="cpu")
    for act in ("swiglu", "geglu"):
        _close(layers.mlp(tp, torch.from_numpy(x), act),
               jlayers.mlp(p, jnp.asarray(x), act), FWD_BAR)


@pytest.mark.parametrize("window,prefix", [(64, 8), (0, 0)])
def test_self_attention(model, window, prefix):
    jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(6).standard_normal((1, 90, 256)).astype(np.float32)
    out, (k, v) = layers.self_attention(hymba._layer(tp["blocks"], 0)["attn"],
                                        torch.from_numpy(x), tcfg,
                                        window=window, prefix_len=prefix)
    jpa = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    wout, (wk, wv) = jlayers.self_attention(jpa, jnp.asarray(x), jcfg,
                                            window=window, prefix_len=prefix)
    _close(out, wout, FWD_BAR)
    _close(k, wk, FWD_BAR)
    _close(v, wv, FWD_BAR)


def test_mamba_proj_and_forward(model):
    """_proj and mamba_forward with a nonzero conv state and SSM state."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    xb = rng.standard_normal((2, 11, 256)).astype(np.float32)
    state = {"h": 0.5 * rng.standard_normal((2, 256, 16)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, 256)).astype(np.float32)}
    jpm = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"]["mamba"])
    tpm = hymba._layer(tp["blocks"], 1)["mamba"]
    got = mamba._proj(tpm, torch.from_numpy(xb), tcfg,
                      torch.from_numpy(state["conv"]))
    want = jmamba._proj(jpm, jnp.asarray(xb), jcfg, jnp.asarray(state["conv"]))
    for g, w in zip(got, want):
        _close(g, w, FWD_BAR)
    y, st = mamba.mamba_forward(tpm, torch.from_numpy(xb), tcfg,
                                {k: torch.from_numpy(v) for k, v in state.items()})
    wy, wst = jmamba.mamba_forward(jpm, jnp.asarray(xb), jcfg,
                                   {k: jnp.asarray(v) for k, v in state.items()})
    _close(y, wy, FWD_BAR)
    _close(st["h"], wst["h"], FWD_BAR)
    _close(st["conv"], wst["conv"], FWD_BAR)
    # softplus is log(1 + e^x) above 20 too, as jax.nn.softplus
    big = torch.tensor([25.0, 30.0])
    _close(mamba.softplus(big), jax.nn.softplus(jnp.asarray(big.numpy())), FWD_BAR)


# ----------------------------------------------------------------------
# hymba forward, prefill, decode (through the ring's wrap)
# ----------------------------------------------------------------------

def test_forward_logits(model):
    jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 50))
    got, _, st = hymba.forward(tp, tcfg, torch.from_numpy(tokens))
    want, _, wst = jhymba.forward(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    assert got.shape == (2, 50, jcfg.vocab)
    _close(got, want, FWD_BAR)
    _close(st["h"], wst["h"], FWD_BAR)
    last = build_model(tcfg).forward_logits(tp, {"tokens": torch.from_numpy(tokens)})
    torch.testing.assert_close(last, got, rtol=0, atol=0)


def test_prefill_and_decode_through_the_ring_wrap(model):
    """Prompt 96 with 8 meta tokens against a ring of 8 + 64 slots: prefill
    keeps the meta tokens and the last 64 positions, and 12 decode steps
    wrap the ring. Teacher-forced with the reference's tokens; logits, K/V
    and SSM states held at the per-forward bar at every step."""
    jcfg, tcfg, jp, tp = model
    W = jcfg.sliding_window
    tokens = np.random.default_rng(9).integers(0, jcfg.vocab, (1, 96))
    jcache = jhymba.init_cache(jcfg, 1, 0, window=W)
    tcache = hymba.init_cache(tcfg, 1, 0, window=W)
    assert tcache["k"].shape == jcache["k"].shape == (2, 1, 72, 2, 64)
    wl, jcache = jhymba.prefill(jp, jcfg, jnp.asarray(tokens, jnp.int32), jcache,
                                window=W)
    tl, tcache = hymba.prefill(tp, tcfg, torch.from_numpy(tokens), tcache,
                               window=W)
    _close(tl, wl, FWD_BAR)
    assert tcache["pos"] == int(jcache["pos"]) == 104
    decode = jax.jit(lambda p, c, t: jhymba.decode_step(p, jcfg, c, t, window=W))
    for step in range(12):
        for name in ("k", "v"):
            _close(tcache[name], jcache[name], FWD_BAR)
        _close(tcache["ssm"]["h"], jcache["ssm"]["h"], FWD_BAR)
        _close(tcache["ssm"]["conv"], jcache["ssm"]["conv"], FWD_BAR)
        tok = int(jnp.argmax(wl[0]))
        wl, jcache = decode(jp, jcache, jnp.asarray([tok], jnp.int32))
        tl, tcache = hymba.decode_step(tp, tcfg, tcache, torch.tensor([tok]),
                                       window=W)
        _close(tl, wl, FWD_BAR)
    assert tcache["pos"] == 116


def test_prefill_and_decode_full_cache(model):
    """Full-cache mode (window 0): batch 2, a 20-token prompt behind 8 meta
    tokens in a cache of T = 48 slots, then 15 decode steps, teacher-forced
    with the reference's tokens. Logits and K/V held at the per-forward bar
    at every step."""
    jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 20))
    jcache = jhymba.init_cache(jcfg, 2, 40, window=0)
    tcache = hymba.init_cache(tcfg, 2, 40, window=0)
    assert tcache["k"].shape == jcache["k"].shape == (2, 2, 48, 2, 64)
    wl, jcache = jhymba.prefill(jp, jcfg, jnp.asarray(tokens, jnp.int32), jcache)
    tl, tcache = hymba.prefill(tp, tcfg, torch.from_numpy(tokens), tcache)
    _close(tl, wl, FWD_BAR)
    assert tcache["pos"] == int(jcache["pos"]) == 28
    decode = jax.jit(lambda p, c, t: jhymba.decode_step(p, jcfg, c, t, window=0))
    for step in range(15):
        tok = np.array(jnp.argmax(wl, axis=-1), np.int32)
        wl, jcache = decode(jp, jcache, jnp.asarray(tok))
        tl, tcache = hymba.decode_step(tp, tcfg, tcache,
                                       torch.from_numpy(tok).long(), window=0)
        _close(tl, wl, FWD_BAR)
        for name in ("k", "v"):
            _close(tcache[name], jcache[name], FWD_BAR)
    assert tcache["pos"] == 43


def test_full_cache_decode_past_the_end_raises(model):
    """A 20-token prompt in a full cache of 8 + 12 slots: prefill keeps the
    meta tokens and the last 12 positions (pos 28), and the first decode
    step refuses to write past the cache, where the reference clamps the
    write to the last slot without a word."""
    _, tcfg, _, tp = model
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, tcfg.vocab, (2, 20)))
    cache = hymba.init_cache(tcfg, 2, 12, window=0)
    _, cache = hymba.prefill(tp, tcfg, tokens, cache)
    assert cache["pos"] == 28 and cache["k"].shape[2] == 20
    with pytest.raises(ValueError, match="clamps the write to slot 19"):
        hymba.decode_step(tp, tcfg, cache, torch.tensor([1, 2]), window=0)


def _margins(tmodel, tp, prompt, out_tokens, window):
    """The port's top-2 logit margin at every token of a request,
    teacher-forced with the reference's tokens."""
    cache = tmodel.init_cache(1, 0, window=window)
    logits, cache = tmodel.prefill(tp, {"tokens": torch.from_numpy(prompt[None]).long()},
                                   cache, window=window)
    margins = []
    for tok in out_tokens:
        top2 = logits[0].topk(2).values
        margins.append(float(top2[0] - top2[1]))
        logits, cache = tmodel.decode_step(tp, cache, torch.tensor([tok]),
                                           window=window)
    return margins


def test_serving_engine_matches_reference(model):
    """3 requests over 2 slots (the third admitted when a slot frees), one
    prompt longer than the ring. Tokens must be equal up to the first one
    where the port's teacher-forced top-2 margin is within twice the
    per-forward bar (its logits are within the bar of the reference's,
    test_prefill_and_decode_through_the_ring_wrap, so past that margin the
    two argmaxes cannot differ)."""
    jcfg, tcfg, jp, tp = model
    W = jcfg.sliding_window
    rng = np.random.default_rng(10)
    specs = [(96, 4), (20, 6), (33, 5)]          # (prompt length, max_new)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32) for n, _ in specs]
    jengine = JServingEngine(jax_build_model(jcfg), jp, slots=2, max_len=64,
                             window=W)
    tengine = ServingEngine(build_model(tcfg), tp, slots=2, max_len=64, window=W)
    for uid, (prompt, (_, max_new)) in enumerate(zip(prompts, specs)):
        jengine.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=max_new))
        tengine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    jdone = {r.uid: r for r in jengine.run_to_completion()}
    tdone = {r.uid: r for r in tengine.run_to_completion()}
    assert sorted(tdone) == sorted(jdone) == [0, 1, 2]
    checked = 0
    for uid, jreq in jdone.items():
        treq = tdone[uid]
        assert len(treq.out_tokens) == len(jreq.out_tokens) == specs[uid][1]
        assert treq.first_token_s is not None
        margins = _margins(build_model(tcfg), tp, prompts[uid],
                           jreq.out_tokens, W)
        for want, got, margin in zip(jreq.out_tokens, treq.out_tokens, margins):
            if margin <= 2 * FWD_BAR["atol"]:
                break                             # a near-tie may flip
            assert got == want, (uid, jreq.out_tokens, treq.out_tokens)
            checked += 1
    assert checked >= 12


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

def test_model_api_and_serve_entry_point():
    _, tcfg = _cfgs()
    m = build_model(tcfg)
    batch = m.make_batch(torch.Generator().manual_seed(0), 2, 9)
    assert batch["tokens"].shape == (2, 9) and int(batch["tokens"].max()) < tcfg.vocab
    with pytest.raises(NotImplementedError, match="training"):
        m.loss({}, batch)
    with pytest.raises(NotImplementedError, match="queue 1 item 15b"):
        build_model(tcfg.replace(family="dense"))
    done = tserve.serve("hymba-1.5b", n_requests=3, slots=2, prompt_len=12,
                        max_new=4, device="cpu")
    assert sorted(len(r.out_tokens) for r in done) == [4, 4, 4]
    assert all(0 <= t < tcfg.vocab for r in done for t in r.out_tokens)
    # diffusion serving is ported, its video lanes (one clip a request)
    # and its prompt lanes too
    (clip,) = tserve.main(["--diffusion", "--num-frames", "2", "--requests",
                           "1", "--slots", "1", "--m-base", "4",
                           "--m-warmup", "2", "--device", "cpu"])
    assert clip.image.shape[:2] == (1, 2) and clip.done
    lanes = ["--requests", "2", "--slots", "2", "--m-base", "4",
             "--m-warmup", "2", "--device", "cpu"]
    done = tserve.main(["--diffusion", "--cond-tokens", "4"] + lanes)
    assert [tuple(r.cond.shape) for r in done] == [(1, 4, 65)] * 2
    assert all(r.done and bool(torch.isfinite(r.image).all()) for r in done)
    done = tserve.main(["--diffusion", "--prompt", "a red fox"] + lanes)
    assert [r.cond.shape[1] for r in done] == [4, 4]      # 4 words: bucket 4
    assert all(r.done and bool(torch.isfinite(r.image).all()) for r in done)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--requests", "1"])
