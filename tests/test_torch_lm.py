"""The port's decoder-only LMs (``repro_torch.models.lm``: dense, MoE, VLM)
against the JAX package's ``repro.models.lm`` on the CPU, on the same
inputs and weights: the seven configs field for field, the parameter trees,
``forward`` logits, ``prefill`` then teacher-forced ``decode_step`` (logits
and caches, full cache and windowed short prompts), the serving engine,
kernel K6's plain version against the reference's Pallas kernel (interpret
mode) at head dims 128 and 256, and the ring repair: after a prompt longer
than a ring cache, whose length the ring does not divide, the port's
decode equals the windowed ``forward`` at every position, and the
reference's does not (ROADMAP.md queue 3).

Models are the configs' ``reduced()`` forms (2 layers, d_model 256, head
dim 64, fp32): yi-9b (dense, GQA 4/4), gemma-2b (dense, MQA, GeGLU, tied
embeddings, embedding scale, logit softcap), olmoe-1b-7b and
deepseek-moe-16b (MoE; deepseek with a shared expert) and internvl2-76b
(VLM, 16 vision tokens). The reference initializes the norm scales to zero
(a scale of 1 under ``(1 + w)``): the tests draw them from a seeded normal,
so a wrong scale shows. Bars: per forward fp32 ``atol=1e-5``; a kernel's
plain version 5e-5."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model, lm  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

torch.set_num_threads(1)
KERNEL_BAR = dict(rtol=0.0, atol=5e-5)
FWD_BAR = dict(rtol=0.0, atol=1e-5)
NORM_LEAVES = ("ln1", "ln2", "ln_f")
NEW_ARCHS = ["gemma-2b", "yi-9b", "minitron-8b", "llama3-405b",
             "internvl2-76b", "olmoe-1b-7b", "deepseek-moe-16b"]
FAMILIES = {"yi-9b": "dense", "gemma-2b": "dense", "olmoe-1b-7b": "moe",
            "deepseek-moe-16b": "moe", "internvl2-76b": "vlm"}


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


@functools.lru_cache(maxsize=None)
def _model(arch, dtype="float32"):
    """(jcfg, tcfg, reference params, port params) on the same weights."""
    jcfg, tcfg = (get(arch).reduced().replace(dtype=dtype, param_dtype=dtype)
                  for get in (jax_get_config, get_config))
    leaves = jax.tree_util.tree_map(np.asarray, jax.jit(
        jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    leaves = _perturbed(leaves, np.random.default_rng(1))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, leaves),
            bridge.params_from_jax(leaves, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, dtype=np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _close(got, want, bar):
    np.testing.assert_allclose(_np(got), _np(want), **bar)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _vision(cfg, B, seed):
    """Stub ViT patch embeddings [B, n_vision_tokens, D] (None for a text
    model)."""
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


def _batches(cfg, tokens, vision):
    jb = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tb = {"tokens": torch.from_numpy(tokens)}
    if vision is not None:
        jb["vision_embeds"] = jnp.asarray(vision)
        tb["vision_embeds"] = torch.from_numpy(vision)
    return jb, tb


# ----------------------------------------------------------------------
# configs, init, bridge
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_field_for_field(arch):
    for reduce in (False, True):
        jcfg, tcfg = (get(arch) for get in (jax_get_config, get_config))
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for prop in ("hd", "attn_dim", "kv_dim", "is_subquadratic"):
            assert getattr(jcfg, prop) == getattr(tcfg, prop)
        assert jcfg.param_count() == tcfg.param_count()
        assert jcfg.active_param_count() == tcfg.active_param_count()
    assert build_model(arch).family == jax_get_config(arch).family


@pytest.mark.parametrize("arch", ["xlstm-125m", "seamless-m4t-medium"])
def test_later_configs_and_families_are_refused(arch):
    """Once refused (queue 1 item 15c), now ported: the config field for
    field and the family's model built, initialized and run on a batch
    (tests/test_torch_xlstm.py and test_torch_encdec.py hold them to the
    reference)."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    cfg = tcfg.reduced().replace(dtype="float32", param_dtype="float32")
    m = build_model(cfg)
    assert m.family == jcfg.family
    params = m.init(torch.Generator().manual_seed(0))
    batch = m.make_batch(torch.Generator().manual_seed(1), 1, 16)
    logits = m.forward_logits(params, batch)
    assert logits.shape[-1] == cfg.vocab and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", list(FAMILIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_shapes_and_dtypes(arch, dtype):
    jcfg, tcfg = (get(arch).reduced().replace(param_dtype=dtype)
                  for get in (jax_get_config, get_config))
    want = _flatten(jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                                   jax.random.PRNGKey(0)))
    got = _flatten(build_model(tcfg).init(torch.Generator().manual_seed(0)))
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == spec.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(spec.dtype), name
    assert all(not got[n].any() for n in got if n.split("/")[-1] in NORM_LEAVES)
    assert ("head" in got) == (not tcfg.tie_embeddings)


def test_bridge_carries_the_moe_tree():
    """bf16 weights come over as bf16, the fp32 router stays fp32 under
    dtype=None, values exact."""
    jcfg = jax_get_config("deepseek-moe-16b").reduced().replace(
        param_dtype="bfloat16")
    leaves = jax.tree_util.tree_map(np.asarray, jax.jit(
        jlm.init_params, static_argnums=1)(jax.random.PRNGKey(2), jcfg))
    tparams = bridge.params_from_jax(leaves, device="cpu")
    want, got = _flatten(leaves), _flatten(tparams)
    back = _flatten(bridge.params_to_numpy(tparams))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        f32 = name.endswith("/router")
        assert got[name].dtype == (torch.float32 if f32 else torch.bfloat16), name
        np.testing.assert_array_equal(back[name], arr.astype(np.float32))


# ----------------------------------------------------------------------
# kernel K6's plain version at the decoders' head dims
# ----------------------------------------------------------------------

@pytest.mark.parametrize("hd,H,K,window", [(128, 4, 2, 0), (128, 2, 2, 48),
                                           (256, 2, 1, 0), (256, 2, 1, 100)])
def test_k6_plain_matches_pallas(hd, H, K, window):
    """olmoe's / yi's head dim 128 and gemma's 256 (MQA): the TPU kernel in
    interpret mode (S = T a tile multiple, so its wrapper takes the kernel)."""
    rng = np.random.default_rng(hd + window)
    q = (0.7 * rng.standard_normal((1, 256, H, hd))).astype(np.float32)
    k = (0.7 * rng.standard_normal((1, 256, K, hd))).astype(np.float32)
    v = rng.standard_normal((1, 256, K, hd)).astype(np.float32)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                              window=window)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                window=window)
    _close(got, want, KERNEL_BAR)


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,window", [
    ("yi-9b", 0), ("yi-9b", 8), ("gemma-2b", 0), ("olmoe-1b-7b", 0),
    ("deepseek-moe-16b", 0), ("internvl2-76b", 0), ("internvl2-76b", 8)])
def test_forward_logits(arch, window):
    """Logits (and the MoE aux loss) within the per-forward bar; the VLM's
    vision tokens are a prefix that stays visible outside a window."""
    jcfg, tcfg, jp, tp = _model(arch)
    tokens, vision = _tokens(jcfg, 2, 20, 3), _vision(jcfg, 2, 4)
    jb, tb = _batches(jcfg, tokens, vision)
    got, aux, _ = lm.forward(tp, tcfg, tb["tokens"],
                             vision_embeds=tb.get("vision_embeds"), window=window)
    want, waux, _ = jlm.forward(jp, jcfg, jb["tokens"],
                                vision_embeds=jb.get("vision_embeds"), window=window)
    assert got.shape == (2, 20 + jcfg.n_vision_tokens, jcfg.vocab)
    _close(got, want, FWD_BAR)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5, atol=1e-7)
    if window == 0:
        same = build_model(tcfg).forward_logits(tp, tb)
        torch.testing.assert_close(same, got, rtol=0, atol=0)
    if arch == "gemma-2b":
        assert float(got.abs().max()) <= tcfg.logit_softcap


def test_gemma_bf16_embedding_scale_and_softcap():
    """In bf16 the embedding scale is sqrt(2048) rounded to bf16 (45.25 at
    full width; 16 at the reduced width), as jnp.asarray(.., x.dtype)
    gives: the port's embedding is bitwise the reference's, and the fp32
    factor would not be (checked at the full width's factor). The soft
    capped logits and the whole forward agree within bf16's rounding."""
    jcfg, tcfg, jp, tp = _model("gemma-2b", "bfloat16")
    tokens = _tokens(jcfg, 2, 20, 5)
    x = lm._embed(tp, tcfg, torch.from_numpy(tokens))
    wx = jlm._embed(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    assert x.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(x), _np(wx))
    full = jax_get_config("gemma-2b")
    scale = torch.tensor(full.d_model ** 0.5, dtype=torch.bfloat16)
    assert float(scale) == float(jnp.asarray(full.d_model ** 0.5, jnp.bfloat16)) == 45.25
    e = tp["embed"][torch.from_numpy(tokens)]
    assert not torch.equal(e * scale, (e.float() * full.d_model ** 0.5).to(e.dtype))
    # the soft cap, in x's dtype
    h = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32) * 40).to(torch.bfloat16)
    got = lm._logits(tp, tcfg, h)
    want = jlm._logits(jp, jcfg, jnp.asarray(_np(h), jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and float(got.abs().max()) <= 30.0
    _close(got, want, dict(rtol=2 ** -7, atol=2 ** -7))
    got, _, _ = lm.forward(tp, tcfg, torch.from_numpy(tokens))
    want, _, _ = jlm.forward(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    err = np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(_np(want))
    assert err < 2e-2, err


# ----------------------------------------------------------------------
# prefill and decode against the reference's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,window,S", [
    ("yi-9b", 0, 20), ("yi-9b", 24, 20), ("gemma-2b", 0, 20),
    ("olmoe-1b-7b", 0, 20), ("olmoe-1b-7b", 24, 20),
    ("deepseek-moe-16b", 0, 20), ("internvl2-76b", 0, 20),
    ("internvl2-76b", 48, 12)])
def test_prefill_and_decode_match_reference(arch, window, S):
    """Batch 2, a prompt that fits the cache, then 12 decode steps
    teacher-forced with the reference's tokens: logits and K/V at the
    per-forward bar at every step, through the ring's wrap where the
    window is shorter than prompt + steps (yi, olmoe). The VLM's windowed
    cache pins its 16 vision tokens before the ring, so its first
    ``window`` slots are the reference's cache (which does not wrap here)."""
    jcfg, tcfg, jp, tp = _model(arch)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    Nv = jcfg.n_vision_tokens
    tokens, vision = _tokens(jcfg, 2, S, 7), _vision(jcfg, 2, 8)
    jb, tb = _batches(jcfg, tokens, vision)
    max_len = Nv + S + 12
    jcache = jmodel.init_cache(2, max_len, window=window)
    tcache = tmodel.init_cache(2, max_len, window=window, device="cpu")
    T = jcache["k"].shape[2]
    assert tcache["k"].shape[2] == T + (Nv if window else 0)
    wl, jcache = jmodel.prefill(jp, jb, jcache, window=window)
    tl, tcache = tmodel.prefill(tp, tb, tcache, window=window)
    _close(tl, wl, FWD_BAR)
    assert tcache["pos"] == int(jcache["pos"]) == Nv + S
    decode = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, window=window))
    for _ in range(12):
        tok = np.array(jnp.argmax(wl, axis=-1), np.int32)
        wl, jcache = decode(jp, jcache, jnp.asarray(tok))
        tl, tcache = tmodel.decode_step(tp, tcache, torch.from_numpy(tok).long(),
                                        window=window)
        _close(tl, wl, FWD_BAR)
        for name in ("k", "v"):
            _close(tcache[name][:, :, :T], jcache[name], FWD_BAR)
    assert tcache["pos"] == Nv + S + 12


def test_full_cache_decode_past_the_end_raises():
    _, tcfg, _, tp = _model("yi-9b")
    cache = lm.init_cache(tcfg, 1, 10)
    _, cache = lm.prefill(tp, tcfg, torch.from_numpy(_tokens(tcfg, 1, 10, 9)), cache)
    with pytest.raises(ValueError, match="clamps the write to slot 9"):
        lm.decode_step(tp, tcfg, cache, torch.tensor([1]))


# ----------------------------------------------------------------------
# the ring repair: decode after a prompt longer than the ring
# ----------------------------------------------------------------------

def _served_logits(prefill, decode, seq, S, n):
    """Prefill seq[:, :S] then decode seq[:, S:S + n], one token a step:
    the logits of positions S-1 .. S+n-1 as numpy [n + 1, B, V]."""
    logits, cache = prefill(seq[:, :S])
    out = [_np(logits)]
    for t in range(n):
        logits, cache = decode(cache, seq[:, S + t])
        out.append(_np(logits))
    return np.stack(out)


def _forward_logits(forward, seq, S, n, Nv):
    """The windowed forward over the whole sequence: the logits of the same
    positions (causal, so each is what serving must give)."""
    return np.moveaxis(_np(forward(seq[:, :S + n]))[:, Nv + S - 1:], 1, 0)


def _port_serving(arch, window, S, n=12):
    jcfg, tcfg, jp, tp = _model(arch)
    model, Nv = build_model(tcfg), jcfg.n_vision_tokens
    seq = _tokens(jcfg, 1, S + n, 11)
    vision = _vision(jcfg, 1, 12)
    tv = None if vision is None else torch.from_numpy(vision)

    def prefill(tokens):
        cache = model.init_cache(1, 0, window=window, device="cpu")
        batch = {"tokens": torch.from_numpy(tokens), "vision_embeds": tv}
        return model.prefill(tp, batch, cache, window=window)

    def decode(cache, tok):
        return model.decode_step(tp, cache, torch.from_numpy(tok), window=window)

    served = _served_logits(prefill, decode, seq, S, n)
    port_fwd = _forward_logits(lambda t: lm.forward(
        tp, tcfg, torch.from_numpy(t), vision_embeds=tv, window=window)[0],
        seq, S, n, Nv)
    ref_fwd = _forward_logits(lambda t: jlm.forward(
        jp, jcfg, jnp.asarray(t, jnp.int32),
        vision_embeds=None if vision is None else jnp.asarray(vision),
        window=window)[0], seq, S, n, Nv)
    return served, port_fwd, ref_fwd


@pytest.mark.parametrize("arch,window,S", [
    ("yi-9b", 4, 10), ("yi-9b", 16, 37), ("gemma-2b", 8, 21),
    ("internvl2-76b", 24, 30)])
def test_ring_decode_matches_windowed_forward(arch, window, S):
    """A prompt longer than the ring whose length the ring does not divide
    (yi: 10 % 4, 37 % 16; the VLM: 16 vision + 30 text tokens against 16
    pinned + 24 ring slots, (46 - 16) % 24 = 6): the port's prefill and 12
    decode steps give, at every position, the windowed forward's logits
    (the port's and the reference's) at the per-forward bar. (An MoE
    decoder is left out: its forward's expert capacity depends on the
    sequence length, so a forward and token-by-token decode route
    differently whatever the cache.)"""
    assert S % window                       # the ring does not divide it
    served, port_fwd, ref_fwd = _port_serving(arch, window, S)
    _close(served, port_fwd, FWD_BAR)
    _close(served, ref_fwd, FWD_BAR)


def _reference_serving(arch, window, S, n=12):
    """The reference's prefill / decode_step against its own windowed
    forward: the largest logit difference over the positions."""
    jcfg, _, jp, _ = _model(arch)
    jmodel, Nv = jax_build_model(jcfg), jcfg.n_vision_tokens
    seq = _tokens(jcfg, 1, S + n, 11)
    vision = _vision(jcfg, 1, 12)
    jv = None if vision is None else jnp.asarray(vision)
    step = jax.jit(lambda c, t: jmodel.decode_step(jp, c, t, window=window))

    def prefill(tokens):
        cache = jmodel.init_cache(1, Nv + S + n, window=window)
        batch = {"tokens": jnp.asarray(tokens, jnp.int32), "vision_embeds": jv}
        return jmodel.prefill(jp, batch, cache, window=window)

    served = _served_logits(prefill, lambda c, t: step(c, jnp.asarray(t, jnp.int32)),
                            seq, S, n)
    ref_fwd = _forward_logits(lambda t: jlm.forward(
        jp, jcfg, jnp.asarray(t, jnp.int32), vision_embeds=jv, window=window)[0],
        seq, S, n, Nv)
    return float(np.abs(served - ref_fwd).max())


def test_reference_ring_misses_its_own_forward():
    """The reference's fault, which the port does not copy: after yi's
    10-token prompt against a 4-slot ring its decode reads more than 0.1
    off its own windowed forward; after an 8- or 12-token prompt (the ring
    divides them) and a 3-token one (shorter than the ring) it meets it.
    Its VLM ring also drops the vision tokens that its forward keeps
    visible, so it misses there even when the ring divides the prompt."""
    assert _reference_serving("yi-9b", 4, 10) > 0.1
    for S in (8, 12, 3):
        assert _reference_serving("yi-9b", 4, S) < FWD_BAR["atol"], S
    assert _reference_serving("internvl2-76b", 24, 32) > 0.1   # 48 % 24 == 0


# ----------------------------------------------------------------------
# the serving engine and the entry points
# ----------------------------------------------------------------------

def _margins(tmodel, tp, prompt, out_tokens):
    """The port's top-2 logit margin at every token of a request,
    teacher-forced with the reference's tokens."""
    cache = tmodel.init_cache(1, len(prompt) + len(out_tokens) + 1, device="cpu")
    logits, cache = tmodel.prefill(tp, {"tokens": torch.from_numpy(prompt[None]).long()},
                                   cache)
    margins = []
    for tok in out_tokens:
        top2 = logits[0].topk(2).values
        margins.append(float(top2[0] - top2[1]))
        logits, cache = tmodel.decode_step(tp, cache, torch.tensor([tok]))
    return margins


def test_serving_engine_matches_reference():
    """gemma-2b reduced, 3 requests over 2 slots (the third admitted when a
    slot frees), full cache. Tokens equal up to the first one where the
    port's teacher-forced top-2 margin is within twice the per-forward bar
    (past that margin the two argmaxes cannot differ)."""
    jcfg, tcfg, jp, tp = _model("gemma-2b")
    rng = np.random.default_rng(10)
    specs = [(30, 4), (20, 6), (33, 5)]          # (prompt length, max_new)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32) for n, _ in specs]
    jengine = JServingEngine(jax_build_model(jcfg), jp, slots=2, max_len=48)
    tengine = ServingEngine(build_model(tcfg), tp, slots=2, max_len=48)
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
        margins = _margins(build_model(tcfg), tp, prompts[uid], jreq.out_tokens)
        for want, got, margin in zip(jreq.out_tokens, treq.out_tokens, margins):
            if margin <= 2 * FWD_BAR["atol"]:
                break                             # a near-tie may flip
            assert got == want, (uid, jreq.out_tokens, treq.out_tokens)
            checked += 1
    assert checked >= 12


def test_model_api_and_serve_entry_point():
    """The API's families, the VLM's batch and loss (its text positions),
    and ``serve`` on the CPU serving gemma-2b reduced by default."""
    _, tcfg, _, _ = _model("internvl2-76b")
    m = build_model(tcfg)
    batch = m.make_batch(torch.Generator().manual_seed(0), 2, 9)
    assert batch["tokens"].shape == (2, 9)
    assert batch["vision_embeds"].shape == (2, tcfg.n_vision_tokens, tcfg.d_model)
    # training (item 15d): the loss over the text positions only
    params = m.init(torch.Generator().manual_seed(0))
    logits = m.forward_logits(params, batch)[:, tcfg.n_vision_tokens:]
    want = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, tcfg.vocab), batch["labels"][:, 1:].reshape(-1))
    torch.testing.assert_close(m.loss(params, batch), want, rtol=1e-6, atol=1e-6)
    assert m.init_cache(1, 40, window=8)["k"].shape[2] == tcfg.n_vision_tokens + 8
    assert m.init_cache(1, 40)["k"].shape[2] == 40
    with pytest.raises(ValueError, match="pins 16 vision tokens"):
        lm.prefill(m.init(torch.Generator().manual_seed(0)), tcfg,
                   batch["tokens"], m.init_cache(2, 40, window=8), window=8)
    done = tserve.main(["--requests", "3", "--slots", "2", "--prompt-len",
                        "12", "--max-new", "4", "--device", "cpu"])
    gemma = get_config("gemma-2b").reduced()
    assert sorted(len(r.out_tokens) for r in done) == [4, 4, 4]
    assert all(0 <= t < gemma.vocab for r in done for t in r.out_tokens)
    done = tserve.serve("olmoe-1b-7b", n_requests=2, slots=2, prompt_len=12,
                        max_new=3, device="cpu")
    assert sorted(len(r.out_tokens) for r in done) == [3, 3]
