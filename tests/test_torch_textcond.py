"""Prompt conditioning of the port against the JAX package, on the CPU: the
frozen text encoder (tokenizer, buckets, the tower carried by the bridge),
the DiT's prompt cross-attention and pooled conditioning vector, the null
branch (exactly the null class), the class degeneracy of a text config,
prompt generation under every exchange policy, guidance and guided video,
``spmd`` and ``spmd_guidance`` on gloo ranks against the reference on XLA
host devices, the prompt-bucket serving lanes against the reference's
engine, ``t_xattn`` pricing and the prompt-priced planners, the
``cond_bucket`` validations, and the stage chain's deliberate difference
(the reference's chain drops the prompt read; the port's refuses prompts).

Sizes: ``tiny-dit.reduced().text_conditioned(8)`` in fp32 with T = 100 and
the reference's nondegenerate weights, carried by the bridge. Bars: the
tower and a forward within 1e-5 absolute, images within 1e-3 relative
(the reference's emulated-vs-spmd bar), served images within 1e-5 of a lone
generate, traces, plans, round reports and modeled seconds ``==``."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import frames as jframes  # noqa: E402
from repro.core import patch_parallel as jpp  # noqa: E402
from repro.core import pipefuse as jpipefuse  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import planners as jplanners  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.models import text_encoder as jte  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro.serving import DiffusionServingEngine as JEngine  # noqa: E402
from repro.serving import plan_cache as jpc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import frames as tframes  # noqa: E402
from repro_torch.core import patch_parallel as tpp  # noqa: E402
from repro_torch.core import pipefuse as tpipefuse  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import planners as tplanners  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core import spmd as tspmd  # noqa: E402
from repro_torch.core.guidance import NULL_COND, GuidancePlan  # noqa: E402
from repro_torch.core.schedule import TemporalPlan  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models import text_encoder as tte  # noqa: E402
from repro_torch.models.diffusion import dit as tdit  # noqa: E402
from repro_torch.serving import DiffusionServingEngine  # noqa: E402
from repro_torch.serving import plan_cache as tpc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR = dict(rtol=0.0, atol=1e-5)
REL_BAR = 1e-3
SEQ_LEN = 8
PROMPTS = ["fox", "a red fox in the deep winter snow", "blue whale",
           "one two three four five six seven"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module's tiny shapes: the suite runs in
    several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """(reference text config, reference weights, port text config, the
    port's copy of the weights, the port's copy of the reference's frozen
    tower)."""
    jcfg = jax_get_config("tiny-dit").reduced().text_conditioned(SEQ_LEN)
    jparams = jdit.nondegenerate_params(jdit.init_params(jax.random.PRNGKey(0),
                                                         jcfg))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tparams = bridge.params_from_jax(np_tree(jparams), device="cpu")
    tower = bridge.params_from_jax(np_tree(jte.frozen_params(jcfg.cond_dim)),
                                   device="cpu")
    return jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)), tparams, tower


@pytest.fixture
def ref_tower(setup, monkeypatch):
    """The port's encoder running the reference's tower weights."""
    tower = setup[4]
    monkeypatch.setattr(tte, "frozen_params",
                        lambda cond_dim, seed=tte.DEFAULT_SEED, device="cpu":
                        tower)
    return tower


def _x(cfg, seed=1, frames=0):
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.channels)
    if frames:
        shape = shape[:1] + (frames,) + shape[1:]
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tok(cfg, prompts, **kw):
    """The reference's tokens as numpy."""
    return np.asarray(jte.encode(prompts, cfg, **kw))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _records(trace):
    return [dataclasses.asdict(e) for e in trace.events]


def _plain(plan):
    return tpc.plan_to_dict(plan) if hasattr(plan, "temporal") else plan


# ----------------------------------------------------------------------
# the frozen text encoder
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cond_seq_len", [1, 4, 8, 32])
def test_tokenize_and_bucket_length_match_reference(cond_seq_len):
    for prompt in PROMPTS + ["", "  Fox  FOX fox ", "é ü ß 東京"]:
        assert tte.tokenize(prompt, cond_seq_len) == \
            jte.tokenize(prompt, cond_seq_len)
    for n in range(0, 40):
        assert tte.bucket_length(n, cond_seq_len) == \
            jte.bucket_length(n, cond_seq_len)
    assert [tte.bucket_length(n, 32) for n in (1, 4, 5, 8, 9, 40)] == \
        [4, 4, 8, 8, 16, 32]
    with pytest.raises(ValueError, match="cond_seq_len"):
        tte.bucket_length(3, 0)


@pytest.mark.parametrize("prompts,length", [
    (["a red fox", "fox"], None),
    (["a red fox in the deep winter snow"], None),
    (["a red fox"], 8),
    ([""], None),
])
def test_encode_matches_reference_tower(setup, ref_tower, prompts, length):
    """The port's encoder on the reference's tower: tokens within 1e-5, the
    mask channel and the zero padding exactly."""
    jcfg, _, tcfg, _, _ = setup
    want = _tok(jcfg, prompts, length=length)
    got = tte.encode(prompts, tcfg, length=length, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **BAR)
    np.testing.assert_array_equal(got[..., -1].numpy(), want[..., -1])
    pad = got[..., -1] == 0
    assert not got[..., :-1][pad].any()


@pytest.mark.parametrize("ids", [[5, 1030, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]])
def test_cond_tokens_from_ids_matches_reference(setup, ref_tower, ids):
    jcfg, _, tcfg, _, _ = setup
    want = np.asarray(jte.cond_tokens_from_ids(ids, jcfg))
    got = tte.cond_tokens_from_ids(ids, tcfg, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **BAR)


def _raises_alike(port, ref):
    with pytest.raises(Exception) as want:
        ref()
    with pytest.raises(type(want.value)) as got:
        port()
    assert str(got.value) == str(want.value)


def test_encoder_errors_match_reference(setup):
    jcfg, _, tcfg, _, _ = setup
    jclass, tclass = jcfg.replace(cross_attn=False, cond_seq_len=0), \
        tcfg.replace(cross_attn=False, cond_seq_len=0)
    _raises_alike(lambda: tte.encode(["fox"], tclass, device="cpu"),
                  lambda: jte.encode(["fox"], jclass))
    _raises_alike(lambda: tte.encode(["fox"], tcfg, length=16, device="cpu"),
                  lambda: jte.encode(["fox"], jcfg, length=16))
    _raises_alike(lambda: tte.cond_tokens_from_ids([], tcfg, device="cpu"),
                  lambda: jte.cond_tokens_from_ids([], jcfg))
    _raises_alike(lambda: tte.cond_tokens_from_ids([1], tclass, device="cpu"),
                  lambda: jte.cond_tokens_from_ids([1], jclass))


def test_frozen_tower_is_the_reference_pytree_drawn_from_a_seed(setup):
    """The port's own tower: the reference's leaf names and shapes, a pure
    function of (cond_dim, seed) drawn on the CPU, cached per device."""
    jcfg = setup[0]
    want = jax.tree_util.tree_map(lambda a: a.shape,
                                  jte.frozen_params(jcfg.cond_dim))
    got = tte.frozen_params(jcfg.cond_dim)
    assert {k: tuple(v.shape) for k, v in got["blocks"].items()} == \
        {k: tuple(v) for k, v in want["blocks"].items()}
    assert tuple(got["embed"].shape) == tuple(want["embed"])
    assert tte.frozen_params(jcfg.cond_dim) is got
    other = tte.frozen_params(jcfg.cond_dim, seed=5)
    assert not torch.equal(other["embed"], got["embed"])
    a = tte.encode(["a red fox"], setup[2], device="cpu")
    assert torch.equal(a, tte.encode(["a red fox"], setup[2], device="cpu"))


def test_encode_needs_a_device_or_a_card(setup):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tte.encode(["fox"], setup[2])


# ----------------------------------------------------------------------
# the null branch and the class degeneracy
# ----------------------------------------------------------------------

def test_null_semantics_match_reference(setup, ref_tower):
    jcfg, _, tcfg, _, _ = setup
    tok = tte.encode(["a red fox"], tcfg, device="cpu")
    null = tte.null_cond(1, tok.shape[1], tcfg, device="cpu")
    assert torch.equal(null, torch.zeros(1, 4, tcfg.cond_dim + 1))
    assert torch.equal(tdit.null_like(tok), null)
    assert int(tdit.null_like(torch.tensor([3]))[0]) == NULL_COND
    g = tdit.guidance_conds(tok)
    assert tuple(g.shape) == (2,) + tuple(tok.shape)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jdit.guidance_conds(jnp.asarray(tok.numpy()))))


@pytest.mark.parametrize("buffered", [False, True])
def test_null_prompt_is_exactly_the_null_class(setup, buffered):
    """The empty prompt sequence conditions exactly as the reserved null
    class: its pooled vector is 0.0 and every block's prompt read adds
    exactly 0.0 (all keys masked: uniform weights over zero values). A
    -inf fill, or scaled_dot_product_attention, gives NaN there."""
    _, _, tcfg, tparams, _ = setup
    x = torch.from_numpy(_x(tcfg, seed=2))
    null = tte.null_cond(1, SEQ_LEN, tcfg, device="cpu")
    bufs = None
    if buffered:
        g = torch.Generator().manual_seed(3)
        shape = tdit.buffer_shape(tcfg, 1)
        bufs = (torch.randn(shape, generator=g), torch.randn(shape, generator=g))
    a, kv_a = tdit.forward_patch(tparams, tcfg, x[:, 4:10], 37, null, 2,
                                 buffers=bufs)
    b, kv_b = tdit.forward_patch(tparams, tcfg, x[:, 4:10], 37,
                                 torch.tensor([NULL_COND]), 2, buffers=bufs)
    assert bool(torch.isfinite(a).all())
    assert torch.equal(a, b)
    assert all(torch.equal(u, v) for u, v in zip(kv_a, kv_b))


def test_text_config_draws_class_leaves_bitwise():
    """The port's own init: a text config adds xq, xkv, xo (zeros) and
    ctx_pool from a stream of its own, so every class leaf is bitwise the
    class config's; nondegenerate_params gives xo its values from a separate
    stream and leaves the class leaves as they are."""
    from repro_torch.configs import get_config
    cfg = get_config("tiny-dit").reduced()
    tcfg = cfg.text_conditioned(cond_seq_len=SEQ_LEN)
    for nondeg in (False, True):
        out = []
        for c in (cfg, tcfg):
            gen = torch.Generator().manual_seed(0)
            p = tdit.init_params(gen, c)
            out.append(tdit.nondegenerate_params(p, gen) if nondeg else p)
        base, text = out
        assert set(text["blocks"]) - set(base["blocks"]) == {"xq", "xkv", "xo"}
        assert set(text) - set(base) == {"ctx_pool"}
        for k, v in base["blocks"].items():
            assert torch.equal(v, text["blocks"][k]), k
        for k, v in base.items():
            if k != "blocks":
                assert torch.equal(v, text[k]), k
        assert bool(text["blocks"]["xo"].any()) == nondeg
    ref = jdit.init_params(jax.random.PRNGKey(0), jax_get_config(
        "tiny-dit").reduced().text_conditioned(SEQ_LEN))
    assert {k: tuple(v.shape) for k, v in text["blocks"].items()} == \
        {k: tuple(v.shape) for k, v in ref["blocks"].items()}
    assert tuple(text["ctx_pool"].shape) == tuple(ref["ctx_pool"].shape)


def test_class_ids_under_text_config_bitwise_class_path(setup):
    """A text-conditioned model fed class ids runs the class path bitwise:
    forward and an emulated generate, against the class config on the
    class leaves of the same weights."""
    _, _, tcfg, tparams, _ = setup
    cfg = tcfg.replace(cross_attn=False, cond_seq_len=0)
    cparams = {k: v for k, v in tparams.items() if k != "ctx_pool"}
    cparams["blocks"] = {k: v for k, v in tparams["blocks"].items()
                         if k not in ("xq", "xkv", "xo")}
    x = torch.from_numpy(_x(cfg))
    cond = torch.tensor([3])
    assert torch.equal(tdit.forward(tparams, tcfg, x, 10, cond),
                       tdit.forward(cparams, cfg, x, 10, cond))
    config = tpipe.StadiConfig.from_occupancies([0.0, 0.5], m_base=8,
                                                m_warmup=2)
    sched = tsam.linear_schedule(100)
    a = tpipe.StadiPipeline(cfg, cparams, sched, config, device="cpu")
    b = tpipe.StadiPipeline(tcfg, tparams, sched, config, device="cpu")
    assert torch.equal(a.generate(x, cond).image, b.generate(x, cond).image)


# ----------------------------------------------------------------------
# the DiT's prompt conditioning against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("rows,buffered", [((0, 16), False), ((4, 12), False),
                                           ((4, 12), True), ((10, 16), True)])
def test_forward_patch_with_tokens_matches_reference(setup, rows, buffered):
    """Prompt tokens of two buckets' worth of real tokens in one batch (a
    row partly masked): eps and fresh K/V within 1e-5."""
    jcfg, jparams, tcfg, tparams, _ = setup
    lo, hi = rows
    x = np.random.default_rng(0).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)[:, lo:hi]
    tok = _tok(jcfg, ["a red fox in the deep winter snow", "fox"])
    bufs = None
    if buffered:
        rng = np.random.default_rng(4)
        shape = jdit.buffer_shape(jcfg, 2)
        bufs = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    want, jkv = jdit.forward_patch(
        jparams, jcfg, jnp.asarray(x), 37, jnp.asarray(tok), lo // 2,
        buffers=None if bufs is None else tuple(map(jnp.asarray, bufs)))
    got, tkv = tdit.forward_patch(
        tparams, tcfg, torch.from_numpy(x), 37, torch.from_numpy(tok), lo // 2,
        buffers=None if bufs is None else tuple(map(torch.from_numpy, bufs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAR)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BAR)


def test_pooled_vector_is_batch_invariant(setup):
    """The prompt's pooled conditioning of a row is bitwise the same alone
    and in a batch of four, at sdxl-dit's widths: the reference's
    broadcast-multiply-reduce projection keeps one order of sums at every
    batch size, where a GEMM (``pooled @ ctx_pool``) takes another
    algorithm for one row than for four. Served lanes stay bitwise their
    lone generate only so. Held to the reference's pooling within 1e-5."""
    g = torch.Generator().manual_seed(0)
    ctx_pool = torch.randn(256, 1152, generator=g) * 0.06
    cond = torch.randn(4, 8, 257, generator=g)
    cond[..., -1] = (torch.rand(4, 8, generator=g) > 0.3).float()
    cond[..., :-1] *= cond[..., -1:]
    batch = tdit._pooled_prompt(ctx_pool, cond)
    for i in range(4):
        assert torch.equal(batch[i:i + 1],
                           tdit._pooled_prompt(ctx_pool, cond[i:i + 1])), i
    jparams = {"ctx_pool": jnp.asarray(ctx_pool.numpy()),
               "t_w1": jnp.zeros((256, 1152)), "t_w2": jnp.zeros((1152, 1152))}
    want = jdit._cond_vector(jparams, None, jnp.zeros(4), jnp.asarray(
        cond.numpy()), 4)
    np.testing.assert_allclose(torch.nn.functional.silu(batch).numpy(),
                               np.asarray(want), **BAR)


def test_guided_forward_and_null_branch_match_reference(setup):
    """Fused guidance over prompt tokens: forward_cfg within 1e-5 of the
    reference's; its null branch is the explicit null_cond forward."""
    jcfg, jparams, tcfg, tparams, _ = setup
    x = _x(tcfg)
    tok = _tok(jcfg, ["a red fox"])
    want = jdit.forward_cfg(jparams, jcfg, jnp.asarray(x), 10, jnp.asarray(tok),
                            3.0)
    got = tdit.forward_cfg(tparams, tcfg, torch.from_numpy(x), 10,
                           torch.from_numpy(tok), 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAR)
    eps2, _ = tdit.forward_patch_cfg(tparams, tcfg, torch.from_numpy(x), 10,
                                     torch.from_numpy(tok), 0, return_kv=False)
    null = tdit.forward(tparams, tcfg, torch.from_numpy(x), 10,
                        tte.null_cond(1, tok.shape[1], tcfg, device="cpu"))
    np.testing.assert_allclose(eps2[1].numpy(), null.numpy(), rtol=0,
                               atol=1e-6)
    assert torch.equal(null, tdit.forward(tparams, tcfg, torch.from_numpy(x),
                                          10, tdit.null_like(
                                              torch.from_numpy(tok))))


def _generate_both(setup, tok, x, **knobs):
    jcfg, jparams, tcfg, tparams, _ = setup
    occ = knobs.pop("occupancies", [0.0, 0.5])
    jres = jpipe.StadiPipeline(
        jcfg, jparams, jsam.linear_schedule(T=100),
        jpipe.StadiConfig.from_occupancies(occ, **knobs)).generate(
            jnp.asarray(x), jnp.asarray(tok))
    tres = tpipe.StadiPipeline(
        tcfg, tparams, tsam.linear_schedule(100),
        tpipe.StadiConfig.from_occupancies(occ, **knobs), device="cpu").generate(
            torch.from_numpy(x), torch.from_numpy(tok))
    return jres, tres


@pytest.mark.parametrize("exchange", ["sync", "stale_async", "predictive"])
def test_prompt_generate_matches_reference(setup, exchange):
    """The emulated prompt generate: image within 1e-3 relative, traces
    (prompt bucket included) ``==``; a second prompt of the same bucket
    steers the image apart."""
    jcfg = setup[0]
    x = _x(jcfg)
    tok = _tok(jcfg, ["a red fox"])
    jres, tres = _generate_both(setup, tok, x, m_base=8, m_warmup=2,
                                exchange=exchange)
    assert _rel(tres.image.numpy(), jres.image) < REL_BAR
    assert _records(tres.trace) == _records(jres.trace)
    assert tres.trace.cond_tokens == jres.trace.cond_tokens == SEQ_LEN
    other = tpipe.StadiPipeline(
        setup[2], setup[3], tsam.linear_schedule(100),
        tpipe.StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2,
                                           exchange=exchange),
        device="cpu").generate(torch.from_numpy(x), torch.from_numpy(
            _tok(jcfg, ["blue whale song"])))
    assert not torch.equal(other.image, tres.image)


def test_guided_prompt_generate_matches_reference(setup):
    jcfg = setup[0]
    x = _x(jcfg, seed=5)
    tok = _tok(jcfg, ["a red fox in the deep winter snow"])
    jres, tres = _generate_both(setup, tok, x, m_base=8, m_warmup=2,
                                cfg_scale=2.5)
    assert _rel(tres.image.numpy(), jres.image) < REL_BAR
    assert _records(tres.trace) == _records(jres.trace)


# ----------------------------------------------------------------------
# guided text-to-video
# ----------------------------------------------------------------------

VIDEO = dict(occupancies=[0.0, 0.0, 0.5, 0.5], m_base=8, m_warmup=2,
             planner="stadi_video", num_frames=2, guidance="fused",
             cfg_scale=3.0)


def test_guided_video_matches_reference_and_frame0_is_the_image(setup):
    """stadi_video with fused CFG on a prompt: the plan carries both axes,
    the clip is within 1e-3 of the reference's, and frame 0 is bitwise the
    guided image on the plan's schedule."""
    jcfg, _, tcfg, tparams, _ = setup
    x = _x(jcfg, frames=2)
    tok = _tok(jcfg, ["a red fox"])
    jres, tres = _generate_both(setup, tok, x, **VIDEO)
    plan = tres.plan
    assert plan.guidance.mode == "fused" and plan.frames.num_frames == 2
    assert _rel(tres.image.numpy(), jres.image) < REL_BAR
    assert _records(tres.trace) == _records(jres.trace)
    sched = tsam.linear_schedule(100)
    seq = tframes.run_frames(tparams, tcfg, sched, torch.from_numpy(x),
                             torch.from_numpy(tok), plan.temporal, plan.patches,
                             frames=tframes.FramePlan(2, (2,)),
                             guidance=plan.guidance).image
    img = tpp.run_schedule(tparams, tcfg, sched, torch.from_numpy(x[:, 0]),
                           torch.from_numpy(tok), plan.temporal, plan.patches,
                           guidance=plan.guidance).image
    assert torch.equal(seq[:, 0], img)
    assert torch.equal(tres.image[:, 0], img)


def test_split_guidance_on_frames_refused_as_reference(setup):
    jcfg, jparams, tcfg, tparams, _ = setup
    knobs = dict(VIDEO, guidance="split")
    occ = knobs.pop("occupancies")
    _raises_alike(
        lambda: tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                                    tpipe.StadiConfig.from_occupancies(
                                        occ, **knobs), device="cpu").plan(),
        lambda: jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                                    jpipe.StadiConfig.from_occupancies(
                                        occ, **knobs)).plan())


# ----------------------------------------------------------------------
# spmd and spmd_guidance on prompt tokens: gloo ranks vs XLA host devices
# ----------------------------------------------------------------------

SCALE = 2.5
PLAN4 = dict(steps=[8, 8, 4, 4], ratios=[1, 1, 2, 2], excluded=[False] * 4,
             m_base=8, m_warmup=2)
PLAN2 = dict(steps=[8, 4], ratios=[1, 2], excluded=[False] * 2, m_base=8,
             m_warmup=2)
SPMD_VARIANTS = {
    "spmd": ("run_spmd", PLAN4, [3, 2, 2, 1], None),
    "split": ("run_spmd_guidance", PLAN2, [5, 3],
              ("split", SCALE, (0, 1), (2, 3))),
}

JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import sampler, spmd
    from repro.core.guidance import GuidancePlan
    from repro.core.schedule import TemporalPlan

    data = np.load(sys.argv[1], allow_pickle=True)
    variants = data["variants"].item()
    params = {}
    for key in data.files:
        if key.startswith("p/"):
            node = params
            *path, leaf = key[2:].split("/")
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = jnp.asarray(data[key])
    assert len(jax.devices()) == 4, jax.devices()
    cfg = get_config("tiny-dit").reduced().text_conditioned(%d)
    sched = sampler.linear_schedule(T=100)
    x_T, tok = jnp.asarray(data["x_T"]), jnp.asarray(data["tok"])
    out = {}
    for label, (fn, plan, patches, g) in variants.items():
        args = (params, cfg, sched, x_T, tok, TemporalPlan(**plan), patches)
        if fn == "run_spmd":
            img = spmd.run_spmd(*args)
        else:
            img = spmd.run_spmd_guidance(*args, GuidancePlan(*g))
        out[label] = np.asarray(img)
    np.savez(sys.argv[2], **out)
    print("JAX_SPMD_OK")
""" % SEQ_LEN)


def _load_params(data):
    tree = {}
    for key in data.files:
        if key.startswith("p/"):
            node = tree
            *parts, leaf = key[2:].split("/")
            for name in parts:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return bridge.params_from_jax(tree, device="cpu")


def _spmd_rank(ctx, path, variants):
    """One port rank: the bridged weights and tokens through every
    variant."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler, spmd

    data = np.load(path, allow_pickle=True)
    params = _load_params(data)
    cfg = get_config("tiny-dit").reduced().text_conditioned(SEQ_LEN)
    sched = sampler.linear_schedule(T=100)
    x_T, tok = torch.from_numpy(data["x_T"]), torch.from_numpy(data["tok"])
    out = {}
    for label, (fn, plan, patches, g) in variants.items():
        args = (params, cfg, sched, x_T, tok, TemporalPlan(**plan), patches)
        if fn == "run_spmd":
            img = spmd.run_spmd(*args)
        else:
            img = spmd.run_spmd_guidance(*args, GuidancePlan(*g))
        out[label] = img.numpy()
    return out


@pytest.fixture(scope="module")
def spmd_runs(setup, tmp_path_factory):
    """Both packages on the same weights, noise and prompt tokens: the
    reference in a subprocess with 4 XLA host devices, the port on 4 gloo
    ranks."""
    jcfg, jparams = setup[:2]
    tmp = tmp_path_factory.mktemp("spmd_prompt")
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = np.asarray(v)
    walk(jparams, "")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, x_T=_x(jcfg, seed=3),
             tok=_tok(jcfg, ["a red fox in the deep winter snow"]),
             variants=np.array(SPMD_VARIANTS, dtype=object), **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    env.pop("STADI_HOST_DEVICES", None)
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(inputs),
                        str(tmp / "jax.npz")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0 and "JAX_SPMD_OK" in r.stdout, r.stderr[-3000:]
    want = dict(np.load(tmp / "jax.npz"))
    got = ranks.spawn(_spmd_rank, 4, device_type="cpu",
                      args=(str(inputs), SPMD_VARIANTS), timeout=240)
    return want, got


@pytest.mark.parametrize("label", list(SPMD_VARIANTS))
def test_spmd_on_prompt_tokens_matches_reference(spmd_runs, label):
    """Prompt tokens flow through the ranks opaquely (the split placement's
    uncond ranks take the all-zero sequence): every rank's image within
    1e-3 of the reference's, and the same on every rank."""
    want, got = spmd_runs
    for rank_out in got:
        assert _rel(rank_out[label], want[label]) < REL_BAR
        np.testing.assert_array_equal(rank_out[label], got[0][label])


# ----------------------------------------------------------------------
# the prompt-bucket serving lanes against the reference's engine
# ----------------------------------------------------------------------

def _engines(setup, slots=3, **knobs):
    jcfg, jparams, tcfg, tparams, _ = setup
    config = dict(m_base=8, m_warmup=2, **knobs)
    je = JEngine(jpipe.StadiPipeline(
        jcfg, jparams, jsam.linear_schedule(T=100),
        jpipe.StadiConfig.from_occupancies([0.0, 0.5], **config)), slots=slots)
    tpipe_ = tpipe.StadiPipeline(
        tcfg, tparams, tsam.linear_schedule(100),
        tpipe.StadiConfig.from_occupancies([0.0, 0.5], **config), device="cpu")
    return je, DiffusionServingEngine(tpipe_, slots=slots), tpipe_


@pytest.mark.parametrize("exchange", ["sync", "stale_async", "predictive"])
def test_prompt_lanes_match_reference_engine_and_generate(setup, exchange):
    """Mixed-bucket prompt lanes (buckets 4 and 8) and a guided one: images
    within 1e-5 of the reference engine's and of the port's lone generate;
    admissions, lanes, exchange kinds, placements, modeled seconds and SLO
    verdicts ``==``; dispatches grouped by (guidance, bucket)."""
    jcfg = setup[0]
    je, te, pipe = _engines(setup, exchange=exchange)
    subs = []
    for uid, prompt in enumerate(PROMPTS):
        x = _x(jcfg, seed=40 + uid)
        tok = _tok(jcfg, [prompt])
        kw = dict(cfg_scale=2.5 if uid == 2 else None, slo_s=0.05 * (uid + 1))
        subs.append((je.submit(jnp.asarray(x), jnp.asarray(tok), **kw),
                     te.submit(torch.from_numpy(x), torch.from_numpy(tok), **kw),
                     x, tok, kw["cfg_scale"]))
    je.run_to_completion()
    te.run_to_completion()
    assert {tok.shape[1] for *_, tok, _ in subs} == {4, 8}
    for jr, tr, x, tok, scale in subs:
        np.testing.assert_allclose(tr.image.numpy(), np.asarray(jr.image),
                                   **BAR)
        assert (tr.uid, tr.admit_round, tr.finish_round, tr.slo_met) == \
            (jr.uid, jr.admit_round, jr.finish_round, jr.slo_met)
        assert tr.modeled_latency_s == jr.modeled_latency_s
        lone = pipe if not scale else tpipe.StadiPipeline(
            pipe.model_cfg, pipe.params, pipe.sched, dataclasses.replace(
                pipe.config, cfg_scale=scale), device="cpu")
        want = lone.generate(torch.from_numpy(x), torch.from_numpy(tok)).image
        torch.testing.assert_close(tr.image, want, rtol=0, atol=1e-5)
    fields = ("admitted", "warmup_lanes", "adaptive_lanes", "exchange_kinds",
              "placement", "modeled_s")
    assert [[getattr(r, f) for f in fields] for r in te.rounds] == \
        [[getattr(r, f) for f in fields] for r in je.rounds]
    assert set(te.stats()["dispatches_by_bucket"]) == {"plain/4", "plain/8",
                                                       "guided/4"}


def test_engine_prompt_validation_matches_reference(setup):
    """The class engine refuses tokens; the prompt engine refuses class ids,
    tokens without the mask channel and buckets past cond_seq_len, with
    the reference's messages."""
    jcfg, jparams, tcfg, tparams, _ = setup
    je, te, _ = _engines(setup, slots=2)
    jclass = jcfg.replace(cross_attn=False, cond_seq_len=0)
    tclass = tcfg.replace(cross_attn=False, cond_seq_len=0)
    conf = dict(m_base=8, m_warmup=2)
    jce = JEngine(jpipe.StadiPipeline(jclass, jparams, jsam.linear_schedule(
        T=100), jpipe.StadiConfig.from_occupancies([0.0, 0.5], **conf)), slots=2)
    tce = DiffusionServingEngine(tpipe.StadiPipeline(
        tclass, tparams, tsam.linear_schedule(100),
        tpipe.StadiConfig.from_occupancies([0.0, 0.5], **conf), device="cpu"),
        slots=2)
    x = _x(jcfg)
    tok = _tok(jcfg, ["fox"])
    cases = [(tce, jce, tok), (te, je, 3),
             (te, je, np.zeros((1, 4, jcfg.cond_dim), np.float32)),
             (te, je, np.zeros((1, 16, jcfg.cond_dim + 1), np.float32)),
             (te, je, np.zeros((2, 4, jcfg.cond_dim + 1), np.float32))]
    for t_engine, j_engine, cond in cases:
        tc = torch.from_numpy(cond) if isinstance(cond, np.ndarray) else cond
        jc = jnp.asarray(cond) if isinstance(cond, np.ndarray) else cond
        with pytest.raises(ValueError) as want:
            j_engine.submit(jnp.asarray(x), jc)
        with pytest.raises(ValueError) as got:
            t_engine.submit(torch.from_numpy(x), tc)
        assert str(got.value).replace("repro_torch.", "repro.") == \
            str(want.value)


def test_video_lanes_keep_the_plans_scale(setup):
    """Video lanes run the plan's fused CFG: a request's scale must match
    it, and an unguided plan serves no guided clip (the reference's
    messages)."""
    jcfg, _, tcfg, tparams, _ = setup
    knobs = dict(VIDEO)
    occ = knobs.pop("occupancies")
    sched = tsam.linear_schedule(100)
    engine = DiffusionServingEngine(tpipe.StadiPipeline(
        tcfg, tparams, sched, tpipe.StadiConfig.from_occupancies(occ, **knobs),
        device="cpu"), slots=2)
    x = torch.from_numpy(_x(jcfg, frames=2))
    tok = torch.from_numpy(_tok(jcfg, ["fox"]))
    with pytest.raises(ValueError, match="cannot override"):
        engine.submit(x, tok, cfg_scale=5.0)
    req = engine.submit(x, tok, cfg_scale=3.0)
    engine.run_to_completion()
    want = engine.pipeline.generate(x, tok).image
    assert req.guided and torch.equal(req.image, want)
    plain = DiffusionServingEngine(tpipe.StadiPipeline(
        tcfg, tparams, sched, tpipe.StadiConfig.from_occupancies(
            occ, **dict(knobs, cfg_scale=0.0, guidance="none")),
        device="cpu"), slots=2)
    with pytest.raises(ValueError, match="fused CFG"):
        plain.submit(x, tok, cfg_scale=3.0)


# ----------------------------------------------------------------------
# pricing: t_xattn, the prompt-priced planners, the cond_bucket knob
# ----------------------------------------------------------------------

def test_t_xattn_prices_prompt_tokens_as_reference(setup):
    """The simulate backend charges t_xattn a prompt token a row: modeled
    latency ``==`` the reference's, monotone in the bucket, and unchanged
    with t_xattn unset."""
    jbase = jax_get_config("tiny-dit").reduced()
    tbase = DiTConfig(**dataclasses.asdict(jbase))
    lats = {}
    for t_xattn in (1e-5, 0.0):
        for bucket in (0, 8, 32):
            got = []
            for pkg, base in ((tpipe, tbase), (jpipe, jbase)):
                cm = (tsim if pkg is tpipe else jsim).CostModel(
                    t_fixed=1e-3, t_row=1e-4, t_xattn=t_xattn)
                cfg = base if bucket == 0 else base.text_conditioned(bucket)
                config = pkg.StadiConfig.from_occupancies(
                    [0.0, 0.5], m_base=8, m_warmup=2, backend="simulate",
                    cost_model=cm)
                kw = dict(device="cpu") if pkg is tpipe else {}
                got.append(pkg.StadiPipeline(cfg, None, None, config,
                                             **kw).generate().latency_s)
            assert got[0] == got[1]
            lats[(t_xattn, bucket)] = got[0]
    assert lats[(1e-5, 0)] < lats[(1e-5, 8)] < lats[(1e-5, 32)]
    assert lats[(0.0, 0)] == lats[(0.0, 8)] == lats[(0.0, 32)]


PLANNER_CASES = {
    "stadi_guidance": (dict(cfg_scale=2.0), dict(
        t_fixed=5e-3, t_row=5.5e-4, t_xattn=2e-5, link_bw=1.25e9,
        link_latency=50e-6)),
    "stadi_seq": (dict(seq_shards=0, n_heads=4, exchange="ring"), dict(
        t_fixed=1e-5, t_row=1e-5, t_ctx=5e-4, t_xattn=4e-5, link_bw=1e9,
        link_latency=1e-7)),
    "stadi_video": (dict(num_frames=4), dict(
        t_fixed=1e-5, t_row=1e-5, t_ctx=5e-3, t_xattn=4e-4, link_bw=1e9,
        link_latency=1e-7)),
}


@pytest.mark.parametrize("bucket", [4, 8, 32])
@pytest.mark.parametrize("planner", sorted(PLANNER_CASES))
def test_prompt_priced_plans_match_reference(planner, bucket):
    """Each prompt-priced planner ``==`` the reference's at the bucket, over
    seeded random clusters; the bucket changes the modeled cost."""
    extra, cm = PLANNER_CASES[planner]
    rng = np.random.default_rng(bucket)
    for _ in range(3):
        occ = sorted(rng.uniform(0.0, 0.7, size=4).round(2).tolist())
        plans = {}
        for bkt in (bucket, 0):
            for name, pkg, sim, planners in (
                    ("port", tpipe, tsim, tplanners),
                    ("ref", jpipe, jsim, jplanners)):
                knobs = pkg.StadiConfig.from_occupancies(
                    occ, m_base=16, m_warmup=4, planner=planner,
                    kv_row_bytes=4096, latent_bytes=16384, cond_bucket=bkt,
                    cost_model=sim.CostModel(**cm), **extra)
                plans[(name, bkt)] = planners.get_planner(planner)(
                    knobs.speeds, knobs, 8)
        assert _plain(plans[("port", bucket)]) == _plain(plans[("ref", bucket)])
        assert _plain(plans[("port", 0)]) == _plain(plans[("ref", 0)])
        assert plans[("port", bucket)].modeled_interval_cost > \
            plans[("port", 0)].modeled_interval_cost


@pytest.mark.parametrize("bucket,text", [(-1, True), (8, False), (16, True)])
def test_cond_bucket_validation_matches_reference(setup, bucket, text):
    jcfg, jparams, tcfg, tparams, _ = setup
    if not text:
        jcfg = jcfg.replace(cross_attn=False, cond_seq_len=0)
        tcfg = tcfg.replace(cross_attn=False, cond_seq_len=0)
    conf = dict(m_base=8, m_warmup=2, cond_bucket=bucket)
    _raises_alike(
        lambda: tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                                    tpipe.StadiConfig.from_occupancies(
                                        [0.0, 0.5], **conf), device="cpu"),
        lambda: jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                                    jpipe.StadiConfig.from_occupancies(
                                        [0.0, 0.5], **conf)))


def test_prompt_bucket_keys_the_plan_as_reference(setup):
    """A text model plans its cond_seq_len unless a bucket is pinned, and
    the plan-cache workload key carries the bucket in both packages."""
    jcfg, jparams, tcfg, tparams, _ = setup
    for bucket, want in ((0, SEQ_LEN), (4, 4)):
        conf = dict(m_base=8, m_warmup=2, cond_bucket=bucket)
        t = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                                tpipe.StadiConfig.from_occupancies(
                                    [0.0, 0.5], **conf), device="cpu")
        j = jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                                jpipe.StadiConfig.from_occupancies(
                                    [0.0, 0.5], **conf))
        tk, jk = t._workload_key(t._plan_knobs()), j._workload_key(
            j._plan_knobs())
        assert tk == jk and tk["cond_bucket"] == want
        assert jpc.plan_to_dict(j.plan()) == tpc.plan_to_dict(t.plan())


# ----------------------------------------------------------------------
# the stage chain: the reference drops the prompt read, the port refuses
# ----------------------------------------------------------------------

def test_reference_stage_chain_drops_the_prompt_read(setup):
    """The reference's chain calls block_stack without prompt_ctx: scaling
    every block's cross-attention out-projection leaves its micro-task
    (``displaced_step``, a patch through both stages against the displaced
    context) bitwise as it was, where the same patch through
    ``forward_patch`` (the emulated step) moves. The chain's warm-up and
    bootstrap steps run the full forward, so only its adaptive steps lose
    the read. (The port refuses prompts on the chain rather than copy
    this.)"""
    jcfg, jparams = setup[:2]
    x = jnp.asarray(_x(jcfg)[:, 4:10])
    tok = jnp.asarray(_tok(jcfg, ["a red fox"]))
    rng = np.random.default_rng(6)
    shape = jdit.buffer_shape(jcfg, 1)
    ctx = [jnp.asarray(rng.standard_normal(shape).astype(np.float32))
           for _ in range(2)]
    scaled = dict(jparams)
    scaled["blocks"] = dict(jparams["blocks"], xo=3.0 * jparams["blocks"]["xo"])
    chain, emulated = {}, {}
    for name, p in (("base", jparams), ("scaled", scaled)):
        chain[name] = np.asarray(jpipefuse.displaced_step(
            p, jcfg, x, 37, tok, 2, ctx[0], ctx[1], ((0, 1), (1, 2)))[0])
        emulated[name] = np.asarray(jdit.forward_patch(
            p, jcfg, x, 37, tok, 2, buffers=tuple(ctx))[0])
    assert _rel(emulated["scaled"], emulated["base"]) > 1e-3
    np.testing.assert_array_equal(chain["scaled"], chain["base"])


def test_port_refuses_prompts_on_the_stage_chain(setup):
    """The port's pipefuse backend, spmd_pipefuse and the staged serving
    stepper refuse prompt tokens at two stages, saying why; at one stage
    the chain is the emulated path and serves them."""
    _, _, tcfg, tparams, _ = setup
    x = torch.from_numpy(_x(tcfg))
    tok = torch.from_numpy(_tok(setup[0], ["a red fox"]))
    sched = tsam.linear_schedule(100)
    plan = TemporalPlan([8, 4], [1, 2], [False, False], 8, 2)
    with pytest.raises(ValueError, match="no prompt cross-attention"):
        tpipefuse.run_pipefuse(tparams, tcfg, sched, x, tok, plan, [5, 3],
                               [1, 1])
    with pytest.raises(ValueError, match="spmd_pipefuse backend takes class"):
        tspmd.run_spmd_pipefuse(tparams, tcfg, sched, x, tok, plan, [5, 3],
                                [1, 1])
    staged = tpipe.StadiConfig.from_occupancies(
        [0.0, 0.5], m_base=8, m_warmup=2, backend="pipefuse", num_stages=2)
    pipe = tpipe.StadiPipeline(tcfg, tparams, sched, staged, device="cpu")
    with pytest.raises(ValueError, match="pipefuse backend takes class"):
        pipe.generate(x, tok)
    with pytest.raises(ValueError, match="staged pipefuse stepper"):
        DiffusionServingEngine(pipe, slots=2).submit(x, tok)
    one = dataclasses.replace(staged, num_stages=1)
    emulated = dataclasses.replace(staged, backend="emulated", num_stages=1)
    a = tpipe.StadiPipeline(tcfg, tparams, sched, one, device="cpu")
    b = tpipe.StadiPipeline(tcfg, tparams, sched, emulated, device="cpu")
    assert torch.equal(a.generate(x, tok).image, b.generate(x, tok).image)
    engine = DiffusionServingEngine(a, slots=2)
    req = engine.submit(x, tok)
    engine.run_to_completion()
    assert req.done


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

def test_stadi_infer_prompt_flags():
    from repro_torch.launch import stadi_infer
    base = ["--device", "cpu", "--reduced", "--m-base", "8", "--m-warmup", "2"]
    out = stadi_infer.main(base + ["--prompt", "a red fox"])
    assert out["finite"] and out["cond_bucket"] == 4
    out = stadi_infer.main(base + ["--cond-tokens", "5", "--cond-seq-len", "16",
                                   "--cfg-scale", "4.0"])
    assert out["finite"] and out["cond_bucket"] == 8
    out = stadi_infer.main(base + ["--prompt", "fox", "--backend", "simulate"])
    assert out["cond_bucket"] == 4
    for clash in (["--cond", "3", "--prompt", "fox"],
                  ["--prompt", "fox", "--cond-tokens", "4"]):
        with pytest.raises(SystemExit):
            stadi_infer.main(base + clash)
