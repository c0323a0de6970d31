"""The frame axis of the port (DESIGN.md §16) against the JAX package, on the
CPU, case for case with tests/test_frames.py: the frame partition and row
layout, ``FramePlan`` validation, the ``FrameShard`` lowering and replayed
frame counts, the staleness bound, the registry and config errors, the
``stadi_video`` plans and the frame-priced ``simulate`` makespans (all
``==``), and ``run_frames``, unguided and fused-guided under the sync,
stale_async and predictive exchanges, within ``REL_BAR`` of the reference's
video. ``num_frames=1`` and frame 0 are bitwise the image path, and the
video is bitwise the same under every frame placement. Sizes are
``tiny-dit.reduced()`` in fp32, F = 3, T = 100.

The weights are the nondegenerate ones with the blocks' adaLN modulation
scaled by ``GAIN``, so that attention, and with it the cross-frame context,
moves the video: running each frame alone moves it by more than 100x the
bar, and each planted fault of the frame axis (``FRAME_FAULTS``) by more
than 10x, while the port reads within 4e-7 of the reference
(``python tests/test_torch_frames.py`` prints the readings)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import frames as jfr  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import planners as jplanners  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core.guidance import GuidancePlan as JGuidancePlan  # noqa: E402
from repro.core.schedule import TemporalPlan as JTemporalPlan  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import frames as tfr  # noqa: E402
from repro_torch.core import patch_parallel as tpp  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import planners as tplanners  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.guidance import GuidancePlan  # noqa: E402
from repro_torch.core.schedule import TemporalPlan  # noqa: E402

#: video bar against the reference: 4e-7 read; running each frame alone
#: reads 100x this or more, the least planted fault 10x or more
REL_BAR = 1e-5
#: scale of the blocks' modulation weights over nondegenerate_params' 0.02
GAIN = 15.0
F = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for these tiny shapes (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build_model():
    jcfg = jax_get_config("tiny-dit").reduced()       # 2 blocks, 8 token rows
    np_params = jax.tree_util.tree_map(np.asarray, jdit.nondegenerate_params(
        jdit.init_params(jax.random.PRNGKey(0), jcfg)))
    blocks = dict(np_params["blocks"])
    for name in ("mod_w", "mod_b"):
        blocks[name] = blocks[name] * np.float32(GAIN)
    np_params = dict(np_params, blocks=blocks)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal((1, F, jcfg.latent_size, jcfg.latent_size,
                               jcfg.channels)).astype(np.float32)
    return (jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)),
            bridge.params_from_jax(np_params, device="cpu"), x_T)


@pytest.fixture(scope="module")
def model():
    return _build_model()


def _plain(x):
    """Dataclasses of either package -> (class name, field dict)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _raises_alike(port_call, ref_call, exc=ValueError):
    """Both packages raise ``exc`` with the same message."""
    with pytest.raises(exc) as jerr:
        ref_call()
    with pytest.raises(exc) as terr:
        port_call()
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


# ----------------------------------------------------------------------
# the frame partition, the row layout and FramePlan: ==
# ----------------------------------------------------------------------

PARTITION_CASES = [(4, 1, None), (4, 2, None), (4, 2, [1.0, 0.5]),
                   (3, 3, [10.0, 0.01, 0.01]), (8, 4, [1.0, 0.8, 0.6, 0.5]),
                   (16, 3, [2.0, 1.0, 0.5]), (8, 8, None), (5, 2, [9.0, 1.0])]


@pytest.mark.parametrize("num_frames,n_groups,speeds", PARTITION_CASES)
def test_frame_partition_matches_reference(num_frames, n_groups, speeds):
    groups = tfr.frame_partition(num_frames, n_groups, speeds)
    assert groups == jfr.frame_partition(num_frames, n_groups, speeds)
    assert sum(groups) == num_frames and min(groups) >= 1
    plan = tfr.make_frame_plan(num_frames, n_groups, speeds)
    assert plan.bounds == jfr.make_frame_plan(num_frames, n_groups,
                                              speeds).bounds
    assert [plan.row_of(f) for f in range(num_frames)] == [
        g for g, n in enumerate(groups) for _ in range(n)]


def test_frame_partition_errors_match_reference():
    for args in ((2, 3), (4, 0)):
        _raises_alike(lambda: tfr.frame_partition(*args),
                      lambda: jfr.frame_partition(*args))


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=60, deadline=None)
@given(num_frames=st.integers(1, 64), n_groups=st.integers(1, 8),
       speeds=st.one_of(st.none(), st.lists(st.floats(0.05, 4.0),
                                            min_size=1, max_size=8)))
def test_frame_partition_properties(num_frames, n_groups, speeds):
    n_groups = min(n_groups, num_frames)
    groups = tfr.frame_partition(num_frames, n_groups, speeds)
    assert groups == jfr.frame_partition(num_frames, n_groups, speeds)
    sp = list(speeds)[:n_groups] if speeds else [1.0] * n_groups
    sp += [sp[-1]] * (n_groups - len(sp))
    for i, vi in enumerate(sp):                  # speed-proportional
        for j, vj in enumerate(sp):
            if vi > vj:
                assert groups[i] >= groups[j]


@pytest.mark.parametrize("args", [(0, (1,)), (4, ()), (4, (4, 0)),
                                  (4, (2, 1))])
def test_frame_plan_validation_matches_reference(args):
    _raises_alike(lambda: tfr.FramePlan(*args), lambda: jfr.FramePlan(*args))
    assert not tfr.FramePlan(1, (1,)).framed and tfr.FramePlan(2, (2,)).framed


def test_frame_group_layout_matches_reference():
    for speeds, G in (([1.0, 0.5, 0.8, 0.6], 2),
                      ([1.0, 0.9, 0.8, 0.7, 0.1], 2),
                      ([1.0, 0.6, 0.4], 3), ([1.0, 1.0, 0.5, 0.5], 1)):
        assert tfr.frame_group_layout(speeds, G) == \
            jfr.frame_group_layout(speeds, G)
    assert tfr.frame_group_layout([1.0, 0.5, 0.8, 0.6], 2) == (
        [[1.0, 0.8], [0.6, 0.5]], [1.8, 1.1])
    _raises_alike(lambda: tfr.frame_group_layout([1.0, 0.5], 3),
                  lambda: jfr.frame_group_layout([1.0, 0.5], 3))


# ----------------------------------------------------------------------
# the IR: FrameShard and the replayed frame counts: ==
# ----------------------------------------------------------------------

LOWER_CASES = [("sync", 2, (3, 1)), ("stale_async", 2, (3, 1)),
               ("predictive", 3, (2, 1)), ("stale_async", 4, (1,))]


@pytest.mark.parametrize("exchange,refresh,groups", LOWER_CASES)
def test_frameshard_lowering_matches_reference(exchange, refresh, groups):
    tp = TemporalPlan([16, 8], [1, 2], [False, False], 16, 4)
    jp = JTemporalPlan([16, 8], [1, 2], [False, False], 16, 4)
    tf = tfr.FramePlan(sum(groups), groups)
    jf = jfr.FramePlan(sum(groups), groups)
    tpol = tcomm.get_exchange(exchange, refresh)
    jpol = jcomm.get_exchange(exchange, refresh)
    got = list(tev.lower(tp, [4, 4], tpol, frames=tf))
    assert _plain(got) == _plain(list(jev.lower(jp, [4, 4], jpol, frames=jf)))
    shards = [e for e in got if isinstance(e, tev.FrameShard)]
    intervals = [e for e in got if isinstance(e, tev.ComputeInterval)]
    assert len(shards) == (len(intervals) if tf.framed else 0)
    assert all(s.num_frames == tf.num_frames for s in shards)
    assert _plain(tev.replay(tp, [4, 4], tpol, frames=tf)) == \
        _plain(jev.replay(jp, [4, 4], jpol, frames=jf))
    assert all(r.frames == tf.num_frames
               for r in tev.replay(tp, [4, 4], tpol, frames=tf))


# ----------------------------------------------------------------------
# the staleness bound, the registries and the config errors
# ----------------------------------------------------------------------

def _jpipe(model, **kw):
    jcfg, jparams = model[0], model[1]
    knobs = dict(m_base=8, m_warmup=2, **kw)
    occ = knobs.pop("occupancies", [0.0, 0.4])
    return jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                               jpipe.StadiConfig.from_occupancies(occ, **knobs))


def _tpipe(model, **kw):
    tcfg, tparams = model[2], model[3]
    knobs = dict(m_base=8, m_warmup=2, **kw)
    occ = knobs.pop("occupancies", [0.0, 0.4])
    if "cost_model" in knobs and knobs["cost_model"] is not None:
        knobs["cost_model"] = tsim.CostModel(
            **dataclasses.asdict(knobs["cost_model"]))
    return tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                               tpipe.StadiConfig.from_occupancies(occ, **knobs),
                               device="cpu")


@pytest.mark.parametrize("refresh", [2, 3])
def test_max_frame_staleness_matches_reference(model, refresh):
    x = torch.from_numpy(model[4])
    res = _tpipe(model, num_frames=F, exchange="stale_async",
                 exchange_refresh=refresh).generate(x, torch.tensor([1]))
    worst = tfr.max_frame_staleness(res.trace.events)
    assert worst == jfr.max_frame_staleness(res.trace.events)
    assert 0 < worst <= refresh
    recs = tev.replay(TemporalPlan([16, 16], [1, 1], [False, False], 16, 4),
                      [4, 4], tcomm.get_exchange("stale_async", 4))
    assert tfr.max_frame_staleness(recs) == 0


def test_registries_name_frame_entries():
    assert "spmd_frames" in tpipe.EXECUTORS and "stadi_video" in \
        tplanners.PLANNERS
    assert set(tpipe.FRAME_BACKENDS) == set(jpipe.FRAME_BACKENDS)
    with pytest.raises(KeyError, match="spmd_frames"):
        tpipe.get_executor("no-such-backend")
    with pytest.raises(KeyError, match="stadi_video"):
        tplanners.get_planner("no-such-planner")


BAD_CONFIGS = [
    dict(num_frames=0), dict(frame_groups=-1), dict(backend="spmd"),
    dict(backend="pipefuse"), dict(frame_groups=4),
    dict(num_frames=8, frame_groups=3, planner="stadi_video"),
    dict(cfg_scale=2.0, guidance="split"),
    dict(cfg_scale=2.0, guidance="interleaved"), dict(seq_shards=2),
    dict(num_stages=2), dict(rebalance_every=2),
    dict(num_frames=1, frame_groups=2)]


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=lambda d: ",".join(
    f"{k}={v}" for k, v in d.items()))
def test_pipeline_rejects_bad_frame_configs_as_reference(model, bad):
    knobs = dict(num_frames=F, **bad) if "num_frames" not in bad else bad
    msg = _raises_alike(lambda: _tpipe(model, **knobs),
                        lambda: _jpipe(model, **knobs))
    assert msg


def test_frame_resolution_and_backend_gate_match_reference(model):
    _raises_alike(lambda: _tpipe(model, num_frames=F, frame_groups=2).plan(),
                  lambda: _jpipe(model, num_frames=F, frame_groups=2).plan())
    _tpipe(model, num_frames=F, cfg_scale=2.0, guidance="fused")   # builds
    tplan = _tpipe(model).plan()
    tconf = _tpipe(model).config
    jplan, jconf = _jpipe(model).plan(), _jpipe(model).config
    for over in (dict(num_frames=3, backend="spmd"),
                 dict(backend="spmd_frames")):
        _raises_alike(
            lambda: tpipe.check_backend_can_run(
                tplan, dataclasses.replace(tconf, **over)),
            lambda: jpipe.check_backend_can_run(
                jplan, dataclasses.replace(jconf, **over)))
    for backend in tpipe.FRAME_BACKENDS:
        if backend != "spmd_frames":
            tpipe.check_backend_can_run(tplan, dataclasses.replace(
                tconf, num_frames=3, backend=backend))


# ----------------------------------------------------------------------
# stadi_video and the frame cost model: ==
# ----------------------------------------------------------------------

def _video_knobs(pkg, **kw):
    defaults = dict(m_base=16, m_warmup=4, planner="stadi_video",
                    num_frames=4, frame_groups=0, kv_row_bytes=4096,
                    latent_bytes=16384, exchange_refresh=2)
    defaults.update(kw)
    cm = defaults.get("cost_model")
    if cm is not None:
        defaults["cost_model"] = pkg[1](**cm)
    return pkg[0].StadiConfig.from_occupancies([0.0, 0.0, 0.5, 0.5],
                                               **defaults)


PKGS = {"port": (tpipe, tsim.CostModel, tplanners),
        "ref": (jpipe, jsim.CostModel, jplanners)}
COMPUTE_BOUND = dict(t_fixed=1e-3, t_row=5e-4, t_ctx=0.0, link_bw=1e6,
                     link_latency=1e-3)
ATTN_BOUND = dict(t_fixed=1e-5, t_row=1e-5, t_ctx=5e-3, link_bw=1e9,
                  link_latency=1e-7)
VIDEO_CASES = {
    "compute_bound": dict(cost_model=COMPUTE_BOUND),
    "attention_bound": dict(cost_model=ATTN_BOUND),
    "pinned_two": dict(frame_groups=2, cost_model=dict(t_fixed=1e-3,
                                                       t_row=5e-4)),
    "pinned_sequential": dict(frame_groups=1),
    "guided": dict(cfg_scale=3.0, cost_model=ATTN_BOUND),
    "guided_fused_pinned": dict(cfg_scale=2.0, guidance="fused",
                                frame_groups=2),
    "three_frames": dict(num_frames=3, cost_model=ATTN_BOUND),
}


@pytest.mark.parametrize("case", sorted(VIDEO_CASES))
def test_stadi_video_plans_match_reference(case):
    plans = {}
    for name, pkg in PKGS.items():
        knobs = _video_knobs(pkg, **VIDEO_CASES[case])
        plans[name] = pkg[2].get_planner("stadi_video")(knobs.speeds, knobs, 8)
    assert _plain(plans["port"]) == _plain(plans["ref"])
    fplan = plans["port"].frames
    if case == "compute_bound" or case == "pinned_sequential":
        assert fplan.groups == (4,)
    if case == "attention_bound":
        assert fplan.n_groups > 1 and list(fplan.groups) == sorted(
            fplan.groups, reverse=True)
        assert plans["port"].speeds == [1.0, 1.0, 0.5, 0.5]
    if case.startswith("guided"):
        assert plans["port"].guidance.mode == "fused"


@pytest.mark.parametrize("over", [dict(frame_groups=8), dict(num_frames=1),
                                  dict(cfg_scale=2.0, guidance="split")])
def test_stadi_video_errors_match_reference(over):
    _raises_alike(*[lambda pkg=pkg: pkg[2].get_planner("stadi_video")(
        [1.0, 1.0, 0.5, 0.5], _video_knobs(pkg, **over), 8)
        for pkg in (PKGS["port"], PKGS["ref"])])


SIM_CASES = [("sequential", (3,), None, "stale_async"),
             ("parallel", (2, 1), None, "stale_async"),
             ("parallel_sync", (2, 1), None, "sync"),
             ("three_rows", (1, 1, 1), None, "predictive"),
             ("guided", (2, 1), 4.0, "stale_async"),
             ("image", (1,), None, "sync")]


@pytest.mark.parametrize("name,groups,scale,exchange", SIM_CASES,
                         ids=[c[0] for c in SIM_CASES])
def test_frame_priced_makespans_match_reference(model, name, groups, scale,
                                                exchange):
    jcfg, tcfg = model[0], model[2]
    tp = TemporalPlan([8, 4], [1, 2], [False, False], 8, 2)
    jp = JTemporalPlan([8, 4], [1, 2], [False, False], 8, 2)
    speeds = [1.0, 0.9, 0.6, 0.5, 0.4, 0.3][:2 * len(groups)]
    cm = dict(t_fixed=1e-5, t_row=2e-5, t_ctx=2e-3)
    tr = tsim.build_trace(tp, [5, 3], tcfg, exchange=exchange,
                          frames=tfr.FramePlan(sum(groups), groups),
                          guidance=(GuidancePlan("fused", scale)
                                    if scale else None))
    jr = jsim.build_trace(jp, [5, 3], jcfg, exchange=exchange,
                          frames=jfr.FramePlan(sum(groups), groups),
                          guidance=(JGuidancePlan("fused", scale)
                                    if scale else None))
    assert _plain(tr.events) == _plain(jr.events)
    got = tsim.simulate_trace(tr, speeds, tsim.CostModel(**cm))
    assert got == jsim.simulate_trace(jr, speeds, jsim.CostModel(**cm))
    assert got > 0


def test_simulate_backend_prices_frames_as_reference(model):
    x4 = np.concatenate([model[4], model[4][:, :1]], axis=1)
    cm = dict(t_fixed=1e-5, t_row=1e-5, t_ctx=2e-3)
    lat = {}
    for name, extra in (("image", {}), ("fseq", dict(num_frames=4)),
                        ("fpar", dict(num_frames=4, planner="stadi_video"))):
        knobs = dict(occupancies=[0.0, 0.0, 0.5, 0.5], backend="simulate",
                     exchange="stale_async", **extra)
        x = x4[:, 0] if name == "image" else x4
        t = _tpipe(model, cost_model=jsim.CostModel(**cm), **knobs).generate(
            torch.from_numpy(x), torch.tensor([1]))
        j = _jpipe(model, cost_model=jsim.CostModel(**cm), **knobs).generate(
            jnp.asarray(x), jnp.asarray([1]))
        assert t.image is None and t.latency_s == j.latency_s > 0
        lat[name] = t.latency_s
    assert lat["fseq"] > lat["image"] and lat["fpar"] < lat["fseq"]


# ----------------------------------------------------------------------
# run_frames: the reference's video, the image path, placement
# ----------------------------------------------------------------------

def _run(model, pkg, x, exchange="stale_async", groups=(F,), scale=None,
         plan=([8, 4], [1, 2]), patches=(5, 3)):
    """One emulated video of either package: (video as numpy, records)."""
    jcfg, jparams, tcfg, tparams = model[:4]
    steps, ratios = plan
    if pkg == "ref":
        res = jfr.run_frames(
            jparams, jcfg, jsam.linear_schedule(T=100), jnp.asarray(x),
            jnp.asarray([1]), JTemporalPlan(steps, ratios, [False, False], 8,
                                            2), list(patches),
            exchange=exchange, frames=jfr.FramePlan(len(x[0]), groups),
            guidance=JGuidancePlan("fused", scale) if scale else None)
        return np.asarray(res.image), res.trace
    res = tfr.run_frames(
        tparams, tcfg, tsam.linear_schedule(100), torch.from_numpy(x),
        torch.tensor([1]), TemporalPlan(steps, ratios, [False, False], 8, 2),
        list(patches), exchange=exchange,
        frames=tfr.FramePlan(len(x[0]), groups),
        guidance=GuidancePlan("fused", scale) if scale else None)
    return res.image.numpy(), res.trace


@pytest.mark.parametrize("exchange", ["sync", "stale_async", "predictive"])
@pytest.mark.parametrize("scale", [None, 4.0], ids=["unguided", "guided"])
def test_run_frames_matches_reference(model, exchange, scale):
    got, ttrace = _run(model, "port", model[4], exchange, scale=scale)
    want, jtrace = _run(model, "ref", model[4], exchange, scale=scale)
    assert _rel(got, want) < REL_BAR
    assert _plain(ttrace.events) == _plain(jtrace.events)
    assert ttrace.frames == tfr.FramePlan(F, (F,))


def test_num_frames_one_is_bitwise_image_path(model):
    x1 = torch.from_numpy(model[4][:, 0])
    ref = _tpipe(model, exchange="stale_async").generate(x1, torch.tensor([1]))
    one = _tpipe(model, exchange="stale_async", num_frames=1).generate(
        x1, torch.tensor([1]))
    assert torch.equal(one.image, ref.image)
    assert one.trace.frames is None
    # a one-frame plan given a [B, 1, H, W, C] latent squeezes and restores
    vid = _run(model, "port", model[4][:, :1], groups=(1,))[0]
    np.testing.assert_array_equal(vid[:, 0], _image(model))


def _image(model, scale=None):
    """The image path of ``_run``'s plan on frame 0's latent."""
    tcfg, tparams = model[2], model[3]
    return tpp.run_schedule(
        tparams, tcfg, tsam.linear_schedule(100),
        torch.from_numpy(model[4][:, 0]), torch.tensor([1]),
        TemporalPlan([8, 4], [1, 2], [False, False], 8, 2), [5, 3],
        exchange="stale_async",
        guidance=GuidancePlan("fused", scale) if scale else None).image.numpy()


@pytest.mark.parametrize("scale", [None, 4.0], ids=["unguided", "guided"])
def test_frame_zero_is_bitwise_image_trajectory(model, scale):
    vid = _run(model, "port", model[4], scale=scale)[0]
    np.testing.assert_array_equal(vid[:, 0], _image(model, scale))


def test_video_is_placement_invariant(model):
    videos = {g: _run(model, "port", model[4], groups=g, plan=([8, 8], [1, 1]),
                      patches=(4, 4))
              for g in [(3,), (2, 1), (1, 1, 1)]}
    for g, (vid, trace) in videos.items():
        assert trace.frames.groups == g
        np.testing.assert_array_equal(vid, videos[(3,)][0])


# ----------------------------------------------------------------------
# the bar has teeth: the cross-frame effect and planted faults
# ----------------------------------------------------------------------

def _no_prev_half(own, prev, tok_axis=2):
    """Planted fault: frame f > 0 reads its own frame's context only."""
    return own


def _prev_first(own, prev, tok_axis=2):
    """Planted fault: the context in the order prev ⊕ own, so the fresh
    rows overwrite the previous frame's half."""
    return (torch.cat([prev[0], own[0]], dim=tok_axis),
            torch.cat([prev[1], own[1]], dim=tok_axis))


def _no_frame_embedding(frame_eval):
    """Planted fault: frames f > 0 are conditioned like the image."""
    def call(params, cfg, x, t, cond, row_start, frame, **kw):
        return frame_eval(params, cfg, x, t, cond, row_start, None, **kw)
    return call


FRAME_FAULTS = {"no_prev_half": ("ctx", lambda _: _no_prev_half),
                "prev_first": ("ctx", lambda _: _prev_first),
                "no_frame_embedding": ("frame_eval", _no_frame_embedding)}


def _readings(model):
    """(the port's error against the reference, the distance of the video
    with every frame run alone, each planted fault's distance), relative."""
    want = _run(model, "ref", model[4])[0]
    out = {"port": _rel(_run(model, "port", model[4])[0], want)}
    alone = np.concatenate([_run(model, "port", model[4][:, f:f + 1],
                                 groups=(1,))[0] for f in range(F)], axis=1)
    out["frames_alone"] = _rel(alone, want)
    for name, (attr, make) in FRAME_FAULTS.items():
        orig = getattr(tfr, attr)
        setattr(tfr, attr, make(orig))
        try:
            out[name] = _rel(_run(model, "port", model[4])[0], want)
        finally:
            setattr(tfr, attr, orig)
    return out


def test_bar_rejects_the_frames_alone_and_planted_faults(model):
    r = _readings(model)
    print({k: f"{v:.3e}" for k, v in r.items()})
    assert r["port"] < REL_BAR
    assert r["frames_alone"] > 100 * REL_BAR, r
    for name in FRAME_FAULTS:
        assert r[name] > 10 * REL_BAR, (name, r)


if __name__ == "__main__":
    torch.set_num_threads(1)
    for k, v in _readings(_build_model()).items():
        print(f"{k}: {v:.3e}")
