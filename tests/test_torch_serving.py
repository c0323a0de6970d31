"""The port's diffusion serving engine (emulated lanes) on the CPU, against
the JAX package's engine and against the port's own ``generate``.

Mirrors tests/test_serving_diffusion.py's emulated tests and
tests/test_guidance.py's serving tests: FIFO admission and refill, step
isolation under staggered admissions, the m_warmup = 0 bootstrap,
``generate_many``, deterministic speed-ordered placement, SLO accounting, an
8-request drain, the degraded exchange kinds, mixed CFG / non-CFG lanes,
split guidance, the default scale and guards, drift replanning and
seq-sharded lanes. Each served image is held to the port's lone
``generate`` at atol 1e-5 (a lane group is one batched forward, so not
bitwise). The port's engine is held to the reference's on the same
submissions: images within atol 1e-5; per-round admissions, warm-up and
adaptive lanes, exchange kinds and placements, the replans and the SLO
verdicts ``==``; modeled seconds ``==`` (the cost arithmetic is the same
Python float arithmetic in both). Kernel K3's per-lane plain version is held
to the reference's Pallas kernel per lane under ``jax.vmap`` (interpret
mode). Sizes are ``tiny-dit.reduced()`` in fp32 with T = 100."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import hetero as jhetero  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core.simulate import CostModel as JCostModel  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro.serving import DiffusionServingEngine as JEngine  # noqa: E402
from repro.serving import plan_cache as jpc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import hetero as thetero  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core.simulate import CostModel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import DiffusionServingEngine  # noqa: E402
from repro_torch.serving import plan_cache as tpc  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module's tiny shapes: the suite runs in
    several worker processes at once, and torch's thread pools spinning
    against each other cost far more than these products gain."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("tiny-dit").reduced()        # 16x16 latent, 8 rows
    jparams = jdit.nondegenerate_params(jdit.init_params(jax.random.PRNGKey(0),
                                                         jcfg))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)), tparams


def _config(speeds, pkg=tpipe, hetero=thetero, **kw):
    cluster = tuple(hetero.DeviceProfile(f"dev{i}", c=v)
                    for i, v in enumerate(speeds))
    kw = {"m_base": 8, "m_warmup": 2, **kw}
    return pkg.StadiConfig(cluster=cluster, **kw)


def _pipe(setup, speeds=(1.0, 0.5), **kw):
    _, _, tcfg, tparams = setup
    return tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                               _config(list(speeds), **kw), device="cpu")


def _jax_pipe(setup, speeds=(1.0, 0.5), **kw):
    jcfg, jparams, _, _ = setup
    if kw.get("cost_model") is not None:
        kw["cost_model"] = JCostModel(**dataclasses.asdict(kw["cost_model"]))
    return jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                               _config(list(speeds), jpipe, jhetero, **kw))


def _xs(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, cfg.latent_size, cfg.latent_size,
                                 cfg.channels)).astype(np.float32)
            for _ in range(n)]


def _generate(pipe, x, cond, scale=None):
    """The port's lone generate of one request (guided at ``scale``)."""
    if scale is not None and pipe.config.cfg_scale != scale:
        pipe = tpipe.StadiPipeline(pipe.model_cfg, pipe.params, pipe.sched,
                                   dataclasses.replace(pipe.config,
                                                       cfg_scale=scale),
                                   device="cpu")
    return pipe.generate(torch.from_numpy(x), torch.tensor([cond])).image


def _assert_matches_generate(pipe, subs):
    for req, x, cond, scale in subs:
        want = _generate(pipe, x, cond, scale)
        torch.testing.assert_close(req.image, want, rtol=0, atol=ATOL)


# ----------------------------------------------------------------------
# the port's engine against the reference's, on the same submissions
# ----------------------------------------------------------------------

def _drain_both(setup, *, speeds=(1.0, 0.5), n=5, slots=3, scales=None,
                stagger=2, engine_kw=None, **knobs):
    """Submit ``n`` requests to both packages' engines (``stagger`` rounds
    after the first two, when set) and drain them."""
    jcfg = setup[0]
    engine_kw = engine_kw or {}
    je = JEngine(_jax_pipe(setup, speeds, **knobs), slots=slots, **engine_kw)
    te = DiffusionServingEngine(_pipe(setup, speeds, **knobs), slots=slots,
                                **engine_kw)
    xs = _xs(jcfg, n, seed=11)
    scales = scales or [None] * n
    pairs = []
    for i in range(n):
        if stagger and i == 2:
            for _ in range(stagger):
                je.step()
                te.step()
        kw = dict(cfg_scale=scales[i], slo_s=0.05 * (i + 1))
        pairs.append((je.submit(jnp.asarray(xs[i]), i % jcfg.n_classes, **kw),
                      te.submit(torch.from_numpy(xs[i]), i % jcfg.n_classes,
                                **kw)))
    je.run_to_completion()
    te.run_to_completion()
    return je, te, pairs, xs


def _assert_engines_match(je, te, pairs):
    for jr, tr in pairs:
        np.testing.assert_allclose(tr.image.numpy(), np.asarray(jr.image),
                                   rtol=0, atol=ATOL)
        assert (tr.uid, tr.admit_round, tr.finish_round, tr.slo_met) == \
            (jr.uid, jr.admit_round, jr.finish_round, jr.slo_met)
        assert tr.modeled_latency_s == jr.modeled_latency_s
    assert len(te.rounds) == len(je.rounds)
    for jr, tr in zip(je.rounds, te.rounds):
        fields = ("admitted", "warmup_lanes", "adaptive_lanes",
                  "exchange_kinds", "placement", "modeled_s")
        assert [getattr(tr, f) for f in fields] == \
            [getattr(jr, f) for f in fields], tr.index
    # the reference's info also carries the stage chain's refill flag
    # (always False with one stage)
    assert te._interval_info == {f: (r, k, h) for f, (r, k, fill, h)
                                 in je._interval_info.items() if not fill}
    assert len(te._interval_info) == len(je._interval_info)
    assert [(e.fine_step, e.drift, e.speeds_before, e.speeds_after,
             tpc.plan_to_dict(e.plan)) for e in te.replans] == \
        [(e.fine_step, e.drift, e.speeds_before, e.speeds_after,
          jpc.plan_to_dict(e.plan)) for e in je.replans]
    ts, js = te.stats(), je.stats()
    for key in ("n_completed", "rounds", "replans", "modeled_makespan_s",
                "throughput_modeled_rps", "latency_mean_s", "latency_p95_s",
                "slo_met_frac"):
        assert ts[key] == js[key], key


SCENARIOS = {
    "unguided_sync": dict(),
    "mixed_cfg_sync": dict(scales=[2.5, None, 2.5, None, 2.5]),
    "mixed_cfg_stale_async": dict(scales=[2.5, None, 2.5, None, 2.5],
                                  exchange="stale_async"),
    "mixed_cfg_predictive": dict(scales=[2.5, None, 2.5, None, 2.5],
                                 exchange="predictive"),
    "mixed_scales": dict(scales=[3.0, 5.0, None, 3.0, 5.0], n=5, slots=4),
    "split": dict(speeds=(1.0, 1.0, 0.5, 0.5), planner="stadi_guidance",
                  cfg_scale=2.0, guidance="split", exchange="predictive",
                  n=4),
    "seq_sharded": dict(speeds=(1.0, 0.8, 0.6, 0.5), seq_shards=2,
                        exchange="ring", n=3, slots=2),
    "replanning": dict(speeds=(1.0, 1.0, 0.5, 0.5), planner="stadi_guidance",
                       cfg_scale=2.0, guidance="split", m_base=16, n=6,
                       slots=4, stagger=0,
                       cost_model=CostModel(t_fixed=5e-3, t_row=5.5e-4,
                                            link_bw=1.25e9,
                                            link_latency=50e-6),
                       engine_kw=dict(rebalance_every=1,
                                      measured_speeds=[1.0, 0.1, 0.5, 0.5])),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_the_reference_engine(setup, name):
    je, te, pairs, _ = _drain_both(setup, **SCENARIOS[name])
    _assert_engines_match(je, te, pairs)
    if name == "replanning":
        assert te.replans
    if name == "seq_sharded":
        assert te.seq is not None and te.seq.n_shards == 2
        assert any(info[2] == 1 for info in te._interval_info.values())


def test_generate_many_matches_the_reference(setup):
    jcfg = setup[0]
    xs = _xs(jcfg, 3, seed=50)
    cm = CostModel(t_fixed=1e-3, t_row=1e-3)
    jres = _jax_pipe(setup, cost_model=cm, cfg_scale=2.0).generate_many(
        [jnp.asarray(x) for x in xs], [jnp.asarray([i]) for i in range(3)],
        slots=2)
    tres = _pipe(setup, cost_model=cm, cfg_scale=2.0).generate_many(
        [torch.from_numpy(x) for x in xs], [torch.tensor([i]) for i in range(3)],
        slots=2)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t.image.numpy(), np.asarray(j.image),
                                   rtol=0, atol=ATOL)
        assert t.latency_s == j.latency_s
        assert t.plan.patches == j.plan.patches
        assert [dataclasses.asdict(e) for e in t.trace.events] == \
            [dataclasses.asdict(e) for e in j.trace.events]


# ----------------------------------------------------------------------
# registry / validation (tests/test_serving_diffusion.py)
# ----------------------------------------------------------------------

def test_stepper_registry_and_validation(setup):
    assert tpipe.get_stepper_factory("emulated") is not None
    with pytest.raises(NotImplementedError, match="item 9b"):
        tpipe.get_stepper_factory("spmd")
    with pytest.raises(NotImplementedError, match="item 10"):
        tpipe.get_stepper_factory("pipefuse")
    with pytest.raises(KeyError):
        tpipe.get_stepper_factory("simulate")     # no numerics to serve
    with pytest.raises(ValueError):
        DiffusionServingEngine(_pipe(setup, rebalance_every=1))
    with pytest.raises(ValueError):
        DiffusionServingEngine(_pipe(setup), slots=0)
    with pytest.raises(NotImplementedError, match="item 9b"):
        DiffusionServingEngine(_pipe(setup, backend="spmd"))
    cfg = setup[2]
    engine = DiffusionServingEngine(_pipe(setup), slots=2)
    with pytest.raises(ValueError):               # one request = one image
        engine.submit(torch.zeros(2, cfg.latent_size, cfg.latent_size,
                                  cfg.channels), 0)
    with pytest.raises(ValueError, match="item 13"):
        engine.submit(torch.zeros(cfg.latent_size, cfg.latent_size,
                                  cfg.channels), torch.zeros(1, 4, 65))


def test_admission_fifo_and_refill(setup):
    cfg = setup[2]
    engine = DiffusionServingEngine(_pipe(setup, m_base=6), slots=2)
    reqs = [engine.submit(torch.from_numpy(x), i)
            for i, x in enumerate(_xs(cfg, 5))]
    engine.run_to_completion()
    assert len(engine.completed) == 5
    assert engine.rounds[0].admitted == [(0, 0), (1, 1)]
    waves = [r.admitted for r in engine.rounds if r.admitted]
    assert waves == [[(0, 0), (1, 1)], [(2, 0), (3, 1)], [(4, 0)]]
    assert 0 < reqs[2].queue_rounds < reqs[4].queue_rounds


def test_staggered_requests_match_generate(setup):
    """Requests admitted mid-flight share batched dispatches with requests
    several noise-schedule steps ahead; each still matches its lone
    generate."""
    cfg = setup[2]
    pipe = _pipe(setup, m_base=6)
    engine = DiffusionServingEngine(pipe, slots=3)
    xs = _xs(cfg, 5, seed=3)
    subs = []
    for i, x in enumerate(xs):
        if i == 2:
            engine.step()
            engine.step()        # wave 1 is past warm-up now
        subs.append((engine.submit(torch.from_numpy(x), i), x, i, None))
    engine.run_to_completion()
    assert any(r.warmup_lanes and r.adaptive_lanes for r in engine.rounds)
    assert all(r.fine_step == 6 for r in engine.completed)
    _assert_matches_generate(pipe, subs)


def test_no_warmup_bootstrap(setup):
    """m_warmup == 0: admission bootstraps the stale-K/V buffers with one
    full forward (run_schedule's M_w == 0 path), guided lanes too."""
    cfg = setup[2]
    pipe = _pipe(setup, m_base=4, m_warmup=0)
    engine = DiffusionServingEngine(pipe, slots=2)
    subs = [(engine.submit(torch.from_numpy(x), i, cfg_scale=s), x, i, s)
            for i, (x, s) in enumerate(zip(_xs(cfg, 3, seed=30),
                                           (None, 3.0, None)))]
    engine.run_to_completion()
    assert engine.stats()["dispatches"]["bootstrap"] == 3
    _assert_matches_generate(pipe, subs)


def test_generate_many_matches_generate(setup):
    cfg = setup[2]
    pipe = _pipe(setup)
    xs = _xs(cfg, 3, seed=50)
    results = pipe.generate_many([torch.from_numpy(x) for x in xs],
                                 [torch.tensor([i]) for i in range(3)], slots=2)
    assert len(results) == 3
    for i, (x, res) in enumerate(zip(xs, results)):
        ref = pipe.generate(torch.from_numpy(x), torch.tensor([i]))
        torch.testing.assert_close(res.image, ref.image, rtol=0, atol=ATOL)
        assert res.plan.patches == ref.plan.patches
        assert res.latency_s is None          # no cost model configured
    results = _pipe(setup, cost_model=CostModel(t_fixed=1e-3, t_row=1e-3)
                    ).generate_many([torch.from_numpy(x) for x in xs],
                                    [torch.tensor([i]) for i in range(3)],
                                    slots=2)
    assert all(r.latency_s is not None and r.latency_s > 0 for r in results)


def test_placement_deterministic_and_speed_ordered(setup):
    cfg = setup[2]

    def drain():
        engine = DiffusionServingEngine(_pipe(setup), slots=3)
        for i, x in enumerate(_xs(cfg, 4)):
            engine.submit(torch.from_numpy(x), i)
        engine.run_to_completion()
        return engine

    a, b = drain(), drain()
    pa = [r.placement for r in a.rounds]
    assert pa == [r.placement for r in b.rounds]
    assert any(p is not None for p in pa)
    patches = a.plan.patches
    placement = next(p for p in pa if p is not None)
    w_big = max(range(len(patches)), key=lambda i: patches[i])
    assert dict(placement)[w_big] == 0
    assert a.modeled_clock_s == b.modeled_clock_s


def test_slo_accounting(setup):
    cfg = setup[2]
    xs = _xs(cfg, 2)
    engine = DiffusionServingEngine(_pipe(setup), slots=2)
    tight = engine.submit(torch.from_numpy(xs[0]), 0, slo_s=1e-9)
    loose = engine.submit(torch.from_numpy(xs[1]), 1, slo_s=1e9)
    engine.run_to_completion()
    assert tight.slo_met is False and loose.slo_met is True
    assert engine.stats()["slo_met_frac"] == 0.5
    engine2 = DiffusionServingEngine(_pipe(setup), slots=2)
    req = engine2.submit(torch.from_numpy(xs[0]), 0)
    engine2.run_to_completion()
    assert req.slo_met is None and engine2.stats()["slo_met_frac"] is None


def test_e2e_8_request_drain(setup):
    cfg = setup[2]
    engine = DiffusionServingEngine(_pipe(setup, m_base=6), slots=3)
    reqs = [engine.submit(torch.from_numpy(x), i)
            for i, x in enumerate(_xs(cfg, 8, seed=80))]
    done = engine.run_to_completion()
    assert len(done) == len(engine.completed) == 8
    assert {r.uid for r in done} == set(range(8))
    for r in reqs:
        assert r.done and r.fine_step == 6
        assert bool(torch.isfinite(r.image).all())
        assert r.image.shape == (1, cfg.latent_size, cfg.latent_size,
                                 cfg.channels)
        assert r.modeled_latency_s > 0 and r.wall_latency_s > 0
    assert reqs[7].modeled_latency_s > reqs[0].modeled_latency_s
    stats = engine.stats()
    assert stats["n_completed"] == 8
    assert stats["throughput_modeled_rps"] > 0 and stats["throughput_wall_rps"] > 0
    assert stats["latency_p95_s"] >= stats["latency_mean_s"] > 0
    assert [r["uid"] for r in stats["requests"]] == list(range(8))
    assert stats["kernels"] == {}             # the CPU runs plain versions


def test_preempt_restarts_from_x_T(setup):
    """An evicted request goes back to the queue head, restarts from x_T on
    readmission and still matches its lone generate."""
    cfg = setup[2]
    pipe = _pipe(setup)
    engine = DiffusionServingEngine(pipe, slots=2)
    xs = _xs(cfg, 3, seed=9)
    subs = [(engine.submit(torch.from_numpy(x), i, cfg_scale=s), x, i, s)
            for i, (x, s) in enumerate(zip(xs, (2.0, None, None)))]
    engine.step()
    engine.step()
    assert engine.preempt(subs[0][0].uid) and not engine.preempt(99)
    assert engine.queue[0] is subs[0][0]
    engine.run_to_completion()
    assert subs[0][0].preempt_count == 1 and engine.stats()["preemptions"] == 1
    _assert_matches_generate(pipe, subs)


# ----------------------------------------------------------------------
# boundary-exchange policies in the serving hot path
# ----------------------------------------------------------------------

@pytest.mark.parametrize("exchange", ["stale_async", "predictive"])
def test_serving_degraded_modes_vs_generate(setup, exchange):
    cfg = setup[2]
    pipe = _pipe(setup, exchange=exchange, exchange_refresh=2)
    engine = DiffusionServingEngine(pipe, slots=2)          # forces stagger
    subs = [(engine.submit(torch.from_numpy(x), i), x, i, None)
            for i, x in enumerate(_xs(cfg, 3))]
    engine.run_to_completion()
    _assert_matches_generate(pipe, subs)
    kinds = [k for r in engine.rounds for k in r.exchange_kinds]
    assert set(kinds) >= {"full"}
    assert ("skip" in kinds) if exchange == "stale_async" \
        else ("predict" in kinds)


def test_serving_stale_async_models_cheaper_rounds(setup):
    cfg = setup[2]
    cm = CostModel(t_fixed=1e-3, t_row=1e-4, link_bw=1e6, link_latency=1e-4)
    makespans = {}
    for ex in ("sync", "stale_async"):
        engine = DiffusionServingEngine(
            _pipe(setup, exchange=ex, exchange_refresh=2, cost_model=cm),
            slots=2)
        for i, x in enumerate(_xs(cfg, 4)):
            engine.submit(torch.from_numpy(x), i)
        engine.run_to_completion()
        makespans[ex] = engine.modeled_clock_s
    assert makespans["stale_async"] < makespans["sync"]


# ----------------------------------------------------------------------
# guided lanes (tests/test_guidance.py's serving tests)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("exchange", ["sync", "stale_async", "predictive"])
def test_serving_mixed_cfg_vs_generate(setup, exchange):
    """A mixed batch of CFG and non-CFG requests, at two scales, drains with
    every request matching its lone generate; every guided dispatch is one
    combine over its whole lane group."""
    cfg = setup[2]
    pipe = _pipe(setup, exchange=exchange)
    engine = DiffusionServingEngine(pipe, slots=3)
    scales = [2.5, None, 4.0, None, 2.5]
    subs = [(engine.submit(torch.from_numpy(x), i % cfg.n_classes,
                           cfg_scale=s), x, i % cfg.n_classes, s)
            for i, (x, s) in enumerate(zip(_xs(cfg, 5, seed=20), scales))]
    engine.run_to_completion()
    _assert_matches_generate(pipe, subs)
    assert engine.stats()["dispatches"]["guided"] > 0


def test_serving_default_scale_and_guards(setup):
    config_scale = _pipe(setup, cfg_scale=2.0)
    engine = DiffusionServingEngine(config_scale, slots=2)
    req = engine.submit(torch.from_numpy(_xs(setup[2], 1)[0]), 1)
    assert req.guided and req.cfg_scale == 2.0
    split = DiffusionServingEngine(_pipe(setup, (1.0, 1.0, 0.5, 0.5),
                                         planner="stadi_guidance",
                                         cfg_scale=2.0, guidance="split"),
                                   slots=2)
    assert split.plan.guidance.mode == "split"
    assert split._guide_pairs is not None
    with pytest.raises(ValueError, match="interleaved"):
        DiffusionServingEngine(_pipe(setup, (1.0, 1.0, 0.5, 0.5),
                                     planner="stadi_guidance", cfg_scale=2.0,
                                     guidance="interleaved"), slots=2)


@pytest.mark.parametrize("exchange", ["sync", "stale_async", "predictive"])
def test_serving_split_guidance_vs_generate(setup, exchange):
    """Split guidance repartitions WHERE the branches run, never WHAT is
    computed: each request matches its lone split-guided generate."""
    cfg = setup[2]
    pipe = _pipe(setup, (1.0, 1.0, 0.5, 0.5), planner="stadi_guidance",
                 cfg_scale=2.0, guidance="split", exchange=exchange)
    engine = DiffusionServingEngine(pipe, slots=3)
    subs = [(engine.submit(torch.from_numpy(x), i), x, i, None)
            for i, x in enumerate(_xs(cfg, 4, seed=50))]
    engine.run_to_completion()
    _assert_matches_generate(pipe, subs)


def test_serving_guidance_aware_replanning_improves_throughput(setup):
    """After an injected speed drift on the comm-bound 2-tier profile,
    engine replanning (re-pairing the cond/uncond groups) improves modeled
    drain throughput by >= 15% over the frozen plan."""
    cm = CostModel(t_fixed=5e-3, t_row=5.5e-4, link_bw=1.25e9,
                   link_latency=50e-6)
    pipe = _pipe(setup, (1.0, 1.0, 0.5, 0.5), m_base=16,
                 planner="stadi_guidance", cfg_scale=2.0, guidance="split",
                 cost_model=cm)
    measured = [1.0, 0.1, 0.5, 0.5]
    xs = _xs(setup[2], 6, seed=70)

    def drain(**kw):
        engine = DiffusionServingEngine(pipe, slots=4,
                                        measured_speeds=measured, **kw)
        for i, x in enumerate(xs):
            engine.submit(torch.from_numpy(x), i)
        engine.run_to_completion()
        return engine

    frozen, live = drain(), drain(rebalance_every=1)
    assert frozen.stats()["replans"] == 0 and live.stats()["replans"] >= 1
    pairings = {(ev.plan.guidance.cond_devices, ev.plan.guidance.uncond_devices)
                for ev in live.replans}
    assert pairings - {(frozen.plan.guidance.cond_devices,
                        frozen.plan.guidance.uncond_devices)}
    assert live.stats()["throughput_modeled_rps"] >= \
        1.15 * frozen.stats()["throughput_modeled_rps"]


def test_generate_many_guided_matches_generate(setup):
    pipe = _pipe(setup, cfg_scale=2.0)
    xs = _xs(setup[2], 3, seed=30)
    results = pipe.generate_many([torch.from_numpy(x) for x in xs],
                                 [torch.tensor([i]) for i in range(3)], slots=2)
    for i, (x, res) in enumerate(zip(xs, results)):
        ref = pipe.generate(torch.from_numpy(x), torch.tensor([i])).image
        torch.testing.assert_close(res.image, ref, rtol=0, atol=ATOL)


def test_serving_seq_sharded_lanes_vs_generate(setup):
    pipe = _pipe(setup, (1.0, 0.8, 0.6, 0.5), seq_shards=2, exchange="ring")
    engine = DiffusionServingEngine(pipe, slots=2)
    assert engine.seq is not None and engine.seq.n_shards == 2
    x = _xs(setup[2], 1, seed=4)[0]
    req = engine.submit(torch.from_numpy(x), 1)
    engine.run_to_completion()
    _assert_matches_generate(pipe, [(req, x, 1, None)])
    assert any(info[2] == 1 for info in engine._interval_info.values())


# ----------------------------------------------------------------------
# kernel K3's per-lane plain version against the reference's kernel
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 16, 16, 3), (4, 72, 128, 4),
                                   (2, 5, 7), (1, 9)])
def test_k3_per_lane_plain_version_matches_reference_kernel(shape):
    """One call over the lane group against the reference's Pallas kernel
    under ``jax.vmap`` over the lanes (interpret mode), and against the
    port's own scalar-scale calls lane by lane.

    The delta is bitwise the reference's. The combine is bitwise the port's
    lane-by-lane calls, and off the reference's by at most the rounding of
    ``w * d``: XLA on the CPU fuses the interpret-mode kernel's
    ``eu + w * d`` into one fused multiply-add (rounded once, as the
    float64 form below shows), while the port rounds the product and the
    sum, as PyTorch's eager ops and the CUDA kernel do."""
    rng = np.random.default_rng(18)
    ec, eu = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    sc = np.array([2.5, 4.0, 7.5, 1.0][:shape[0]], np.float32)
    comb, delta = ops.cfg_epilogue(torch.from_numpy(ec), torch.from_numpy(eu),
                                   torch.from_numpy(sc))
    jcomb = np.asarray(jax.vmap(
        lambda c, u, s: jops.cfg_epilogue(c, u, s, with_delta=False))(
            jnp.asarray(ec), jnp.asarray(eu), jnp.asarray(sc)))
    jdelta = np.asarray(jax.vmap(lambda c, u, s: jops.cfg_epilogue(c, u, s)[1])(
        jnp.asarray(ec), jnp.asarray(eu), jnp.asarray(sc)))
    assert torch.equal(delta, torch.from_numpy(jdelta.copy()))
    bshape = (-1,) + (1,) * (len(shape) - 1)
    fma = (eu.astype(np.float64) + sc.reshape(bshape).astype(np.float64)
           * (ec - eu).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(jcomb, fma)
    # the port rounds w * d before the sum: off the fused form by at most
    # that rounding plus the sum's own
    wd = np.abs(sc.reshape(bshape) * (ec - eu))
    bound = np.spacing(wd) + np.spacing(np.maximum(np.abs(jcomb),
                                                   np.abs(comb.numpy())))
    assert (np.abs(comb.numpy() - jcomb) <= bound).all()
    lanes = torch.stack([ops.cfg_epilogue(torch.from_numpy(ec[g]),
                                          torch.from_numpy(eu[g]), float(sc[g]),
                                          with_delta=False)
                         for g in range(shape[0])])
    assert torch.equal(comb, lanes)
    # the planted fault: lane 0's scale for every lane is rejected
    fault = ops.cfg_epilogue(torch.from_numpy(ec), torch.from_numpy(eu),
                             float(sc[0]), with_delta=False)
    assert shape[0] == 1 or not torch.equal(fault, comb)
