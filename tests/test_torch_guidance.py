"""Classifier-free guidance in the port against the JAX package, on the CPU:
the planning layer (``guidance_groups``, ``split_plan``, the
``stadi_guidance`` planner, guided traces and simulated latencies: ``==``),
the sampler's CFG combiners (fp32 allclose, delta bitwise), kernel K3's plain
version against the reference's Pallas kernel in interpret mode (the bar of
tests/test_kernels.py: combine rtol 1e-5 / atol 1e-6, delta bitwise), the
guided forwards (fp32 atol 1e-5), guided ``generate`` under every placement
(trace records ``==``, image relative error < 1e-3), the port's own
split == fused bitwise contract, and the branch-stacked buffer merge.
Sizes are ``tiny-dit.reduced()`` in fp32 with T = 100."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import buffers as jbuf  # noqa: E402
from repro.core import guidance as jguide  # noqa: E402
from repro.core import patch_parallel as jpp  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core.schedule import TemporalPlan as JTemporalPlan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import buffers as tbuf  # noqa: E402
from repro_torch.core import guidance as tguide  # noqa: E402
from repro_torch.core import patch_parallel as tpp  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.schedule import TemporalPlan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.diffusion import dit as tdit  # noqa: E402

REL_BAR = 1e-3
FWD_BAR = dict(rtol=0.0, atol=1e-5)
K3_BAR = dict(rtol=1e-5, atol=1e-6)
SPEEDS = [[1.0, 0.5], [1.0, 1.0, 0.5, 0.5], [1.0, 0.5, 0.9, 0.4],
          [2.0, 1.0, 1.0], [0.3] * 5, [4.0, 0.1, 0.1, 0.1],
          [1.0 - 0.04 * i for i in range(17)]]          # 17: the greedy branch


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("tiny-dit").reduced()      # 16x16 latent, 8 token rows
    jparams = jdit.nondegenerate_params(jdit.init_params(jax.random.PRNGKey(0),
                                                         jcfg))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                     device="cpu")
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    cond = np.array([1, 2])
    return (jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)), tparams,
            x_T, cond)


def _plain(x):
    """Dataclasses of either package -> (class name, field dict)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _records(trace):
    return [dataclasses.asdict(e) for e in trace.events]


# ----------------------------------------------------------------------
# planning layer: ==
# ----------------------------------------------------------------------

@pytest.mark.parametrize("speeds", SPEEDS)
def test_guidance_groups_and_split_plan_equal(speeds):
    assert tguide.guidance_groups(speeds) == jguide.guidance_groups(speeds)
    for mode in ("split", "interleaved"):
        for refresh in (1, 3):
            assert _plain(tguide.split_plan(speeds, mode, 2.5, refresh)) == \
                _plain(jguide.split_plan(speeds, mode, 2.5, refresh))


def test_guidance_plan_validation_and_cadence_equal():
    for args in (("fused", 0.0), ("both", 1.0), ("split", 2.0, (0, 1), (1, 2)),
                 ("split", 2.0, (0, 1), (2,)), ("fused", 2.0, (0,), (1,)),
                 ("split", 2.0), ("fused", 2.0, (), (), 0)):
        with pytest.raises(ValueError):
            jguide.GuidancePlan(*args)
        with pytest.raises(ValueError):
            tguide.GuidancePlan(*args)
    with pytest.raises(ValueError):
        tguide.guidance_groups([1.0])
    tp = tguide.GuidancePlan("interleaved", 2.0, (0, 2), (1, 3), 3, (1,))
    jp = jguide.GuidancePlan("interleaved", 2.0, (0, 2), (1, 3), 3, (1,))
    assert [tp.uncond_fresh(i) for i in range(7)] == \
        [jp.uncond_fresh(i) for i in range(7)]
    assert [tp.worker_reuses(i) for i in range(2)] == [False, True]
    assert tp.pair_speeds([1.0, 0.7, 0.5, 0.6]) == \
        jp.pair_speeds([1.0, 0.7, 0.5, 0.6])
    assert tguide.NULL_COND == jguide.NULL_COND == tdit.NULL_COND


def _pipes(occ, *, cost=None, model="sdxl-dit", **knobs):
    """The same config on both packages' pipelines (model config only: the
    planner and simulate backend need no weights)."""
    jcfg = jax_get_config(model)
    tcfg = get_config(model)
    jcm = jsim.CostModel(**cost) if cost else None
    tcm = tsim.CostModel(**cost) if cost else None
    jp = jpipe.StadiPipeline(jcfg, None, None, jpipe.StadiConfig.from_occupancies(
        occ, cost_model=jcm, **knobs))
    tp = tpipe.StadiPipeline(tcfg, {}, tsam.linear_schedule(100),
                             tpipe.StadiConfig.from_occupancies(
                                 occ, cost_model=tcm, **knobs), device="cpu")
    return jp, tp


COMM_BOUND = dict(t_fixed=5e-3, t_row=5.5e-4, link_bw=1.25e9, link_latency=50e-6)


@pytest.mark.parametrize("mode", ["none", "fused", "split", "interleaved"])
@pytest.mark.parametrize("occ,cost", [
    ([0.0, 0.0, 0.5, 0.5], None),
    ([0.0, 0.0, 0.5, 0.5], COMM_BOUND),
    ([0.0, 0.3, 0.5, 0.6, 0.1], COMM_BOUND),
])
def test_stadi_guidance_plans_equal(mode, occ, cost):
    """Plans, modeled_interval_cost included, through ``plan()`` (which
    fills in the byte provenance) and the bare planner call."""
    jp, tp = _pipes(occ, cost=cost, planner="stadi_guidance", guidance=mode,
                    cfg_scale=5.0, m_base=16, m_warmup=4, granularity=2,
                    uncond_refresh=3)
    jplan, tplan = jp.plan(), tp.plan()
    assert _plain(tplan) == _plain(jplan)
    assert tplan.modeled_interval_cost is not None
    if mode == "interleaved":
        assert tplan.guidance.reuse_workers is not None
    from repro.core import planners as jplanners
    from repro_torch.core import planners as tplanners
    assert _plain(tplanners.get_planner("stadi_guidance")(
        tp.config.speeds, tp.config, 32)) == _plain(
        jplanners.get_planner("stadi_guidance")(jp.config.speeds, jp.config, 32))


def test_auto_guidance_picks_split_when_comm_bound():
    """tests/test_guidance.py::test_stadi_guidance_auto_picks_split_when_comm_bound
    on the port: fused serializes both branches' K/V on one fabric."""
    _, tp = _pipes([0.0, 0.0, 0.5, 0.5], cost=COMM_BOUND,
                   planner="stadi_guidance", cfg_scale=5.0, granularity=2)
    assert tp.plan().guidance.mode == "split"
    with pytest.raises(ValueError, match="cfg_scale"):
        from repro_torch.core.planners import get_planner
        get_planner("stadi_guidance")(
            [1.0, 0.5], dataclasses.replace(tp.config, cfg_scale=0.0), 8)


@pytest.mark.parametrize("mode", ["fused", "split", "interleaved"])
@pytest.mark.parametrize("exchange", ["sync", "stale_async", "predictive"])
def test_guided_traces_and_latency_equal(mode, exchange):
    planner = "stadi" if mode == "fused" else "stadi_guidance"
    kw = dict(planner=planner, cfg_scale=4.0, m_base=32, m_warmup=4,
              exchange=exchange, backend="simulate",
              guidance="none" if mode == "fused" else mode)
    jp, tp = _pipes([0.0, 0.0, 0.5, 0.5], cost=COMM_BOUND, **kw)
    jres, tres = jp.generate(), tp.generate()
    assert tres.trace.guidance.mode == mode
    assert _records(tres.trace) == _records(jres.trace)
    assert _plain(tres.trace.guidance) == _plain(jres.trace.guidance)
    assert tres.latency_s == jres.latency_s
    fresh = [e.uncond_fresh for e in tres.trace.events if not e.synchronous]
    assert all(fresh) == (mode != "interleaved")


def test_build_trace_guidance_provenance():
    """tests/test_guidance.py::test_build_trace_guidance_provenance."""
    cfg = get_config("tiny-dit").reduced()
    gp = tguide.GuidancePlan("interleaved", 2.0, (0, 1), (2, 3))
    trace = tsim.build_trace(TemporalPlan([8, 6], [1, 2], [False, False], 8, 2),
                             [5, 3], cfg, guidance=gp)
    jtrace = jsim.build_trace(JTemporalPlan([8, 6], [1, 2], [False, False], 8, 2),
                              [5, 3], jax_get_config("tiny-dit").reduced(),
                              guidance=jguide.GuidancePlan("interleaved", 2.0,
                                                           (0, 1), (2, 3)))
    assert trace.guidance is gp
    assert [e.uncond_fresh for e in trace.events if not e.synchronous] == \
        [True, False, True]
    assert _records(trace) == _records(jtrace)


# ----------------------------------------------------------------------
# sampler and kernel K3's plain version
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.0, 1.0, 4.0, 7.5])
def test_cfg_combiners_match_reference(scale):
    rng = np.random.default_rng(4)
    ec, eu = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
              for _ in range(2))
    delta = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    np.testing.assert_allclose(tsam.cfg_combine(t(ec), t(eu), scale).numpy(),
                               np.asarray(jsam.cfg_combine(ec, eu, scale)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tsam.cfg_delta(t(ec), t(eu)).numpy(),
                                  np.asarray(jsam.cfg_delta(ec, eu)))
    np.testing.assert_allclose(
        tsam.cfg_apply_delta(t(ec), t(delta), scale).numpy(),
        np.asarray(jsam.cfg_apply_delta(ec, delta, scale)), rtol=1e-6, atol=1e-6)
    bf = t(ec).to(torch.bfloat16)
    assert tsam.cfg_combine(bf, bf, scale).dtype == torch.bfloat16
    assert tsam.cfg_delta(bf, bf).dtype == torch.float32


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (2, 33, 7), (5,),
                                   (1, 128, 128, 3)])
@pytest.mark.parametrize("scale", [0.0, 1.0, 7.5])
def test_k3_plain_version_matches_reference_kernel(shape, scale):
    """tests/test_kernels.py::test_cfg_epilogue_matches_sampler's cases: the
    reference's ops.cfg_epilogue runs the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(16)
    ec, eu = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    comb, delta = ops.cfg_epilogue(torch.from_numpy(ec), torch.from_numpy(eu),
                                   scale)
    jcomb, jdelta = jops.cfg_epilogue(jnp.asarray(ec), jnp.asarray(eu), scale)
    np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), **K3_BAR)
    np.testing.assert_array_equal(delta.numpy(), np.asarray(jdelta))
    only = ops.cfg_epilogue(torch.from_numpy(ec), torch.from_numpy(eu),
                            torch.tensor(scale), with_delta=False)
    torch.testing.assert_close(only, comb, rtol=0, atol=0)


def test_k3_wrapper_checks_and_no_fallback():
    ec = torch.zeros(2, 4, 4, 3)
    # a per-lane scale has one entry a lane (eps's leading dim), and is 1-d
    with pytest.raises(ValueError, match="one entry a lane"):
        ops.cfg_epilogue(ec, ec, torch.tensor([1.0, 2.0, 3.0]))
    with pytest.raises(ValueError, match="one entry a lane"):
        ops.cfg_epilogue(ec, ec, torch.full((2, 1, 1, 1), 4.0))
    ops.cfg_epilogue(ec, ec, torch.tensor([1.0, 2.0]))
    with pytest.raises(TypeError, match="scale"):
        ops.cfg_epilogue(ec, ec, "4")
    with pytest.raises(ValueError, match="shape and dtype"):
        ops.cfg_epilogue(ec, ec.to(torch.bfloat16), 4.0)
    with pytest.raises(ValueError, match="shape and dtype"):
        ops.cfg_epilogue(ec, ec[:1], 4.0)
    ops.reset_launch_counts()
    ops.cfg_epilogue(ec, ec, 4.0)
    assert ops.launch_counts() == {}            # CPU: the plain version
    with pytest.raises(ValueError, match="no cfg_epilogue kernel"):
        ops.cfg_epilogue(ec.to("meta"), ec.to("meta"), 4.0)


# ----------------------------------------------------------------------
# the guided forwards
# ----------------------------------------------------------------------

def test_guidance_conds_and_forward_cfg_match_reference(setup):
    jcfg, jparams, tcfg, tparams, x_T, cond = setup
    np.testing.assert_array_equal(tdit.guidance_conds(torch.from_numpy(cond)).numpy(),
                                  np.asarray(jdit.guidance_conds(cond)))
    np.testing.assert_array_equal(tdit.null_like(torch.tensor(3)).numpy(),
                                  np.asarray(jdit.null_like(jnp.asarray(3))))
    want = jdit.forward_cfg(jparams, jcfg, jnp.asarray(x_T), 37,
                            jnp.asarray(cond), 4.0)
    got = tdit.forward_cfg(tparams, tcfg, torch.from_numpy(x_T), 37,
                           torch.from_numpy(cond), 4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_BAR)
    with pytest.raises(NotImplementedError, match="prompt"):
        tdit.guidance_conds(torch.zeros(2, 4, 5))


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("buffered", [False, True])
def test_branch_batched_forward_equals_two_forwards(setup, batch, buffered):
    """One forward over 2B rows against the cond and the null-cond forward
    of tdit.forward_patch, each against its own branch's buffers."""
    _, _, tcfg, tparams, x_T, cond = setup
    rng = np.random.default_rng(7)
    x = torch.from_numpy(x_T[:batch, 4:12])
    c = torch.from_numpy(cond[:batch])
    shape = (2,) + tdit.buffer_shape(tcfg, batch)
    bufs = tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(2)) if buffered else None
    eps2, kvs2 = tdit.forward_patch_cfg(tparams, tcfg, x, 37, c, 2, buffers=bufs)
    for br, cb in ((0, c), (1, tdit.null_like(c))):
        one = None if bufs is None else (bufs[0][br], bufs[1][br])
        eps, kvs = tdit.forward_patch(tparams, tcfg, x, 37, cb, 2, buffers=one)
        torch.testing.assert_close(eps2[br], eps, **FWD_BAR)
        for a, b in zip(kvs2, kvs):
            torch.testing.assert_close(a[br], b, **FWD_BAR)


# ----------------------------------------------------------------------
# guided generate against the reference
# ----------------------------------------------------------------------

def _run_both(setup, occupancies, use_pallas=False, **knobs):
    jcfg, jparams, tcfg, tparams, x_T, cond = setup
    jconf = jpipe.StadiConfig.from_occupancies(
        occupancies, use_pallas_attention=use_pallas, **knobs)
    tconf = tpipe.StadiConfig.from_occupancies(occupancies, **knobs)
    jres = jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                               jconf).generate(jnp.asarray(x_T), jnp.asarray(cond))
    tres = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(T=100),
                               tconf, device="cpu").generate(
        torch.from_numpy(x_T), torch.from_numpy(cond))
    return jres, tres


def _assert_same_run(jres, tres):
    assert _plain(tres.plan) == _plain(jres.plan)
    assert _records(tres.trace) == _records(jres.trace)
    assert _plain(tres.trace.guidance) == _plain(jres.trace.guidance)
    assert tres.image.dtype == torch.float32
    assert _rel(tres.image.numpy(), jres.image) < REL_BAR
    assert tres.kernel_stats == {"launches": {}}      # CPU: plain versions only


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_guided_generate_matches_reference(setup, use_pallas):
    jres, tres = _run_both(setup, [0.0, 0.5], use_pallas, m_base=8,
                           m_warmup=2, cfg_scale=4.0)
    assert tres.plan.guidance.mode == "fused"
    _assert_same_run(jres, tres)


@pytest.mark.parametrize("mode,exchange", [("split", "sync"),
                                           ("split", "predictive"),
                                           ("interleaved", "sync")])
def test_split_and_interleaved_generate_match_reference(setup, mode, exchange):
    jres, tres = _run_both(setup, [0.0, 0.0, 0.5, 0.5], m_base=16, m_warmup=4,
                           cfg_scale=4.0, planner="stadi_guidance",
                           guidance=mode, exchange=exchange)
    g = tres.plan.guidance
    assert (g.mode, g.cond_devices, g.uncond_devices) == (mode, (0, 2), (1, 3))
    _assert_same_run(jres, tres)
    fresh = [e.uncond_fresh for e in tres.trace.events if not e.synchronous]
    assert fresh == ([True, False] * 3 if mode == "interleaved" else [True] * 6)


# ----------------------------------------------------------------------
# the port's own guidance contracts
# ----------------------------------------------------------------------

def _schedule(setup, guidance, exchange="sync"):
    _, _, tcfg, tparams, x_T, cond = setup
    return tpp.run_schedule(tparams, tcfg, tsam.linear_schedule(100),
                            torch.from_numpy(x_T), torch.from_numpy(cond),
                            TemporalPlan([8, 6], [1, 2], [False, False], 8, 2),
                            [5, 3], exchange=exchange, guidance=guidance)


@pytest.mark.parametrize("exchange", ["sync", "stale_async", "predictive"])
def test_split_equals_fused_bitwise(setup, exchange):
    """tests/test_guidance.py::test_split_cfg_bitwise_equals_fused_reference:
    the placement moves work between devices, never between math."""
    fused = _schedule(setup, tguide.GuidancePlan("fused", 2.5), exchange)
    split = _schedule(setup, tguide.GuidancePlan("split", 2.5, (0, 1), (2, 3)),
                      exchange)
    assert torch.equal(fused.image, split.image)


def test_interleaved_refresh_one_is_split_bitwise_and_reuse_drifts(setup):
    split = _schedule(setup, tguide.GuidancePlan("split", 2.5, (0, 1), (2, 3)))
    every = _schedule(setup, tguide.GuidancePlan("interleaved", 2.5, (0, 1),
                                                 (2, 3), uncond_refresh=1))
    assert torch.equal(split.image, every.image)
    reuse = _schedule(setup, tguide.GuidancePlan("interleaved", 2.5, (0, 1),
                                                 (2, 3), uncond_refresh=2))
    assert not torch.equal(split.image, reuse.image)
    assert [e.uncond_fresh for e in reuse.trace.events if not e.synchronous] \
        == [True, False, True]
    assert (split.image - reuse.image).abs().max().item() < 0.5


def test_run_origin_cfg_matches_reference(setup):
    jcfg, jparams, tcfg, tparams, x_T, cond = setup
    want = jpp.run_origin_cfg(jparams, jcfg, jsam.linear_schedule(100),
                              jnp.asarray(x_T), jnp.asarray(cond), 4, 3.0)
    got = tpp.run_origin_cfg(tparams, tcfg, tsam.linear_schedule(100),
                             torch.from_numpy(x_T), torch.from_numpy(cond), 4, 3.0)
    assert _rel(got.numpy(), want) < REL_BAR


def test_branch_stacked_merge_matches_reference():
    rng = np.random.default_rng(2)
    shape = (2, 2, 1, 16, 2, 4)                # [2, L, B, N, H, hd]
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    kl, vl = (rng.standard_normal((2, 2, 1, 4, 2, 4)).astype(np.float32)
              for _ in range(2))
    jpend, tpend = {}, {}
    jbuf.publish_local(jpend, 1, jnp.asarray(kl), jnp.asarray(vl), 8)
    tbuf.publish_local(tpend, 1, torch.from_numpy(kl), torch.from_numpy(vl), 8)
    tp0 = tbuf.Published(torch.from_numpy(k0), torch.from_numpy(v0), 3)
    jm = jbuf.merge(jbuf.Published(jnp.asarray(k0), jnp.asarray(v0), 3), jpend,
                    8, axis=3)
    tm = tbuf.merge(tp0, tpend, 8, axis=3)
    np.testing.assert_array_equal(tm.k.numpy(), np.asarray(jm.k))
    np.testing.assert_array_equal(tm.v.numpy(), np.asarray(jm.v))
    assert torch.equal(tp0.k, torch.from_numpy(k0))     # old version intact
    assert tm.step == 8


def test_guided_pipeline_errors(setup):
    _, _, tcfg, tparams, x_T, cond = setup
    sched = tsam.linear_schedule(100)
    conf = tpipe.StadiConfig.from_occupancies([0.0, 0.0, 0.5, 0.5], m_base=8,
                                              m_warmup=2, cfg_scale=2.0)
    mk = lambda c: tpipe.StadiPipeline(tcfg, tparams, sched, c, device="cpu")
    with pytest.raises(ValueError, match="stadi_guidance"):
        mk(dataclasses.replace(conf, guidance="split")).plan()
    with pytest.raises(ValueError, match="cfg_scale"):
        mk(dataclasses.replace(conf, cfg_scale=0.0, guidance="fused"))
    with pytest.raises(ValueError, match="unknown guidance"):
        mk(dataclasses.replace(conf, guidance="both"))
    with pytest.raises(ValueError, match="rebalancing"):
        mk(dataclasses.replace(conf, rebalance_every=1))
    with pytest.raises(ValueError, match="class condition"):
        mk(conf).generate(torch.from_numpy(x_T), None)
    # a fused plan on the split-guidance ranks: the reference's message
    with pytest.raises(ValueError, match="plain 'spmd' backend"):
        mk(dataclasses.replace(conf, backend="spmd_guidance")).generate(
            torch.from_numpy(x_T), torch.from_numpy(cond))
