"""The slice end to end on the CPU: ``StadiPipeline.generate`` of the port
against the reference on ``tiny-dit.reduced()`` with the same weights,
noise and classes, under sync, stale_async and predictive, with the
reference's Pallas kernel off and on. The image must agree to relative error
< 1e-3 (the emulated-vs-spmd bar of tests/test_pipeline.py) and the plan,
trace records and replans must be equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import buffers as jbuf  # noqa: E402
from repro.core import patch_parallel as jpp  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import buffers as tbuf  # noqa: E402
from repro_torch.core import patch_parallel as tpp  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402

REL_BAR = 1e-3


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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _records(trace):
    return [dataclasses.asdict(e) for e in trace.events]


def _trace_meta(trace):
    return (dataclasses.asdict(trace.plan), trace.patches, trace.n_tokens,
            trace.latent_bytes, trace.kv_bytes_per_worker, trace.act_row_bytes)


def _run_both(setup, occupancies, use_pallas=False, measured=None, **knobs):
    jcfg, jparams, tcfg, tparams, x_T, cond = setup
    jconf = jpipe.StadiConfig.from_occupancies(
        occupancies, use_pallas_attention=use_pallas, **knobs)
    tconf = tpipe.StadiConfig.from_occupancies(occupancies, **knobs)
    jres = jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                               jconf).generate(jnp.asarray(x_T), jnp.asarray(cond),
                                               measured_speeds=measured)
    tres = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(T=100),
                               tconf, device="cpu").generate(
        torch.from_numpy(x_T), torch.from_numpy(cond), measured_speeds=measured)
    return jres, tres


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("exchange", ["sync", "stale_async", "predictive"])
def test_generate_matches_reference(setup, exchange, use_pallas):
    """Patches [4, 4]: K1 at Nl=32 tokens, tok_start 0 and 32, N=64."""
    jres, tres = _run_both(setup, [0.0, 0.5], use_pallas, m_base=8,
                           m_warmup=2, exchange=exchange)
    assert tres.plan.patches == jres.plan.patches == [4, 4]
    assert dataclasses.asdict(tres.plan.temporal) == \
        dataclasses.asdict(jres.plan.temporal)
    assert _records(tres.trace) == _records(jres.trace)
    assert _trace_meta(tres.trace) == _trace_meta(jres.trace)
    assert tres.image.dtype == torch.float32
    assert _rel(tres.image.numpy(), jres.image) < REL_BAR
    assert tres.kernel_stats == {"launches": {}}      # CPU: plain versions only


def test_predictive_extrapolation_matches_reference(setup):
    """m_base=16: the third boundary extrapolates from two real refreshes."""
    jres, tres = _run_both(setup, [0.0, 0.5], m_base=16, m_warmup=4,
                           exchange="predictive", exchange_refresh=2)
    kinds = [e.exchange for e in tres.trace.events if not e.synchronous]
    assert kinds == ["predict", "full"] * 3
    assert _records(tres.trace) == _records(jres.trace)
    assert _rel(tres.image.numpy(), jres.image) < REL_BAR


def test_rebalance_on_drift_matches_reference(setup):
    """tests/test_pipeline.py::test_rebalance_replans_on_drift on both."""
    jres, tres = _run_both(setup, [0.0, 0.0], m_base=16, m_warmup=4,
                           rebalance_every=1, rebalance_threshold=0.2,
                           measured=[1.0, 0.5])
    assert len(tres.replans) >= 1
    for te, je in zip(tres.replans, jres.replans, strict=True):
        assert (te.fine_step, te.drift, te.speeds_before, te.speeds_after) == \
            (je.fine_step, je.drift, je.speeds_before, je.speeds_after)
        assert dataclasses.asdict(te.plan.temporal) == \
            dataclasses.asdict(je.plan.temporal)
        assert te.plan.patches == je.plan.patches
    assert _records(tres.trace) == _records(jres.trace)
    assert _rel(tres.image.numpy(), jres.image) < REL_BAR


def test_simulate_backend_matches_reference(setup):
    cm = dict(t_fixed=1e-3, t_row=5e-4)
    jcfg, jparams, tcfg, tparams, x_T, cond = setup
    jconf = jpipe.StadiConfig.from_occupancies(
        [0.0, 0.6], m_base=16, m_warmup=4, backend="simulate",
        cost_model=jsim.CostModel(**cm))
    tconf = tpipe.StadiConfig.from_occupancies(
        [0.0, 0.6], m_base=16, m_warmup=4, backend="simulate",
        cost_model=tsim.CostModel(**cm))
    jres = jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(100),
                               jconf).generate(jnp.asarray(x_T))
    tres = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100), tconf,
                               device="cpu").generate(torch.from_numpy(x_T))
    assert tres.image is None and tres.latency_s == jres.latency_s
    assert _records(tres.trace) == _records(jres.trace)


def test_distrifusion_and_origin_match_reference(setup):
    jcfg, jparams, tcfg, tparams, x_T, cond = setup
    jsched, tsched = jsam.linear_schedule(100), tsam.linear_schedule(100)
    args_j = (jparams, jcfg, jsched, jnp.asarray(x_T), jnp.asarray(cond))
    args_t = (tparams, tcfg, tsched, torch.from_numpy(x_T), torch.from_numpy(cond))
    jd = jpp.run_distrifusion(*args_j, n_workers=3, m_base=6, m_warmup=2)
    td = tpp.run_distrifusion(*args_t, n_workers=3, m_base=6, m_warmup=2)
    assert _records(td.trace) == _records(jd.trace)
    assert _rel(td.image.numpy(), jd.image) < REL_BAR
    assert _rel(tpp.run_origin(*args_t, m_base=4).numpy(),
                jpp.run_origin(*args_j, m_base=4)) < REL_BAR
    assert torch.equal(args_t[3], torch.from_numpy(x_T))    # input untouched


def test_buffers_match_reference_and_never_alias():
    rng = np.random.default_rng(2)
    shape = (2, 1, 16, 2, 4)
    k0, v0, k1, v1 = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(4))
    kl = rng.standard_normal((2, 1, 4, 2, 4)).astype(np.float32)
    jp0, tp0 = jbuf.Published(jnp.asarray(k0), jnp.asarray(v0), 3), \
        tbuf.Published(torch.from_numpy(k0), torch.from_numpy(v0), 3)
    jpend, tpend = {}, {}
    jbuf.publish_local(jpend, 1, jnp.asarray(kl), jnp.asarray(kl), 8)
    tbuf.publish_local(tpend, 1, torch.from_numpy(kl), torch.from_numpy(kl), 8)
    jm, tm = jbuf.merge(jp0, jpend, 8), tbuf.merge(tp0, tpend, 8)
    np.testing.assert_array_equal(tm.k.numpy(), np.asarray(jm.k))
    assert torch.equal(tp0.k, torch.from_numpy(k0))     # old version intact
    jx = jbuf.extrapolate(jp0, jm, 10)
    tx = tbuf.extrapolate(tp0, tm, 10)
    np.testing.assert_allclose(tx.v.numpy(), np.asarray(jx.v), rtol=1e-6,
                               atol=1e-6)
    assert tbuf.extrapolate(None, tm, 10) is tm


def test_entry_points_refuse_without_device_and_later_slices(setup):
    jcfg, jparams, tcfg, tparams, x_T, cond = setup
    sched = tsam.linear_schedule(100)
    conf = tpipe.StadiConfig.from_occupancies([0.0, 0.5], m_base=8, m_warmup=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.StadiPipeline(tcfg, tparams, sched, conf)
        from repro_torch.launch import stadi_infer
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stadi_infer.main(["--reduced"])
    # the frames slice is ported: a video needs a frame backend, as in the
    # reference, and stadi_video builds
    with pytest.raises(ValueError, match="frame backend"):
        tpipe.StadiPipeline(tcfg, tparams, sched,
                            dataclasses.replace(conf, num_frames=2,
                                                backend="spmd"),
                            device="cpu")
    tpipe.StadiPipeline(tcfg, tparams, sched, dataclasses.replace(
        conf, num_frames=2, planner="stadi_video"), device="cpu")
    # the prompt slice is ported: a text-conditioned model builds, and its
    # planner prices the model's largest prompt bucket, as the reference's
    text = tpipe.StadiPipeline(tcfg.text_conditioned(cond_seq_len=8),
                               tparams, sched, conf, device="cpu")
    assert text._plan_knobs().cond_bucket == 8
    # the pipefuse slice is ported: stages need a staged backend, as in the
    # reference, and stadi_pipefuse builds
    with pytest.raises(ValueError, match="staged backend"):
        tpipe.StadiPipeline(tcfg, tparams, sched,
                            dataclasses.replace(conf, num_stages=2),
                            device="cpu")
    tpipe.StadiPipeline(tcfg, tparams, sched, dataclasses.replace(
        conf, planner="stadi_pipefuse"), device="cpu")
    # the serving slice is ported: a plan cache directory builds (nothing is
    # written before the first plan())
    cached = tpipe.StadiPipeline(tcfg, tparams, sched, dataclasses.replace(
        conf, plan_cache_dir="x"), device="cpu")
    assert cached.plan_cache is not None and cached.planner_calls == 0
    assert tpipe.get_stepper_factory("spmd") is not None   # item 9b ported
    # the sequence-parallel slice is ported: seq_shards and stadi_seq build
    for knobs in ({"seq_shards": 2}, {"planner": "stadi_seq"}):
        tpipe.StadiPipeline(tcfg, tparams, sched,
                            dataclasses.replace(conf, **knobs), device="cpu")
    # the multi-rank backends are ported: outside the ranks of a process
    # group they refuse to run
    for knobs in ({"backend": "spmd"}, {"backend": "spmd_guidance",
                                        "cfg_scale": 3.0,
                                        "planner": "stadi_guidance",
                                        "guidance": "split"},
                  {"backend": "spmd_seq", "seq_shards": 2},
                  {"backend": "spmd_pipefuse", "num_stages": 2},
                  {"backend": "spmd_frames", "num_frames": 2}):
        pipe = tpipe.StadiPipeline(tcfg, tparams, sched,
                                   dataclasses.replace(conf, **knobs),
                                   device="cpu")
        with pytest.raises(RuntimeError, match="process group"):
            pipe.generate(torch.from_numpy(x_T), torch.from_numpy(cond))
