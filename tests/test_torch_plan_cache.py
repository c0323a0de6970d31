"""The port's persistent plan cache against the JAX package's, on the CPU:
the hit/miss/invalidation semantics of tests/test_plan_cache.py for the axes
this port plans (steps, patches, guidance, seq, frames), plans that round-trip
``==``, and the shared key recipe — the same key for the same workload in
both packages, so an entry written by either is a hit in the other. Sizes
are ``tiny-dit.reduced()`` in fp32 with T = 100."""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import hetero as jhetero  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core.simulate import CostModel as JCostModel  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro.serving import plan_cache as jpc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import hetero as thetero  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core.simulate import CostModel  # noqa: E402
from repro_torch.serving import plan_cache as tpc  # noqa: E402
from repro_torch.serving.diffusion_engine import DiffusionServingEngine  # noqa: E402


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
    jcfg = jax_get_config("tiny-dit").reduced()
    jparams = jdit.nondegenerate_params(jdit.init_params(jax.random.PRNGKey(0),
                                                         jcfg))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)), tparams


def _config(speeds, pkg=tpipe, hetero=thetero, **kw):
    cluster = tuple(hetero.DeviceProfile(f"dev{i}", c=v)
                    for i, v in enumerate(speeds))
    return pkg.StadiConfig(cluster=cluster, **kw)


def _pipe(setup, tmp_path, speeds=(1.0, 0.5), cfg=None, text=0, **kw):
    """The port's pipeline; ``text`` > 0 plans the text-conditioned model
    of that cond_seq_len (planning reads no weights)."""
    _, _, tcfg, tparams = setup
    if text:
        cfg = tcfg.text_conditioned(cond_seq_len=text)
    config = _config(list(speeds), **{"m_base": 8, "m_warmup": 2, **kw},
                     plan_cache_dir=str(tmp_path))
    return tpipe.StadiPipeline(cfg or tcfg, tparams, tsam.linear_schedule(100),
                               config, device="cpu")


def _jax_pipe(setup, tmp_path, speeds=(1.0, 0.5), text=0, **kw):
    jcfg, jparams, _, _ = setup
    if text:
        jcfg = jcfg.text_conditioned(cond_seq_len=text)
    if "cost_model" in kw and kw["cost_model"] is not None:
        kw["cost_model"] = JCostModel(**dataclasses.asdict(kw["cost_model"]))
    config = _config(list(speeds), jpipe, jhetero, m_base=8, m_warmup=2,
                     plan_cache_dir=str(tmp_path), **kw)
    return jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                               config)


def _x(cfg, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (1, cfg.latent_size, cfg.latent_size, cfg.channels)).astype(np.float32))


# ----------------------------------------------------------------------
# hit / miss semantics (tests/test_plan_cache.py)
# ----------------------------------------------------------------------

def test_hit_on_identical_key_skips_planner_search(setup, tmp_path):
    pipe = _pipe(setup, tmp_path)
    p1 = pipe.plan()
    assert pipe.planner_calls == 1
    assert pipe.plan_cache.stats()["misses"] == 1
    p2 = pipe.plan()
    assert p2 == p1
    assert pipe.planner_calls == 1          # search was skipped
    assert pipe.plan_cache.stats()["hits"] == 1
    assert pipe.plan_cache.stats()["hit_rate"] == 0.5


def test_restart_persistence(setup, tmp_path):
    _pipe(setup, tmp_path).plan()
    fresh = _pipe(setup, tmp_path)          # new process, same cache dir
    plan = fresh.plan()
    assert fresh.planner_calls == 0
    assert fresh.plan_cache.hits == 1
    assert plan == _pipe(setup, tmp_path).plan()


def test_miss_on_any_key_component_change(setup, tmp_path):
    base = _pipe(setup, tmp_path)
    base.plan()
    other_speeds = _pipe(setup, tmp_path, speeds=(1.0, 0.6))
    other_speeds.plan()
    assert other_speeds.planner_calls == 1
    other_steps = tpipe.StadiPipeline(base.model_cfg, base.params, base.sched,
                                      dataclasses.replace(base.config,
                                                          m_base=16),
                                      device="cpu")
    other_steps.plan()
    assert other_steps.planner_calls == 1
    cfg2 = dataclasses.replace(base.model_cfg, n_layers=base.model_cfg.n_layers + 1)
    other_model = _pipe(setup, tmp_path, cfg=cfg2)
    other_model.plan()
    assert other_model.planner_calls == 1
    again = _pipe(setup, tmp_path)
    again.plan()
    assert again.planner_calls == 0


def test_sub_jitter_speeds_share_an_entry(setup, tmp_path):
    _pipe(setup, tmp_path).plan()
    jittered = _pipe(setup, tmp_path, speeds=(1.001, 0.499))
    jittered.plan()
    assert jittered.planner_calls == 0
    assert jittered.plan_cache.hits == 1


def test_corrupt_entry_falls_back_loudly(setup, tmp_path):
    pipe = _pipe(setup, tmp_path)
    live = pipe.plan()
    path = pipe.plan_cache._path(pipe.last_plan_key)
    with open(path, "w") as f:
        f.write("{not json")
    fresh = _pipe(setup, tmp_path)
    with pytest.warns(RuntimeWarning, match="falling back to live planning"):
        recovered = fresh.plan()
    assert recovered == live
    assert fresh.planner_calls == 1
    assert fresh.plan_cache.corrupt == 1
    third = _pipe(setup, tmp_path)
    third.plan()
    assert third.planner_calls == 0


def test_unversioned_entry_is_corrupt(setup, tmp_path):
    pipe = _pipe(setup, tmp_path)
    pipe.plan()
    with open(pipe.plan_cache._path(pipe.last_plan_key), "w") as f:
        f.write('{"version": 999}')
    fresh = _pipe(setup, tmp_path)
    with pytest.warns(RuntimeWarning, match="version"):
        fresh.plan()
    assert fresh.plan_cache.corrupt == 1


def test_cache_version_bump_invalidates_old_entries_loudly(setup, tmp_path):
    pipe = _pipe(setup, tmp_path)
    live = pipe.plan()
    path = pipe.plan_cache._path(pipe.last_plan_key)
    with open(path) as f:
        entry = json.load(f)
    entry["version"] = tpc.CACHE_VERSION - 1
    with open(path, "w") as f:
        json.dump(entry, f)
    fresh = _pipe(setup, tmp_path)
    with pytest.warns(RuntimeWarning, match="version"):
        recovered = fresh.plan()
    assert recovered == live and fresh.planner_calls == 1
    with open(path) as f:
        assert json.load(f)["version"] == tpc.CACHE_VERSION
    migrated = _pipe(setup, tmp_path)
    migrated.plan()
    assert migrated.planner_calls == 0


def test_cache_roundtrips_guidance_and_seq(setup, tmp_path):
    """A plan with a guidance and a seq axis survives the disk round trip
    exactly — dataclass equality on every axis."""
    for knobs in ({"cfg_scale": 2.0, "guidance": "fused", "seq_shards": 2,
                   "backend": "simulate",
                   "cost_model": CostModel(t_fixed=1e-3, t_row=1e-4)},
                  {"cfg_scale": 2.0, "guidance": "split",
                   "planner": "stadi_guidance"}):
        speeds = (1.0, 1.0, 0.5, 0.5)
        planned = _pipe(setup, tmp_path, speeds, **knobs).plan()
        fresh = _pipe(setup, tmp_path, speeds, **knobs)
        cached = fresh.plan()
        assert fresh.planner_calls == 0
        assert cached == planned
        assert cached.guidance == planned.guidance and cached.seq == planned.seq
        assert tpc.plan_from_dict(tpc.plan_to_dict(planned)) == planned


def test_use_cache_false_bypasses(setup, tmp_path):
    pipe = _pipe(setup, tmp_path)
    pipe.plan()
    pipe.plan(use_cache=False)
    assert pipe.planner_calls == 2
    assert pipe.plan_cache.hits == 0


def test_no_cache_dir_means_no_cache(setup):
    _, _, tcfg, tparams = setup
    pipe = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                               _config([1.0, 0.5], m_base=8, m_warmup=2),
                               device="cpu")
    assert pipe.plan_cache is None
    pipe.plan()
    pipe.plan()
    assert pipe.planner_calls == 2


def test_drift_replan_invalidates_stale_entry(setup, tmp_path):
    """Serving-engine replanning drops the cache entry the stale plan came
    from and persists the replanned ones."""
    cm = CostModel(t_fixed=5e-3, t_row=5.5e-4, link_bw=1.25e9,
                   link_latency=50e-6)
    pipe = _pipe(setup, tmp_path, (1.0, 1.0, 0.5, 0.5),
                 planner="stadi_guidance", cfg_scale=2.0, guidance="split",
                 cost_model=cm, m_base=16)
    engine = DiffusionServingEngine(pipe, slots=4, rebalance_every=1,
                                    measured_speeds=[1.0, 0.1, 0.5, 0.5])
    stale_key = pipe.last_plan_key
    assert stale_key is not None
    for i in range(4):
        engine.submit(_x(pipe.model_cfg, 80 + i), i % pipe.model_cfg.n_classes)
    engine.run_to_completion()
    assert engine.stats()["replans"] >= 1
    cache_stats = engine.stats()["plan_cache"]
    assert cache_stats is not None and cache_stats["invalidations"] >= 1
    assert not os.path.exists(pipe.plan_cache._path(stale_key))
    assert glob.glob(os.path.join(str(tmp_path), "*.json"))


def test_pipeline_rebalance_invalidates_stale_entry(setup, tmp_path):
    """The generate-time rebalance hook drops the entry its drifted run was
    planned from (reference ``pipeline.py`` hook)."""
    pipe = _pipe(setup, tmp_path, rebalance_every=1)
    pipe.plan()
    key = pipe.last_plan_key
    res = pipe.generate(_x(pipe.model_cfg, 3), torch.tensor([1]),
                        measured_speeds=[0.2, 1.0])
    assert res.replans and pipe.plan_cache.invalidations == 1
    assert not os.path.exists(pipe.plan_cache._path(key))


def test_engine_stats_surface_cache_counters(setup, tmp_path):
    pipe = _pipe(setup, tmp_path, cost_model=CostModel(t_fixed=1e-3, t_row=1e-4))
    engine = DiffusionServingEngine(pipe, slots=2)
    s = engine.stats()
    assert s["planner_calls"] == 1
    assert s["plan_cache"]["misses"] == 1
    pipe2 = _pipe(setup, tmp_path, cost_model=CostModel(t_fixed=1e-3, t_row=1e-4))
    DiffusionServingEngine(pipe2, slots=2)
    assert pipe2.planner_calls == 0
    assert pipe2.plan_cache.hits == 1


def test_frame_plan_round_trips_between_packages(setup, tmp_path):
    """A stadi_video entry written by either package hits in the other with
    its FramePlan equal, and a frame_groups change is another key (a
    miss)."""
    speeds = (1.0, 1.0, 0.5, 0.5)
    knobs = dict(planner="stadi_video", num_frames=4, frame_groups=2)
    jplan = _jax_pipe(setup, tmp_path / "ref", speeds, **knobs).plan()
    port = _pipe(setup, tmp_path / "ref", speeds, **knobs)
    hit = port.plan()
    assert port.planner_calls == 0 and port.plan_cache.hits == 1
    assert hit.frames is not None and hit.frames.groups == tuple(
        jplan.frames.groups) == (3, 1)
    assert tpc.plan_from_dict(tpc.plan_to_dict(hit)) == hit
    tplan = _pipe(setup, tmp_path / "port", speeds, **knobs).plan()
    ref = _jax_pipe(setup, tmp_path / "port", speeds, **knobs)
    assert jpc.plan_to_dict(ref.plan()) == tpc.plan_to_dict(tplan)
    assert ref.planner_calls == 0 and ref.plan_cache.hits == 1
    other = _pipe(setup, tmp_path / "ref", speeds,
                  **dict(knobs, frame_groups=1))
    assert other.plan().frames.groups == (4,)
    assert other.planner_calls == 1 and other.plan_cache.misses == 1


def _plain_plan():
    from repro_torch.core.planners import ExecutionPlan
    from repro_torch.core.schedule import TemporalPlan
    return ExecutionPlan(TemporalPlan([8, 4], [1, 2], [False, False], 8, 2),
                         [5, 3], "stadi", [1.0, 0.5])


def test_plan_cache_standalone_invalidate_counts_real_removals(tmp_path):
    cache = tpc.PlanCache(cache_dir=str(tmp_path))
    assert cache.invalidate("deadbeef") is False
    assert cache.invalidations == 0
    cache.put("deadbeef", _plain_plan())
    assert cache.get("deadbeef") == _plain_plan()
    assert cache.invalidate("deadbeef") is True and cache.invalidations == 1


# ----------------------------------------------------------------------
# the shared key recipe: one key per workload in both packages
# ----------------------------------------------------------------------

WORKLOADS = [
    dict(),
    dict(speeds=(1.0, 0.6), exchange="stale_async", exchange_refresh=3),
    dict(speeds=(1.0, 1.0, 0.5, 0.5), cfg_scale=2.0, guidance="split",
         planner="stadi_guidance",
         cost_model=CostModel(t_fixed=5e-3, t_row=5.5e-4)),
    dict(speeds=(1.0, 0.5), cfg_scale=3.0),
    dict(speeds=(1.0, 0.8, 0.6, 0.4), seq_shards=2),
    dict(speeds=(1.0, 0.5, 0.5), planner="makespan", tiers=(1, 2, 3),
         cost_model=CostModel(t_fixed=1e-3, t_row=1e-4, t_ctx=1e-6)),
    dict(speeds=(1.0, 1.0, 0.5, 0.5), planner="stadi_video", num_frames=4,
         cost_model=CostModel(t_fixed=1e-5, t_row=1e-5, t_ctx=5e-3)),
    dict(speeds=(1.0, 0.5), num_frames=3, cfg_scale=2.0),
    # text-conditioned: the bucket derived from cond_seq_len, and a pinned
    # serving bucket priced by t_xattn
    dict(text=8),
    dict(speeds=(1.0, 1.0, 0.5, 0.5), text=32, cond_bucket=8, cfg_scale=2.0,
         planner="stadi_guidance",
         cost_model=CostModel(t_fixed=5e-3, t_row=5.5e-4, t_xattn=2e-5)),
]


def _speeds_and_knobs(workload):
    knobs = dict(workload)
    return knobs.pop("speeds", (1.0, 0.5)), knobs


@pytest.mark.parametrize("workload", WORKLOADS)
def test_key_recipe_equals_the_reference(setup, tmp_path, workload):
    speeds, knobs = _speeds_and_knobs(workload)
    t = _pipe(setup, tmp_path, speeds, **knobs)
    j = _jax_pipe(setup, tmp_path, speeds, **knobs)
    assert t._model_key() == j._model_key()
    assert t._workload_key(t._plan_knobs()) == j._workload_key(j._plan_knobs())
    tkey = t.plan_cache.signature(t.config.speeds, t._model_key(),
                                  t._workload_key(t._plan_knobs()))
    jkey = j.plan_cache.signature(j.config.speeds, j._model_key(),
                                  j._workload_key(j._plan_knobs()))
    assert tkey == jkey


@pytest.mark.parametrize("workload", WORKLOADS)
def test_entry_written_by_either_package_hits_in_the_other(setup, tmp_path,
                                                           workload):
    speeds, knobs = _speeds_and_knobs(workload)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    # the reference writes, the port reads
    jplan = _jax_pipe(setup, ref_dir, speeds, **knobs).plan()
    port = _pipe(setup, ref_dir, speeds, **knobs)
    hit = port.plan()
    assert port.planner_calls == 0 and port.plan_cache.hits == 1
    assert tpc.plan_to_dict(hit) == jpc.plan_to_dict(jplan)
    assert hit == _pipe(setup, tmp_path / "live", speeds, **knobs).plan(
        use_cache=False)
    # the port writes, the reference reads
    tplan = _pipe(setup, port_dir, speeds, **knobs).plan()
    ref = _jax_pipe(setup, port_dir, speeds, **knobs)
    jhit = ref.plan()
    assert ref.planner_calls == 0 and ref.plan_cache.hits == 1
    assert jpc.plan_to_dict(jhit) == tpc.plan_to_dict(tplan)
    assert tpc.CACHE_VERSION == jpc.CACHE_VERSION
