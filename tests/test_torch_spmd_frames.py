"""The frame axis across ranks and in the serving engine, against the JAX
package, on the CPU: the port's ``run_spmd_frames`` on 4 gloo ranks (2 frame
rows x 2 patch-worker columns, groups (2, 1)) against the reference's on 4
XLA host devices and against the port's emulated video (relative error <
``REL_BAR``), each rank running the forwards of its own row's frames only;
and the video serving lanes on ``emulated`` and ``spmd_frames`` against the
reference's engine on the same submissions (clips within ``REL_BAR``, round
reports and modeled latencies ``==``), with the lanes' refusals. Sizes are
``tiny-dit.reduced()`` in fp32, F = 3, with the blocks' modulation scaled
as in tests/test_torch_frames.py."""
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
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro.serving import DiffusionServingEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.serving import DiffusionServingEngine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_BAR = 1e-5
GAIN = 15.0
F = 3
RANK_TIMEOUT = 240
#: the multi-rank video: 2 rows x 2 columns, row 0 owning frames 0 and 1
PLAN = dict(steps=[8, 4], ratios=[1, 2], excluded=[False, False], m_base=8,
            m_warmup=2)
PATCHES = [5, 3]
GROUPS = (2, 1)
EXCHANGES = ("stale_async", "sync", "predictive")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-dit").reduced()
    np_params = jax.tree_util.tree_map(np.asarray, jdit.nondegenerate_params(
        jdit.init_params(jax.random.PRNGKey(0), jcfg)))
    blocks = dict(np_params["blocks"])
    for name in ("mod_w", "mod_b"):
        blocks[name] = blocks[name] * np.float32(GAIN)
    np_params = dict(np_params, blocks=blocks)
    x_T = np.random.default_rng(2).standard_normal(
        (1, F, jcfg.latent_size, jcfg.latent_size, jcfg.channels)
    ).astype(np.float32)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            DiTConfig(**dataclasses.asdict(jcfg)), np_params,
            bridge.params_from_jax(np_params, device="cpu"), x_T)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _save_inputs(path, np_params, x_T):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = np.asarray(v)
    walk(np_params, "")
    np.savez(path, x_T=x_T, cond=np.array([1]), **flat)


def _load_params(data):
    tree = {}
    for key in data.files:
        if key.startswith("p/"):
            node = tree
            *parts, leaf = key[2:].split("/")
            for name in parts:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return tree


# ----------------------------------------------------------------------
# run_spmd_frames: the reference's mesh, the port's emulated video
# ----------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import sampler, spmd
    from repro.core.frames import FramePlan
    from repro.core.schedule import TemporalPlan

    data = np.load(sys.argv[1])
    params = {}
    for key in data.files:
        if key.startswith("p/"):
            node = params
            *path, leaf = key[2:].split("/")
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = jnp.asarray(data[key])
    assert len(jax.devices()) == 4, jax.devices()
    plan = TemporalPlan(**eval(sys.argv[3]))
    img = spmd.run_spmd_frames(
        params, get_config("tiny-dit").reduced(), sampler.linear_schedule(T=100),
        jnp.asarray(data["x_T"]), jnp.asarray(data["cond"]), plan,
        eval(sys.argv[4]), FramePlan(3, eval(sys.argv[5])),
        exchange="stale_async")
    np.save(sys.argv[2], np.asarray(img))
    print("JAX_SPMD_FRAMES_OK")
""")


def _frames_rank(ctx, path):
    """One port rank: every exchange's video, with this rank's full-image
    and patch forwards counted."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler, spmd
    from repro_torch.core.frames import FramePlan
    from repro_torch.core.schedule import TemporalPlan
    from repro_torch.models.diffusion import dit

    data = np.load(path)
    params = bridge.params_from_jax(_load_params(data), device="cpu")
    counts = {"full": 0, "patch": 0}
    forward_patch = dit.forward_patch

    def counting(*a, **kw):
        counts["patch" if kw.get("valid_tokens") is not None else "full"] += 1
        return forward_patch(*a, **kw)
    dit.forward_patch = counting
    out = {}
    for exchange in EXCHANGES:
        counts.update(full=0, patch=0)
        img = spmd.run_spmd_frames(
            params, get_config("tiny-dit").reduced(),
            sampler.linear_schedule(100), torch.from_numpy(data["x_T"]),
            torch.from_numpy(data["cond"]), TemporalPlan(**PLAN), PATCHES,
            FramePlan(F, GROUPS), exchange=exchange)
        out[exchange] = (img.numpy(), dict(counts))
    return out


@pytest.fixture(scope="module")
def frames_runs(model, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_frames")
    inputs = tmp / "inputs.npz"
    _save_inputs(inputs, model[3], model[5])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    env.pop("STADI_HOST_DEVICES", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(inputs), str(tmp / "jax.npy"),
         repr(PLAN), repr(PATCHES), repr(GROUPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    got = ranks.spawn(_frames_rank, 4, device_type="cpu",
                      args=(str(inputs),), timeout=RANK_TIMEOUT)
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0 and "JAX_SPMD_FRAMES_OK" in out, err[-3000:]
    return np.load(tmp / "jax.npy"), got


def _emulated(model, exchange):
    from repro_torch.core import frames as tfr
    from repro_torch.core.schedule import TemporalPlan
    return tfr.run_frames(model[4], model[2], tsam.linear_schedule(100),
                          torch.from_numpy(model[5]), torch.tensor([1]),
                          TemporalPlan(**PLAN), PATCHES, exchange=exchange,
                          frames=tfr.FramePlan(F, GROUPS)).image.numpy()


def test_spmd_frames_matches_reference_mesh(frames_runs):
    want, got = frames_runs
    for rank_out in got:
        assert _rel(rank_out["stale_async"][0], want) < REL_BAR


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_spmd_frames_matches_emulated_video(model, frames_runs, exchange):
    _, got = frames_runs
    emu = _emulated(model, exchange)
    for rank_out in got:
        assert _rel(rank_out[exchange][0], emu) < REL_BAR
        np.testing.assert_array_equal(rank_out[exchange][0], got[0][exchange][0])


def test_each_rank_runs_its_rows_frames_only(frames_runs):
    """Rank g * 2 + w runs the warm-up forwards of its row's frames and, per
    interval, its column's active substeps of each of them: the reference's
    mesh computes every frame on every row and masks the others."""
    _, got = frames_runs
    steps = PLAN["m_base"] - PLAN["m_warmup"]           # adaptive fine steps
    for rank, rank_out in enumerate(got):
        g, w = divmod(rank, len(PATCHES))
        owned = GROUPS[g]
        for exchange in EXCHANGES:
            counts = rank_out[exchange][1]
            assert counts["full"] == PLAN["m_warmup"] * owned, (rank, counts)
            assert counts["patch"] == owned * steps // PLAN["ratios"][w], \
                (rank, counts)


# ----------------------------------------------------------------------
# the video serving lanes against the reference's engine
# ----------------------------------------------------------------------

def _pipes(model, **knobs):
    jcfg, jparams, tcfg, _, tparams, _ = model
    occ = knobs.pop("occupancies")
    kw = dict(m_base=8, m_warmup=2, num_frames=F, exchange="stale_async",
              exchange_refresh=2, **knobs)
    j = jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=1000),
                            jpipe.StadiConfig.from_occupancies(occ, **kw))
    t = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(1000),
                            tpipe.StadiConfig.from_occupancies(occ, **kw),
                            device="cpu")
    return j, t


def _clips(model):
    x = model[5]
    return [x, x + 1.0, x - 1.0]


def _drain_reference(jpipe_, clips):
    engine = JEngine(jpipe_, slots=2)
    reqs = [engine.submit(jnp.asarray(c), i + 1) for i, c in enumerate(clips)]
    engine.run_to_completion()
    return engine, reqs


def _assert_lanes_match(je, jreqs, rounds, reqs):
    """Clips within the bar; admissions, round costs and modeled latencies
    ``==``."""
    for (jr, tr) in zip(jreqs, reqs):
        assert _rel(tr["image"], np.asarray(jr.image)) < REL_BAR
        assert (tr["admit_round"], tr["finish_round"],
                tr["modeled_latency_s"]) == (jr.admit_round, jr.finish_round,
                                             jr.modeled_latency_s)
    assert rounds == [(r.admitted, r.modeled_s) for r in je.rounds]


def _summary(engine, reqs):
    return ([(r.admitted, r.modeled_s) for r in engine.rounds],
            [dict(image=r.image.numpy(), admit_round=r.admit_round,
                  finish_round=r.finish_round,
                  modeled_latency_s=r.modeled_latency_s) for r in reqs])


@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "guided"])
def test_emulated_video_lanes_match_reference(model, guided):
    knobs = dict(occupancies=[0.0, 0.2, 0.4, 0.5], planner="stadi_video")
    if guided:
        knobs["cfg_scale"] = 2.0
    j, t = _pipes(model, **knobs)
    clips = _clips(model)
    je, jreqs = _drain_reference(j, clips)
    engine = DiffusionServingEngine(t, slots=2)
    assert engine.frames == t.plan().frames and engine.frames.num_frames == F
    reqs = [engine.submit(torch.from_numpy(c), i + 1)
            for i, c in enumerate(clips)]
    engine.run_to_completion()
    assert len(engine.rounds) == 2                  # 2 slots, 3 clips
    _assert_lanes_match(je, jreqs, *_summary(engine, reqs))
    lone = t.generate(torch.from_numpy(clips[0]), torch.tensor([1]))
    assert torch.equal(reqs[0].image, lone.image)
    lats = [r.modeled_latency_s for r in reqs]
    assert lats[0] < lats[1] < lats[2]
    assert engine.stats()["modeled_makespan_s"] == pytest.approx(lats[2])
    assert engine.stats()["dispatches"] == {"clip": 3}


def _serve_rank(ctx, path):
    """One rank of the spmd_frames video lanes: the same engine and clips on
    every rank."""
    data = np.load(path)
    params = bridge.params_from_jax(_load_params(data), device="cpu")
    from repro_torch.configs import get_config
    config = tpipe.StadiConfig.from_occupancies(
        [0.0, 0.0, 0.5, 0.5], m_base=8, m_warmup=2, num_frames=F,
        exchange="stale_async", exchange_refresh=2, planner="stadi_video",
        frame_groups=2, backend="spmd_frames")
    pipe = tpipe.StadiPipeline(get_config("tiny-dit").reduced(), params,
                               tsam.linear_schedule(1000), config,
                               device="cpu")
    engine = DiffusionServingEngine(pipe, slots=2)
    x = data["x_T"]
    reqs = [engine.submit(torch.from_numpy(c), i + 1)
            for i, c in enumerate([x, x + 1.0, x - 1.0])]
    engine.run_to_completion()
    return _summary(engine, reqs)


def test_spmd_frames_video_lanes_match_reference(model, tmp_path):
    """The spmd_frames lanes on 4 gloo ranks against the reference's engine
    on its emulated frame executor (the same plan; the reference's own test
    holds its spmd_frames video to its emulated one)."""
    inputs = tmp_path / "inputs.npz"
    _save_inputs(inputs, model[3], model[5])
    got = ranks.spawn(_serve_rank, 4, device_type="cpu", args=(str(inputs),),
                      timeout=RANK_TIMEOUT)
    j, _ = _pipes(model, occupancies=[0.0, 0.0, 0.5, 0.5],
                  planner="stadi_video", frame_groups=2)
    assert tuple(j.plan().frames.groups) == GROUPS
    je, jreqs = _drain_reference(j, _clips(model))
    for rounds, reqs in got:
        _assert_lanes_match(je, jreqs, rounds, reqs)


REJECTIONS = {
    "rebalance": (dict(rebalance_every=2), None),
    "frames": (None, lambda x: (x[:, :2], {})),
    "one_clip": (None, lambda x: (np.concatenate([x, x]), {})),
    "cfg_scale": (None, lambda x: (x, dict(cfg_scale=2.0))),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_video_lane_rejections_match_reference(model, case):
    engine_kw, submit = REJECTIONS[case]
    j, t = _pipes(model, occupancies=[0.0, 0.4])
    msgs = []
    for pkg, pipe, arr in ((JEngine, j, jnp.asarray),
                           (DiffusionServingEngine, t, torch.from_numpy)):
        with pytest.raises(ValueError) as err:
            if engine_kw is not None:
                pkg(pipe, slots=2, **engine_kw)
            else:
                x, kw = submit(model[5])
                pkg(pipe, slots=2).submit(arr(np.ascontiguousarray(x)), 1,
                                          **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and msgs[0]
