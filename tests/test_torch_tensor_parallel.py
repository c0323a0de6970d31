"""The tensor-parallel baseline and its satellites against the JAX package,
on the CPU: ``comm.ring_all_reduce_bytes``, ``simulate.
simulate_tensor_parallel`` and ``uniform_pp_latency`` equal (``==``) over a
grid; ``hetero.profile_step_time`` (the card synchronized around the clock);
``tensor_parallel`` (the specs in the reference's leaf names, the qkv split
by heads, ``tp_forward`` on 2 and 4 gloo ranks within 2e-4 of the
reference's ``tp_forward`` on 4 XLA host devices, its own bar in
``tests/test_distributed_subprocess.py``, and within 1e-5 of the port's
``dit.forward``; a planted contiguous-column qkv split fails that bar; a
text-conditioned config refused by both packages); and the deprecated
``stadi_infer`` and ``plan_*`` shims (the warning, images bitwise the
pipeline's with the mapped planner, traces ``==`` the reference's). Sizes
are ``tiny-dit.reduced()`` in fp32 (4 heads, MLP width 512)."""
import dataclasses
import itertools
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core import stadi as jstadi  # noqa: E402
from repro.core import tensor_parallel as jtp  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core import hetero as thetero  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core import stadi as tstadi  # noqa: E402
from repro_torch.core import tensor_parallel as ttp  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models.diffusion import dit as tdit  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BAR = 2e-4        # the reference's own TP bar (test_distributed_subprocess)
PORT_BAR = 1e-5       # the port's TP forward against its single-process forward
RANK_TIMEOUT = 240
T_STEP = 50


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for these tiny shapes (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-dit").reduced()      # 4 heads of 32, 2 blocks
    jparams = jax.tree_util.tree_map(np.asarray, jdit.nondegenerate_params(
        jdit.init_params(jax.random.PRNGKey(0), jcfg)))
    tparams = bridge.params_from_jax(jparams, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    cond = np.array([1, 2])
    return jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)), tparams, x, cond


# ----------------------------------------------------------------------
# the analytic TP and PP models: equal to the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_ring_all_reduce_bytes_equal(n):
    for nbytes in (0, 1, 4096, 9_437_184, 3 * 10 ** 9 + 7):
        assert tcomm.ring_all_reduce_bytes(n, nbytes) == \
            jcomm.ring_all_reduce_bytes(n, nbytes)


GRID = list(itertools.product(
    [1, 16],                                        # steps
    [[1.0, 1.0], [1.0, 0.4], [0.9, 0.7, 0.5, 0.3]],  # speeds
    [(2e-3, 1e-4, 25e9, 30e-6), (5e-4, 3.3e-7, 4.5e11, 8e-6)]))


@pytest.mark.parametrize("steps,speeds,cm", GRID)
def test_tp_and_pp_models_equal(steps, speeds, cm):
    jcm, tcm = jsim.CostModel(*cm), tsim.CostModel(*cm)
    n = len(speeds)
    for n_layers, rows, act in ((4, 16, 1_000_000), (28, 64, 9_437_184)):
        assert tsim.simulate_tensor_parallel(steps, n, n_layers, rows, speeds,
                                             tcm, act) == \
            jsim.simulate_tensor_parallel(steps, n, n_layers, rows, speeds,
                                          jcm, act)
        assert tsim.uniform_pp_latency(steps, rows, speeds, tcm, act) == \
            jsim.uniform_pp_latency(steps, rows, speeds, jcm, act)


def test_tp_model_is_straggler_bound():
    """A slow device slows every layer's sync (the paper's Fig. 2 point)."""
    cm = tsim.CostModel(t_fixed=1e-3, t_row=1e-4)
    even = tsim.simulate_tensor_parallel(10, 2, 4, 16, [1.0, 1.0], cm, 10 ** 6)
    slow = tsim.simulate_tensor_parallel(10, 2, 4, 16, [1.0, 0.4], cm, 10 ** 6)
    assert slow > even


# ----------------------------------------------------------------------
# profile_step_time
# ----------------------------------------------------------------------

def test_profile_step_time_counts_calls_and_waits_for_the_card(monkeypatch):
    calls, syncs = [], []
    seconds = thetero.profile_step_time(lambda: calls.append(1), warmup=2,
                                        iters=5)
    assert len(calls) == 7 and seconds >= 0.0
    # a step that ran on the card initialised CUDA: the clock then waits
    # for the card before each read, never on the host's enqueue alone
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(len(calls)))
    thetero.profile_step_time(lambda: calls.append(1), warmup=1, iters=3)
    assert syncs == [8, 11]          # after the warm-up, after the last step


# ----------------------------------------------------------------------
# the TP layout
# ----------------------------------------------------------------------

def _spec_axes(spec_tree):
    """The reference's PartitionSpecs as the split axis, None = replicated."""
    def axis(spec):
        hits = [i for i, s in enumerate(spec) if s == "model"]
        return hits[0] if hits else None
    return jax.tree_util.tree_map(axis, spec_tree, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))


def test_specs_in_the_reference_leaf_names(model):
    jcfg, _, tcfg, tparams, _, _ = model
    want = _spec_axes(jtp.tp_param_specs(jcfg))
    assert ttp.tp_param_specs(tcfg) == want
    assert set(ttp.tp_param_specs(tcfg)) == set(tparams)
    assert set(ttp.tp_param_specs(tcfg)["blocks"]) == set(tparams["blocks"])


@pytest.mark.parametrize("world", [2, 4])
def test_qkv_is_split_by_heads(model, world):
    """Rank r's qkv columns are heads [r H/W, (r+1) H/W) of each of q, k and
    v: the full projection's columns for those heads, in that order."""
    _, _, tcfg, tparams, _, _ = model
    H, hd = tcfg.n_heads, tcfg.d_model // tcfg.n_heads
    full = tparams["blocks"]["qkv"]                   # [L, D, 3D]
    Hl = H // world
    shards = [ttp.shard_params(tparams, tcfg, r, world) for r in range(world)]
    for r, shard in enumerate(shards):
        cols = [part * H * hd + h * hd + j for part in range(3)
                for h in range(r * Hl, (r + 1) * Hl) for j in range(hd)]
        assert torch.equal(shard["blocks"]["qkv"], full[:, :, cols])
        assert torch.equal(shard["blocks"]["wo"],
                           tparams["blocks"]["wo"][:, r * Hl * hd:(r + 1) * Hl * hd])
        assert shard["blocks"]["mod_w"] is tparams["blocks"]["mod_w"]
        assert shard["final_proj"] is tparams["final_proj"]
    F = int(tcfg.mlp_ratio * tcfg.d_model)
    assert torch.equal(torch.cat([s["blocks"]["w1"] for s in shards], 2),
                       tparams["blocks"]["w1"])
    assert torch.equal(torch.cat([s["blocks"]["w2"] for s in shards], 1),
                       tparams["blocks"]["w2"])
    assert shards[0]["blocks"]["w2"].shape[1] == F // world


def test_shard_params_refuses_bad_layouts(model):
    _, _, tcfg, tparams, _, _ = model
    with pytest.raises(ValueError, match="divide"):
        ttp.shard_params(tparams, tcfg, 0, 3)
    with pytest.raises(ValueError, match="rank"):
        ttp.shard_params(tparams, tcfg, 2, 2)


def test_text_conditioned_config_is_refused_by_both(model):
    """The reference's specs have no prompt leaves, so its tp_forward cannot
    take a text-conditioned config (its sharding tree does not match the
    params); the port refuses it up front with a ValueError."""
    jcfg, _, tcfg, tparams, x, _ = model
    jtext = jcfg.text_conditioned(8)
    jparams = jdit.init_params(jax.random.PRNGKey(0), jtext)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("model",))
    with pytest.raises((ValueError, TypeError)):
        with mesh:
            jtp.tp_forward(jparams, jtext, jnp.asarray(x), T_STEP, None, mesh)
    ttext = tcfg.text_conditioned(8)
    with pytest.raises(ValueError, match="text-conditioned"):
        ttp.tp_param_specs(ttext)
    with pytest.raises(ValueError, match="text-conditioned"):
        ttp.tp_forward(tparams, ttext, torch.from_numpy(x), T_STEP, None)


# ----------------------------------------------------------------------
# tp_forward on gloo ranks against the reference on XLA host devices
# ----------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.core.tensor_parallel import tp_forward
    from repro.models.diffusion import dit

    data = np.load(sys.argv[1])
    cfg = get_config("tiny-dit").reduced()
    params = jax.tree_util.tree_map(jnp.asarray, dit.nondegenerate_params(
        dit.init_params(jax.random.PRNGKey(0), cfg)))
    assert len(jax.devices()) == 4, jax.devices()
    mesh = Mesh(np.asarray(jax.devices()), ("model",))
    x, cond = jnp.asarray(data["x"]), jnp.asarray(data["cond"])
    with mesh:
        eps = jax.jit(lambda p, x: tp_forward(p, cfg, x, %d, cond, mesh))(
            params, x)
    np.save(sys.argv[2], np.asarray(eps))
    print("JAX_TP_OK")
""" % T_STEP)


def _tp_rank(ctx, path):
    """One port rank of the world of 4: TP over all four, TP over its pair
    (ranks {0, 1} and {2, 3}: two 2-way groups at once), and the planted
    contiguous-column qkv split over all four."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import tensor_parallel as tp

    data = np.load(path)
    cfg = get_config("tiny-dit").reduced()
    tree = {}
    for key in data.files:
        if key.startswith("p/"):
            node = tree
            *parts, leaf = key[2:].split("/")
            for name in parts:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    params = bridge.params_from_jax(tree, device="cpu")
    x, cond = torch.from_numpy(data["x"]), torch.from_numpy(data["cond"])
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[ctx.rank // 2]
    out = {"world4": tp.tp_forward(tp.shard_params(params, cfg, ctx.rank, 4),
                                   cfg, x, T_STEP, cond),
           "world2": tp.tp_forward(tp.shard_params(params, cfg, ctx.rank % 2, 2),
                                   cfg, x, T_STEP, cond, group=pair)}
    tp.HEAD_SPLIT = ()                      # planted: contiguous columns
    out["contiguous"] = tp.tp_forward(tp.shard_params(params, cfg, ctx.rank, 4),
                                      cfg, x, T_STEP, cond)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def tp_runs(model, tmp_path_factory):
    _, jparams, _, _, x, cond = model
    tmp = tmp_path_factory.mktemp("tp")
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = np.asarray(v)
    walk(jparams, "")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, x=x, cond=cond, **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    env.pop("STADI_HOST_DEVICES", None)
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(inputs),
                        str(tmp / "jax.npy")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0 and "JAX_TP_OK" in r.stdout, r.stderr[-3000:]
    want = np.load(tmp / "jax.npy")
    got = ranks.spawn(_tp_rank, 4, device_type="cpu", args=(str(inputs),),
                      timeout=RANK_TIMEOUT)
    return want, got


@pytest.mark.parametrize("label", ["world2", "world4"])
def test_tp_forward_matches_reference_and_single_process(model, tp_runs,
                                                         label):
    _, _, tcfg, tparams, x, cond = model
    want, got = tp_runs
    single = tdit.forward(tparams, tcfg, torch.from_numpy(x), T_STEP,
                          torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(single, want, rtol=REF_BAR, atol=REF_BAR)
    for rank_out in got:
        eps = rank_out[label]
        assert eps.shape == x.shape and np.isfinite(eps).all()
        np.testing.assert_allclose(eps, want, rtol=REF_BAR, atol=REF_BAR)
        np.testing.assert_allclose(eps, single, rtol=0.0, atol=PORT_BAR)
        np.testing.assert_array_equal(eps, got[0][label])   # same on every rank


def test_contiguous_qkv_split_fails_the_bar(model, tp_runs):
    """Contiguous columns give rank 0 all of q and part of k: the heads it
    attends with are not heads, and the forward leaves the bar far behind."""
    _, _, tcfg, tparams, x, cond = model
    _, got = tp_runs
    single = tdit.forward(tparams, tcfg, torch.from_numpy(x), T_STEP,
                          torch.from_numpy(cond)).numpy()
    err = np.abs(got[0]["contiguous"] - single).max()
    assert err > 100 * PORT_BAR, err


# ----------------------------------------------------------------------
# the deprecated shims
# ----------------------------------------------------------------------

FLAGS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize("temporal,spatial", FLAGS)
def test_stadi_infer_shim(model, temporal, spatial):
    jcfg, jparams, tcfg, tparams, x, cond = model
    speeds, knobs = [1.0, 0.5], dict(m_base=8, m_warmup=2)
    with pytest.warns(DeprecationWarning, match="stadi_infer"):
        got = tstadi.stadi_infer(tparams, tcfg, tsam.linear_schedule(100),
                                 torch.from_numpy(x), torch.from_numpy(cond),
                                 speeds, temporal=temporal, spatial=spatial,
                                 device="cpu", **knobs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jstadi.stadi_infer(jparams, jcfg, jsam.linear_schedule(100),
                                  jnp.asarray(x), jnp.asarray(cond), speeds,
                                  temporal=temporal, spatial=spatial, **knobs)
    cluster = tuple(thetero.DeviceProfile(f"dev{i}", c=v)
                    for i, v in enumerate(speeds))
    planner = tstadi._PLANNER_BY_FLAGS[(temporal, spatial)]
    assert planner == jstadi._PLANNER_BY_FLAGS[(temporal, spatial)]
    pipe = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                               tpipe.StadiConfig(cluster=cluster,
                                                 planner=planner, **knobs),
                               device="cpu")
    direct = pipe.generate(torch.from_numpy(x), torch.from_numpy(cond))
    assert torch.equal(got.image, direct.image)
    assert [dataclasses.asdict(e) for e in got.trace.events] == \
        [dataclasses.asdict(e) for e in want.trace.events]
    rel = np.linalg.norm(got.image.numpy() - np.asarray(want.image)) \
        / np.linalg.norm(np.asarray(want.image))
    assert rel < 1e-3


def test_plan_shims_warn_and_resolve_as_the_reference(model):
    jcfg, _, tcfg, _, _, _ = model
    occ = [0.0, 0.0, 0.5, 0.5]
    knobs = dict(m_base=8, m_warmup=2, num_stages=2, seq_shards=2,
                 cfg_scale=4.0)
    jconf = jpipe.StadiConfig.from_occupancies(occ, **knobs)
    tconf = tpipe.StadiConfig.from_occupancies(occ, **knobs)
    jplan = jpipe.StadiPipeline(jcfg, None, jsam.linear_schedule(100),
                                dataclasses.replace(jconf, num_stages=1,
                                                    seq_shards=1, cfg_scale=0.0)
                                ).plan()
    tplan = tpipe.StadiPipeline(tcfg, None, tsam.linear_schedule(100),
                                dataclasses.replace(tconf, num_stages=1,
                                                    seq_shards=1, cfg_scale=0.0),
                                device="cpu").plan()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = (jpipe.plan_stages(jplan, jcfg, jconf),
                jpipe.plan_seq(jplan, jcfg, jconf),
                jpipe.plan_guidance(jplan, jconf))
    with pytest.warns(DeprecationWarning, match="plan_stages"):
        stages = tpipe.plan_stages(tplan, tcfg, tconf)
    with pytest.warns(DeprecationWarning, match="plan_seq"):
        seq = tpipe.plan_seq(tplan, tcfg, tconf)
    with pytest.warns(DeprecationWarning, match="plan_guidance"):
        guidance = tpipe.plan_guidance(tplan, tconf)
    assert stages == want[0] and stages is not None
    assert dataclasses.asdict(seq) == dataclasses.asdict(want[1])
    assert dataclasses.asdict(guidance) == dataclasses.asdict(want[2])
