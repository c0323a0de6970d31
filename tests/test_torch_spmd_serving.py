"""The port's multi-rank serving lanes (the ``spmd`` stepper) on the CPU,
against the JAX package's engine: every rank of 2 gloo ranks builds the same
engine and drains the same submissions, the reference's engine runs in a
subprocess with 2 forced XLA host devices (its ``test_spmd_engine_matches_
emulated`` setup, with nondegenerate weights and staggered requests). Each
served image within 1e-3 of the reference's and of the port's lone
``emulated`` generate; the cohort groups, round reports and modeled seconds
``==``; the refusals (a guided request, replanning, no process group) raise
as the reference's do. Sizes are ``tiny-dit.reduced()`` in fp32, T = 100."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.serving import DiffusionServingEngine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_BAR = 1e-3
RANK_TIMEOUT = 240

#: label -> (exchange, exchange_refresh); requests 0, 1 at round 0, 2, 3
#: after STAGGER rounds, so two fine-step cohorts share rounds
VARIANTS = {"sync": ("sync", 2), "stale_async": ("stale_async", 2),
            "predictive": ("predictive", 2)}
STAGGER = 3
N_REQ, SLOTS = 4, 3

JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import sampler
    from repro.core.pipeline import StadiConfig, StadiPipeline
    from repro.serving import DiffusionServingEngine

    data = np.load(sys.argv[1], allow_pickle=True)
    params = {}
    for key in data.files:
        if key.startswith("p/"):
            node = params
            *path, leaf = key[2:].split("/")
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = jnp.asarray(data[key])
    assert len(jax.devices()) == 2, jax.devices()
    cfg = get_config("tiny-dit").reduced()
    sched = sampler.linear_schedule(T=100)
    variants = data["variants"].item()
    xs = data["xs"]
    out = {}

    def config(exchange, refresh, **kw):
        return StadiConfig.from_occupancies(
            [0.0, 0.5], m_base=8, m_warmup=2, backend="spmd",
            exchange=exchange, exchange_refresh=refresh, **kw)

    for label, (exchange, refresh) in variants.items():
        engine = DiffusionServingEngine(StadiPipeline(
            cfg, params, sched, config(exchange, refresh)), slots=%d)
        groups = []
        orig = engine._groups

        def record(lanes, orig=orig, groups=groups):
            got = orig(lanes)
            groups.append([(list(map(int, g)), tuple(i)) for g, i in got])
            return got
        engine._groups = record
        reqs = []
        for i in range(%d):
            if i == 2:
                for _ in range(%d):
                    engine.step()
            reqs.append(engine.submit(jnp.asarray(xs[i]), i, slo_s=0.1))
        engine.run_to_completion()
        out[label] = dict(
            images=[np.asarray(r.image) for r in reqs],
            reports=[(r.admitted, r.warmup_lanes, r.adaptive_lanes,
                      r.exchange_kinds, r.placement, r.modeled_s)
                     for r in engine.rounds],
            groups=groups,
            latency=[r.modeled_latency_s for r in reqs])
    errors = []
    pipe = StadiPipeline(cfg, params, sched, config("sync", 2))
    try:
        DiffusionServingEngine(pipe, slots=2).submit(
            jnp.asarray(xs[0]), 1, cfg_scale=3.0)
    except ValueError as e:
        errors.append(str(e))
    try:
        DiffusionServingEngine(pipe, slots=2, rebalance_every=1)
    except ValueError as e:
        errors.append(str(e))
    try:
        DiffusionServingEngine(StadiPipeline(cfg, params, sched, config(
            "sync", 2, cfg_scale=3.0)), slots=2)
    except ValueError as e:
        errors.append(str(e))
    out["errors"] = errors
    np.save(sys.argv[2], np.array(out, dtype=object), allow_pickle=True)
    print("JAX_SPMD_SERVE_OK")
""" % (SLOTS, N_REQ, STAGGER))


def _load(path):
    data = np.load(path, allow_pickle=True)
    tree = {}
    for key in data.files:
        if key.startswith("p/"):
            node = tree
            *parts, leaf = key[2:].split("/")
            for name in parts:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return data, bridge.params_from_jax(tree, device="cpu")


def _config(exchange, refresh, **kw):
    return tpipe.StadiConfig.from_occupancies(
        [0.0, 0.5], m_base=8, m_warmup=2, backend="spmd", exchange=exchange,
        exchange_refresh=refresh, **kw)


def _serve_rank(ctx, path):
    """One port rank: the same engine and submissions for each variant, the
    groups its rounds formed, and this rank's padded (K2) forwards; then
    the refusals inside the process group."""
    from repro_torch.configs import get_config

    torch.set_num_threads(1)
    data, params = _load(path)
    cfg = get_config("tiny-dit").reduced()
    sched = tsam.linear_schedule(100)
    xs = data["xs"]
    out = {}
    for label, (exchange, refresh) in VARIANTS.items():
        engine = DiffusionServingEngine(tpipe.StadiPipeline(
            cfg, params, sched, _config(exchange, refresh), device="cpu"),
            slots=SLOTS)
        groups = []
        orig = engine._groups

        def record(lanes, orig=orig, groups=groups):
            got = orig(lanes)
            groups.append([(list(g), tuple(i)) for g, i in got])
            return got
        engine._groups = record
        reqs = []
        for i in range(N_REQ):
            if i == 2:
                for _ in range(STAGGER):
                    engine.step()
            reqs.append(engine.submit(torch.from_numpy(xs[i]), i, slo_s=0.1))
        engine.run_to_completion()
        out[label] = dict(
            images=[r.image.numpy() for r in reqs],
            reports=[(r.admitted, r.warmup_lanes, r.adaptive_lanes,
                      r.exchange_kinds, r.placement, r.modeled_s)
                     for r in engine.rounds],
            groups=groups, latency=[r.modeled_latency_s for r in reqs],
            dispatches=dict(engine.stats()["dispatches"]))
    errors = []
    pipe = tpipe.StadiPipeline(cfg, params, sched, _config("sync", 2),
                               device="cpu")
    try:
        DiffusionServingEngine(pipe, slots=2).submit(
            torch.from_numpy(xs[0]), 1, cfg_scale=3.0)
    except ValueError as e:
        errors.append(str(e))
    try:
        DiffusionServingEngine(pipe, slots=2, rebalance_every=1)
    except ValueError as e:
        errors.append(str(e))
    try:
        DiffusionServingEngine(tpipe.StadiPipeline(
            cfg, params, sched, _config("sync", 2, cfg_scale=3.0),
            device="cpu"), slots=2)
    except ValueError as e:
        errors.append(str(e))
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = jax_get_config("tiny-dit").reduced()
    jparams = jdit.nondegenerate_params(jdit.init_params(jax.random.PRNGKey(0),
                                                         jcfg))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = np.asarray(v)
    walk(jax.tree_util.tree_map(np.asarray, jparams), "")
    rng = np.random.default_rng(17)
    tmp = tmp_path_factory.mktemp("spmd_serving")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, xs=rng.standard_normal(
        (N_REQ, 1, jcfg.latent_size, jcfg.latent_size, jcfg.channels)
        ).astype(np.float32), variants=np.array(VARIANTS, dtype=object),
        **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                         "--xla_cpu_multi_thread_eigen=false")
    env.pop("STADI_HOST_DEVICES", None)
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(inputs),
                        str(tmp / "jax.npy")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0 and "JAX_SPMD_SERVE_OK" in r.stdout, \
        r.stderr[-3000:]
    want = np.load(tmp / "jax.npy", allow_pickle=True).item()
    got = ranks.spawn(_serve_rank, 2, device_type="cpu",
                      args=(str(inputs),), timeout=RANK_TIMEOUT)
    return want, got, inputs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("label", list(VARIANTS))
def test_spmd_engine_matches_reference_and_emulated(runs, label):
    """Every rank's served images lie within 1e-3 of the reference engine's
    and of the port's lone emulated generate of each request."""
    want, got, inputs = runs
    data, params = _load(inputs)
    exchange, refresh = VARIANTS[label]
    emu = tpipe.StadiPipeline(
        DiTConfig(**dataclasses.asdict(jax_get_config("tiny-dit").reduced())),
        params, tsam.linear_schedule(100),
        dataclasses.replace(_config(exchange, refresh), backend="emulated"),
        device="cpu")
    lone = [emu.generate(torch.from_numpy(data["xs"][i]),
                         torch.tensor([i])).image.numpy()
            for i in range(N_REQ)]
    for rank_out in got:
        for i, img in enumerate(rank_out[label]["images"]):
            assert _rel(img, want[label]["images"][i]) < REL_BAR, (label, i)
            assert _rel(img, lone[i]) < REL_BAR, (label, i)


@pytest.mark.parametrize("label", list(VARIANTS))
def test_spmd_cohort_groups_and_rounds_match_reference(runs, label):
    """The cohorts (lanes grouped by fine step), their interval info, the
    round reports and the modeled latencies equal the reference's on every
    rank; rounds where two cohorts coexist exist; each rank ran one padded
    forward per substep of its worker's ratio."""
    want, got, _ = runs
    w = want[label]
    for rank_out in got:
        g = rank_out[label]
        assert g["groups"] == w["groups"]
        assert g["reports"] == w["reports"]
        assert g["latency"] == w["latency"]
    assert any(len(rnd) > 1 for rnd in w["groups"])
    # worker ratios [1, 2] at R = 2: rank 0 runs 2 substeps an interval,
    # rank 1 one
    cohorts = sum(len(rnd) for rnd in w["groups"])
    assert [r[label]["dispatches"]["padded"] for r in got] == \
        [2 * cohorts, cohorts]


def test_spmd_engine_refusals_match_reference(runs):
    """A guided request, replanning and a guided plan are refused with the
    reference's messages; outside a process group the stepper refuses to
    build."""
    want, got, _ = runs
    for rank_out in got:
        assert rank_out["errors"] == want["errors"]
    assert len(want["errors"]) == 3
    assert "has no guided serving stepper" in want["errors"][0]
    assert "cohort-only" in want["errors"][1]
    cfg = DiTConfig(**dataclasses.asdict(jax_get_config("tiny-dit").reduced()))
    from repro_torch.models.diffusion import dit
    params = dit.init_params(torch.Generator().manual_seed(0), cfg)
    pipe = tpipe.StadiPipeline(cfg, params, tsam.linear_schedule(100),
                               _config("sync", 2), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        DiffusionServingEngine(pipe, slots=2)


def test_serve_cli_spmd_on_cpu_ranks():
    """``serve --diffusion --backend spmd`` starts its ranks and drains the
    requests on each; rank 0's finite images come back."""
    from repro_torch.launch import serve
    done = serve.main(["--diffusion", "--backend", "spmd", "--device", "cpu",
                       "--occupancies", "0.0,0.5", "--m-base", "4",
                       "--m-warmup", "2", "--requests", "3", "--slots", "2"])
    assert len(done) == 3
    assert all(bool(torch.isfinite(r.image).all()) for r in done)
