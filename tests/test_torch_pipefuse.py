"""The displaced stage chain of the port (DESIGN.md §11) against the JAX
package, on the CPU: the StageShift lowering, the ``stadi_pipefuse`` plans
and the staged modeled seconds (all ``==``), ``displaced_step`` (fp32 atol 1e-5), ``run_pipefuse`` (bitwise the port's
``emulated`` backend at one stage; within ``REL_BAR`` of the reference's
image at two stages, unguided, fused and interleaved), ``run_spmd_pipefuse``
on 2 gloo ranks against the reference's on 2 XLA host devices (within
``REL_BAR``, and bitwise the port's emulated chain), and the pipefuse
serving lanes against the reference's engine on the same submissions (round
reports, placements and modeled seconds ``==``, images atol 1e-5; the
reference's own bitwise check of its engine fails under jax 0.9.0, so the
port is held to tolerance). Sizes are ``tiny-dit.reduced()`` in fp32 with T
= 100.

The weights are the nondegenerate ones with the blocks' adaLN modulation
scaled by ``GAIN``, so that attention, and with it the displaced context,
moves the image: the chain's drift from the one-stage image is then about
1e-2 relative, and each planted fault of the chain (``CHAIN_FAULTS``) moves
the image by 1e-3 or more, while the port reads within 2e-7 of the
reference. ``REL_BAR`` lies between the two."""
import dataclasses
import inspect
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
from repro.core import comm as jcomm  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import hetero as jhetero  # noqa: E402
from repro.core import pipefuse as jpf  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import planners as jplanners  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core.guidance import GuidancePlan as JGuidancePlan  # noqa: E402
from repro.core.schedule import TemporalPlan as JTemporalPlan  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro.serving import DiffusionServingEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import hetero as thetero  # noqa: E402
from repro_torch.core import pipefuse as tpf  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import planners as tplanners  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.guidance import GuidancePlan  # noqa: E402
from repro_torch.core.schedule import TemporalPlan  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models.diffusion import dit as tdit  # noqa: E402
from repro_torch.serving import DiffusionServingEngine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORWARD_BAR = dict(rtol=0.0, atol=1e-5)
#: image bar against the reference: 2e-7 read, 1e-3 the least planted fault
REL_BAR = 1e-5
ATOL = 1e-5
#: scale of the blocks' modulation weights over nondegenerate_params' 0.02
GAIN = 15.0
RANK_TIMEOUT = 240


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
    return (jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)), np_params,
            bridge.params_from_jax(np_params, device="cpu"))


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


# ----------------------------------------------------------------------
# the IR, the planner and the staged cost model: ==
# ----------------------------------------------------------------------

LOWER_CASES = [("sync", 2, [1, 1]), ("stale_async", 3, [1, 1]),
               ("predictive", 2, [2, 1, 1]), ("sync", 2, [4])]


@pytest.mark.parametrize("exchange,refresh,stages", LOWER_CASES)
def test_stageshift_lowering_matches_reference(exchange, refresh, stages):
    """The event stream and the replayed records (fill flags) equal the
    reference's, guided split plans included; a one-stage partition emits
    no StageShift."""
    tp = TemporalPlan([16, 8], [1, 2], [False, False], 16, 4)
    jp = JTemporalPlan([16, 8], [1, 2], [False, False], 16, 4)
    tpol = tcomm.get_exchange(exchange, refresh)
    jpol = jcomm.get_exchange(exchange, refresh)
    for tg, jg in ((None, None),
                   (GuidancePlan("interleaved", 3.0, (0,), (1,)),
                    JGuidancePlan("interleaved", 3.0, (0,), (1,)))):
        got = list(tev.lower(tp, [5, 3], tpol, stages=stages, guidance=tg))
        want = list(jev.lower(jp, [5, 3], jpol, stages=stages, guidance=jg))
        assert _plain(got) == _plain(want)
        assert any(isinstance(e, tev.StageShift) for e in got) == \
            (len(stages) > 1)
        assert _plain(tev.replay(tp, [5, 3], tpol, stages=stages,
                                 guidance=tg)) == \
            _plain(jev.replay(jp, [5, 3], jpol, stages=stages, guidance=jg))


def _knobs(pkg, hetero, occ, **kw):
    return pkg.StadiConfig.from_occupancies(occ, m_base=16, m_warmup=4,
                                            depth=28, **kw)


PLAN_CASES = {
    "degenerate": ([0.0, 0.5], dict(num_stages=1)),
    "forced": ([0.0, 0.5], dict(num_stages=2)),
    "forced_micro": ([0.0, 0.3, 0.6], dict(num_stages=3, micro_patches=5)),
    "auto": ([0.0, 0.8, 0.8], dict(num_stages=0, cost_model="cm")),
    "auto_default_cost": ([0.0, 0.2, 0.5, 0.7], dict(num_stages=0)),
}


@pytest.mark.parametrize("label", list(PLAN_CASES))
def test_stadi_pipefuse_plans_match_reference(label):
    """The joint (steps, patches, stage split) search returns the
    reference's plan, cost included: the patch fallback at one stage, a
    pinned chain, a pinned micro-batch count and the auto search (which
    re-admits devices STADI's tiers drop)."""
    occ, kw = PLAN_CASES[label]
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("cost_model") == "cm":
        tkw["cost_model"] = tsim.CostModel(t_fixed=1e-4, t_row=1e-3)
        jkw["cost_model"] = jsim.CostModel(t_fixed=1e-4, t_row=1e-3)
    tk = _knobs(tpipe, thetero, occ, **tkw)
    jk = _knobs(jpipe, jhetero, occ, **jkw)
    got = tplanners.get_planner("stadi_pipefuse")(tk.speeds, tk, 32)
    want = jplanners.get_planner("stadi_pipefuse")(jk.speeds, jk, 32)
    assert _plain(got) == _plain(want)
    if label in ("forced", "forced_micro", "auto"):
        assert got.stages is not None and sum(got.stages) == 28


def test_stadi_pipefuse_infeasible_and_resolved_stages(model):
    """An infeasible pinned chain raises in both packages, and a plain
    planner's ``num_stages`` resolves to the reference's split."""
    tk = _knobs(tpipe, thetero, [0.0, 0.5], num_stages=9)
    jk = _knobs(jpipe, jhetero, [0.0, 0.5], num_stages=9)
    for planner, k in ((tplanners, tk), (jplanners, jk)):
        with pytest.raises(ValueError, match="infeasible"):
            planner.get_planner("stadi_pipefuse")(k.speeds, k, 32)
    jcfg, jparams, tcfg, _, tparams = model
    occ = [0.0, 0.3, 0.6]
    tconf = tpipe.StadiConfig.from_occupancies(occ, m_base=8, m_warmup=2,
                                               backend="pipefuse",
                                               num_stages=2)
    jconf = jpipe.StadiConfig.from_occupancies(occ, m_base=8, m_warmup=2,
                                               backend="pipefuse",
                                               num_stages=2)
    got = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100), tconf,
                              device="cpu").plan()
    want = jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                               jconf).plan()
    assert got.stages == want.stages == [1, 1]
    assert got.patches == want.patches
    assert _plain(got.temporal)[1] == _plain(want.temporal)[1]
    with pytest.raises(ValueError, match="infeasible"):
        tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                            dataclasses.replace(tconf, num_stages=4),
                            device="cpu").plan()


SIM_CASES = [("sync", 2, None), ("stale_async", 3, None),
             ("sync", 2, "fused")]


@pytest.mark.parametrize("exchange,refresh,guided", SIM_CASES)
def test_staged_simulation_matches_reference(exchange, refresh, guided):
    """Staged traces and their modeled seconds equal the reference's, as do
    the stage-chain helpers the serving engine shares."""
    cfg_t = DiTConfig(**dataclasses.asdict(jax_get_config("sdxl-dit")))
    cfg_j = jax_get_config("sdxl-dit")
    tp = TemporalPlan([16] * 4, [1] * 4, [False] * 4, 16, 4)
    jp = JTemporalPlan([16] * 4, [1] * 4, [False] * 4, 16, 4)
    tg = GuidancePlan("fused", 4.0) if guided else None
    jg = JGuidancePlan("fused", 4.0) if guided else None
    speeds = [1.0, 0.5, 0.8]
    cm = dict(t_fixed=45e-3, t_row=2e-4, link_bw=25e9)
    tt = tsim.build_trace(tp, [8] * 4, cfg_t, batch=1, exchange=exchange,
                          exchange_refresh=refresh, stages=[16, 12],
                          guidance=tg)
    jt = jsim.build_trace(jp, [8] * 4, cfg_j, batch=1, exchange=exchange,
                          exchange_refresh=refresh, stages=[16, 12],
                          guidance=jg)
    assert _plain(tt.events) == _plain(jt.events)
    assert (tt.stages, tt.act_row_bytes, tt.latent_bytes) == \
        (jt.stages, jt.act_row_bytes, jt.latent_bytes)
    assert tsim.simulate_trace(tt, speeds, tsim.CostModel(**cm)) == \
        jsim.simulate_trace(jt, speeds, jsim.CostModel(**cm))
    chain = tsim.chain_speeds(speeds, 2)
    assert chain == jsim.chain_speeds(speeds, 2)
    tasks = [(2, 8.0), (1, 8.0)]
    tcm, jcm = tsim.CostModel(**cm), jsim.CostModel(**cm)
    assert tsim.pipefuse_interval_seconds([16, 12], chain, tcm, tasks, True,
                                          "full", 1e6, 4e3) == \
        jsim.pipefuse_interval_seconds([16, 12], chain, jcm, tasks, True,
                                       "full", 1e6, 4e3)
    assert tsim.pipefuse_warmup_seconds([16, 12], chain, tcm, 32, 4e3) == \
        jsim.pipefuse_warmup_seconds([16, 12], chain, jcm, 32, 4e3)


# ----------------------------------------------------------------------
# displaced_step: fp32 atol 1e-5
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bounds", [((0, 1), (1, 2)), ((0, 2),)])
def test_displaced_step_matches_reference(model, bounds):
    """One micro-task through the chain: eps, fresh K/V and the updated
    contexts (the port writes them in place) against the reference's."""
    jcfg, jparams, tcfg, _, tparams = model
    rng = np.random.default_rng(9)
    L, H = jcfg.n_layers, jcfg.n_heads
    hd = jcfg.d_model // H
    x = rng.standard_normal((2, 3 * jcfg.patch_size, jcfg.latent_size,
                             jcfg.channels)).astype(np.float32)
    ck, cv = (rng.standard_normal((L, 2, jcfg.n_tokens, H, hd))
              .astype(np.float32) for _ in range(2))
    cond = np.array([1, 2])
    want = jpf.displaced_step(jparams, jcfg, jnp.asarray(x), 40,
                              jnp.asarray(cond), 3, jnp.asarray(ck),
                              jnp.asarray(cv), bounds)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = tpf.displaced_step(tparams, tcfg, torch.from_numpy(x), 40,
                             torch.from_numpy(cond), 3, tck, tcv, bounds)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FORWARD_BAR)
    assert got[3] is tck                      # the context, written in place


# ----------------------------------------------------------------------
# run_pipefuse
# ----------------------------------------------------------------------

#: label -> (occupancies, planner, extra config knobs)
RUN_CASES = {
    "unguided": ([0.0, 0.5], "stadi", dict()),
    "stale_async": ([0.0, 0.5], "stadi", dict(exchange="stale_async")),
    "fused": ([0.0, 0.5], "stadi", dict(cfg_scale=3.0)),
    "interleaved": ([0.0, 0.0, 0.5, 0.5], "stadi_guidance",
                    dict(cfg_scale=3.0, guidance="interleaved")),
    # two fast workers: a worker's last substep differs from its interval
    # start, and skip boundaries keep the pipe full (the faults' case)
    "three_workers": ([0.0, 0.0, 0.5], "stadi", dict(exchange="stale_async")),
}


def _inputs(jcfg, B=1, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, jcfg.latent_size, jcfg.latent_size,
                             jcfg.channels)).astype(np.float32)
    return x, np.arange(1, B + 1)


def _generate_both(model, occ, planner, knobs, num_stages):
    jcfg, jparams, tcfg, _, tparams = model
    x, cond = _inputs(jcfg)
    kw = dict(m_base=8, m_warmup=2, planner=planner, backend="pipefuse",
              num_stages=num_stages, **knobs)
    t = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                            tpipe.StadiConfig.from_occupancies(occ, **kw),
                            device="cpu").generate(torch.from_numpy(x),
                                                   torch.from_numpy(cond))
    j = jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                            jpipe.StadiConfig.from_occupancies(occ, **kw)
                            ).generate(jnp.asarray(x), jnp.asarray(cond))
    return t, j


@pytest.mark.parametrize("label", ["unguided", "fused", "interleaved"])
def test_run_pipefuse_one_stage_is_emulated_bitwise(model, label):
    """At one stage the pipefuse backend IS the emulated one (bitwise); its
    trace names the one stage of all blocks."""
    jcfg, _, tcfg, _, tparams = model
    occ, planner, knobs = RUN_CASES[label]
    x, cond = _inputs(jcfg)
    imgs = {}
    for backend in ("emulated", "pipefuse"):
        conf = tpipe.StadiConfig.from_occupancies(
            occ, m_base=8, m_warmup=2, planner=planner, backend=backend,
            **knobs)
        res = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                                  conf, device="cpu").generate(
            torch.from_numpy(x), torch.from_numpy(cond))
        imgs[backend] = res
    assert torch.equal(imgs["pipefuse"].image, imgs["emulated"].image)
    assert imgs["pipefuse"].trace.stages == [tcfg.n_layers]
    assert _plain(imgs["pipefuse"].trace.events) == \
        _plain(imgs["emulated"].trace.events)


@pytest.mark.parametrize("label", list(RUN_CASES))
def test_run_pipefuse_matches_reference(model, label):
    """Two stages: the image within REL_BAR of the reference's, the trace
    (fill flags included) and the modeled seconds' inputs equal; the
    displaced contract moves the image off the one-stage run by far more
    than the bar."""
    occ, planner, knobs = RUN_CASES[label]
    t, j = _generate_both(model, occ, planner, knobs, num_stages=2)
    assert t.plan.stages == j.plan.stages == [1, 1]
    assert _rel(t.image.numpy(), j.image) < REL_BAR
    assert _plain(t.trace.events) == _plain(j.trace.events)
    assert any(e.fill for e in t.trace.events)
    t1, _ = _generate_both(model, occ, planner, knobs, num_stages=1)
    assert _rel(t.image, t1.image) > 100 * REL_BAR


#: planted faults of the chain: (the text of run_pipefuse replaced, by)
CHAIN_FAULTS = {
    # micro-tasks worker by worker: a worker's later substeps run before the
    # other workers' earlier ones reach the contexts
    "worker_major": (
        "            for f in range(ev.length):             # substep-major "
        "micro order\n                for i in ev.workers:\n",
        "            for i in ev.workers:\n"
        "                for f in range(ev.length):\n"),
    # the pipe fills once, entering the adaptive phase, and never again
    "no_refill": ("elif isinstance(ev, ir.StageShift):",
                  "elif isinstance(ev, ir.StageShift) and ctx_k is None:"),
    # the contexts restart from the published K/V at every interval
    "refill_every_interval": (
        "            interval = ev\n",
        "            interval = ev\n            if S > 1:\n"
        "                ctx_k, ctx_v = published.k.clone(), "
        "published.v.clone()\n"),
}


def _planted_run_pipefuse(fault):
    """``run_pipefuse`` with one of ``CHAIN_FAULTS`` planted in its text."""
    text, planted = CHAIN_FAULTS[fault]
    src = inspect.getsource(tpf.run_pipefuse)
    assert src.count(text) == 1, fault
    namespace = dict(vars(tpf))
    exec(compile(src.replace(text, planted), tpf.__file__, "exec"), namespace)
    return namespace["run_pipefuse"]


@pytest.mark.parametrize("fault", list(CHAIN_FAULTS))
def test_image_bar_rejects_planted_chain_faults(model, fault):
    """Each planted fault of the stage chain puts the image past REL_BAR
    from the reference's, on the case where every fault changes what a
    micro-task reads."""
    _, _, tcfg, _, tparams = model
    occ, planner, knobs = RUN_CASES["three_workers"]
    t, j = _generate_both(model, occ, planner, knobs, num_stages=2)
    x, cond = _inputs(tcfg)
    bad = _planted_run_pipefuse(fault)(
        tparams, tcfg, tsam.linear_schedule(100), torch.from_numpy(x),
        torch.from_numpy(cond), t.plan.temporal, t.plan.patches,
        t.plan.stages, exchange=knobs["exchange"])
    assert _rel(t.image.numpy(), j.image) < REL_BAR
    assert _rel(bad.image.numpy(), j.image) > 10 * REL_BAR, fault


def test_run_pipefuse_refusals(model):
    _, _, tcfg, _, tparams = model
    sched = tsam.linear_schedule(100)
    x, plan = torch.zeros(1, 16, 16, 3), TemporalPlan([8], [1], [False], 8, 2)
    with pytest.raises(ValueError, match="cover all"):
        tpf.run_pipefuse(tparams, tcfg, sched, x, torch.tensor([1]), plan,
                         [8], [1])
    with pytest.raises(ValueError, match="rebalancing"):
        tpf.run_pipefuse(tparams, tcfg, sched, x, torch.tensor([1]), plan,
                         [8], [1, 1], interval_hook=lambda *a: None)
    with pytest.raises(ValueError, match="class condition"):
        tpf.run_pipefuse(tparams, tcfg, sched, x, None, plan, [8], [1, 1],
                         guidance=GuidancePlan("fused", 2.0))
    conf = tpipe.StadiConfig.from_occupancies([0.0, 0.5], m_base=8,
                                              m_warmup=2, num_stages=2,
                                              backend="spmd_pipefuse",
                                              cfg_scale=2.0)
    with pytest.raises(ValueError, match="guided backend"):
        tpipe.StadiPipeline(tcfg, tparams, sched, conf, device="cpu").generate(
            x, torch.tensor([1]))


# ----------------------------------------------------------------------
# run_spmd_pipefuse: port on 2 gloo ranks vs reference on 2 devices
# ----------------------------------------------------------------------

SPMD_EXCHANGES = ("sync", "stale_async")

JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import sampler, spmd
    from repro.core.schedule import TemporalPlan

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
    plan = TemporalPlan(**data["plan"].item())
    out = {}
    for exchange in data["exchanges"]:
        img = spmd.run_spmd_pipefuse(params, cfg, sched,
                                     jnp.asarray(data["x_T"]),
                                     jnp.asarray(data["cond"]), plan,
                                     list(data["patches"]), [1, 1],
                                     exchange=str(exchange))
        out[str(exchange)] = np.asarray(img)
    np.savez(sys.argv[2], **out)
    print("JAX_SPMD_PIPEFUSE_OK")
""")

SPMD_PLAN = dict(steps=[8, 8, 8], ratios=[1, 1, 1], excluded=[False] * 3,
                 m_base=8, m_warmup=2)
SPMD_PATCHES = [3, 3, 2]


def _spmd_pipefuse_rank(ctx, path):
    """One port rank: every exchange kind, the chain's handoffs and
    broadcasts, and the block forwards this rank ran (its own stage's
    only)."""
    from repro_torch.configs import get_config
    from repro_torch.core import comm, sampler, spmd
    from repro_torch.models.diffusion import dit

    torch.set_num_threads(1)
    data = np.load(path, allow_pickle=True)
    tree = {}
    for key in data.files:
        if key.startswith("p/"):
            node = tree
            *parts, leaf = key[2:].split("/")
            for name in parts:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    params = bridge.params_from_jax(tree, device="cpu")
    cfg = get_config("tiny-dit").reduced()
    blocks = {"n": 0}
    block_stack = dit.block_stack

    def counting(blk, *a, **kw):
        blocks["n"] += blk["qkv"].shape[0]
        return block_stack(blk, *a, **kw)

    dit.block_stack = counting
    calls = {}
    for name in ("stage_handoff", "chain_broadcast"):
        def counted(*a, _name=name, _fn=getattr(comm, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(comm, name, counted)
    out = {}
    for exchange in data["exchanges"]:
        blocks["n"] = 0
        calls.update(stage_handoff=0, chain_broadcast=0)
        img = spmd.run_spmd_pipefuse(
            params, cfg, sampler.linear_schedule(T=100),
            torch.from_numpy(data["x_T"]), torch.from_numpy(data["cond"]),
            TemporalPlan(**data["plan"].item()), list(data["patches"]),
            [1, 1], exchange=str(exchange))
        out[str(exchange)] = (img.numpy(), blocks["n"], dict(calls))
    return out


@pytest.fixture(scope="module")
def spmd_pipefuse_runs(model, tmp_path_factory):
    _, _, _, np_params, _ = model
    tmp = tmp_path_factory.mktemp("spmd_pipefuse")
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = np.asarray(v)
    walk(np_params, "")
    rng = np.random.default_rng(4)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, x_T=rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
             cond=np.array([1, 2]), plan=np.array(SPMD_PLAN, dtype=object),
             patches=np.array(SPMD_PATCHES), exchanges=np.array(SPMD_EXCHANGES),
             **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                         "--xla_cpu_multi_thread_eigen=false")
    env.pop("STADI_HOST_DEVICES", None)
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(inputs),
                        str(tmp / "jax.npz")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0 and "JAX_SPMD_PIPEFUSE_OK" in r.stdout, \
        r.stderr[-3000:]
    want = dict(np.load(tmp / "jax.npz"))
    got = ranks.spawn(_spmd_pipefuse_rank, 2, device_type="cpu",
                      args=(str(inputs),), timeout=RANK_TIMEOUT)
    return want, got, inputs


@pytest.mark.parametrize("exchange", SPMD_EXCHANGES)
def test_spmd_pipefuse_matches_reference(model, spmd_pipefuse_runs, exchange):
    """Every rank returns the reference's image (within REL_BAR) and,
    bitwise, the port's emulated pipefuse image; each rank ran its own
    stage's block only, on one full-depth forward per warm-up step and one
    block per micro-task, and the chain handed off once a micro-task."""
    want, got, inputs = spmd_pipefuse_runs
    _, _, tcfg, _, tparams = model
    data = np.load(inputs, allow_pickle=True)
    emu = tpf.run_pipefuse(tparams, tcfg, tsam.linear_schedule(100),
                           torch.from_numpy(data["x_T"]),
                           torch.from_numpy(data["cond"]),
                           TemporalPlan(**SPMD_PLAN), SPMD_PATCHES, [1, 1],
                           exchange=exchange).image.numpy()
    micro = (SPMD_PLAN["m_base"] - SPMD_PLAN["m_warmup"]) * len(SPMD_PATCHES)
    for rank_out in got:
        img, blocks, calls = rank_out[exchange]
        assert _rel(img, want[exchange]) < REL_BAR
        np.testing.assert_array_equal(img, emu)
        assert blocks == SPMD_PLAN["m_warmup"] * tcfg.n_layers + micro
        assert calls == {"stage_handoff": micro, "chain_broadcast": micro}


def _mismatch_rank(ctx):
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    cfg = get_config("tiny-dit").reduced()
    try:
        spmd.run_spmd_pipefuse({}, cfg, tsam.linear_schedule(100),
                               torch.zeros(1, 16, 16, 3), torch.tensor([1]),
                               TemporalPlan([8], [1], [False], 8, 2), [8],
                               [1, 1])
    except ValueError as e:
        return str(e)


def test_spmd_pipefuse_needs_one_rank_per_stage():
    (msg,) = ranks.spawn(_mismatch_rank, 1, device_type="cpu",
                         timeout=RANK_TIMEOUT)
    assert "one rank per stage: 2 stages, 1 ranks" in msg


# ----------------------------------------------------------------------
# the pipefuse serving lanes against the reference's engine
# ----------------------------------------------------------------------

def _configs(num_stages, **kw):
    kw = dict(m_base=8, m_warmup=2, backend="pipefuse", num_stages=num_stages,
              **kw)
    return (tpipe.StadiConfig.from_occupancies([0.0, 0.5], **kw),
            jpipe.StadiConfig.from_occupancies([0.0, 0.5], **kw))


def _report(r):
    return (r.admitted, r.warmup_lanes, r.adaptive_lanes, r.exchange_kinds,
            r.placement, r.modeled_s)


@pytest.mark.parametrize("exchange", ["sync", "stale_async"])
def test_pipefuse_engine_matches_reference(model, exchange):
    """Two stages, 2 slots, 4 staggered requests: round reports, stage
    placements and modeled seconds equal the reference engine's, images
    within atol 1e-5 of the reference's and of the port's lone pipefuse
    generate."""
    jcfg, jparams, tcfg, _, tparams = model
    tconf, jconf = _configs(2, exchange=exchange)
    tpipe_ = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100),
                                 tconf, device="cpu")
    te = DiffusionServingEngine(tpipe_, slots=2)
    je = JEngine(jpipe.StadiPipeline(jcfg, jparams,
                                     jsam.linear_schedule(T=100), jconf),
                 slots=2)
    rng = np.random.default_rng(21)
    xs = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
          for _ in range(4)]
    pairs = []
    for i, x in enumerate(xs):
        if i == 2:
            for _ in range(3):
                te.step()
                je.step()
        pairs.append((te.submit(torch.from_numpy(x), i, slo_s=0.1),
                      je.submit(jnp.asarray(x), i, slo_s=0.1)))
    te.run_to_completion()
    je.run_to_completion()
    assert te.stages == je.stages == [1, 1]
    assert [_report(r) for r in te.rounds] == [_report(r) for r in je.rounds]
    assert all(r.placement == ((0, 0), (1, 1)) for r in te.rounds
               if r.adaptive_lanes)
    for i, (t, j) in enumerate(pairs):
        np.testing.assert_allclose(t.image.numpy(), np.asarray(j.image),
                                   rtol=0, atol=ATOL)
        lone = tpipe_.generate(torch.from_numpy(xs[i]),
                               torch.tensor([i])).image
        torch.testing.assert_close(t.image, lone, rtol=0, atol=ATOL)
        assert (t.modeled_latency_s, t.slo_met) == \
            (j.modeled_latency_s, j.slo_met)
    stats = te.stats()
    assert stats["dispatches"]["plain"] > 0


def test_pipefuse_engine_one_stage_is_the_emulated_engine(model):
    """At one stage the pipefuse stepper IS the emulated one: the same
    images (bitwise: the same dispatches) and the same round reports, and
    it serves guided lanes."""
    _, _, tcfg, _, tparams = model
    rng = np.random.default_rng(33)
    xs = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
          for _ in range(3)]
    out = {}
    for backend in ("emulated", "pipefuse"):
        conf = tpipe.StadiConfig.from_occupancies([0.0, 0.5], m_base=8,
                                                  m_warmup=2, backend=backend)
        eng = DiffusionServingEngine(tpipe.StadiPipeline(
            tcfg, tparams, tsam.linear_schedule(100), conf, device="cpu"),
            slots=2)
        reqs = [eng.submit(torch.from_numpy(x), i,
                           cfg_scale=3.0 if i == 1 else None)
                for i, x in enumerate(xs)]
        eng.run_to_completion()
        out[backend] = ([r.image for r in reqs],
                        [_report(r) for r in eng.rounds])
    assert out["pipefuse"][1] == out["emulated"][1]
    for a, b in zip(out["pipefuse"][0], out["emulated"][0]):
        assert torch.equal(a, b)


def test_pipefuse_engine_refusals_match_reference(model):
    """Guided lanes at S > 1, seq sharding with stages and replanning of a
    staged plan are refused with the reference's messages."""
    jcfg, jparams, tcfg, _, tparams = model
    tconf, jconf = _configs(2)
    mk_t = lambda conf, **kw: DiffusionServingEngine(tpipe.StadiPipeline(
        tcfg, tparams, tsam.linear_schedule(100), conf, device="cpu"), **kw)
    mk_j = lambda conf, **kw: JEngine(jpipe.StadiPipeline(
        jcfg, jparams, jsam.linear_schedule(T=100), conf), **kw)
    msgs = []
    for mk, conf in ((mk_t, tconf), (mk_j, jconf)):
        got = []
        with pytest.raises(ValueError) as e:
            mk(conf).submit(np.zeros((16, 16, 3), np.float32)
                            if mk is mk_j else torch.zeros(16, 16, 3), 1,
                            cfg_scale=3.0)
        got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            mk(dataclasses.replace(conf, cfg_scale=3.0))
        got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            mk(conf, rebalance_every=1)
        got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    assert "single-stage 'pipefuse'" in msgs[0][0]
    seq = dataclasses.replace(tconf, seq_shards=2, backend="pipefuse")
    with pytest.raises(ValueError, match="seq backend"):
        mk_t(seq)


def test_cli_stage_chain_forms_on_cpu():
    """``stadi_infer --num-stages 2 --backend spmd_pipefuse`` starts one
    gloo rank per stage and holds their image to the emulated chain;
    ``serve --diffusion --backend pipefuse --num-stages 2`` serves the
    chain's lanes. Neither flag names a later slice any more."""
    from repro_torch.launch import serve, stadi_infer
    out = stadi_infer.main(["--device", "cpu", "--reduced", "--m-base", "8",
                            "--m-warmup", "2", "--num-stages", "2",
                            "--backend", "spmd_pipefuse",
                            "--check-vs-emulation"])
    assert out["ranks"] == 2 and out["finite"]
    assert out["rel_err_vs_emulation"] < REL_BAR
    assert not {"--num-stages", "--micro-patches"} & set(stadi_infer._LATER_FLAGS)
    done = serve.main(["--diffusion", "--backend", "pipefuse", "--num-stages",
                       "2", "--device", "cpu", "--occupancies", "0.0,0.5",
                       "--m-base", "4", "--m-warmup", "2", "--requests", "3",
                       "--slots", "2"])
    assert len(done) == 3 and all(bool(torch.isfinite(r.image).all())
                                  for r in done)


def _print_readings():
    """The readings REL_BAR sits between, per case of RUN_CASES: the port
    against the reference, the chain's drift from its one-stage image, and
    each planted fault against the reference on the faults' case."""
    m = _build_model()
    for label, (occ, planner, knobs) in RUN_CASES.items():
        t, j = _generate_both(m, occ, planner, knobs, num_stages=2)
        t1, _ = _generate_both(m, occ, planner, knobs, num_stages=1)
        print(f"{label}: port vs reference {_rel(t.image, j.image):.3e}, "
              f"drift vs one stage {_rel(t.image, t1.image):.3e}")
    occ, planner, knobs = RUN_CASES["three_workers"]
    t, j = _generate_both(m, occ, planner, knobs, num_stages=2)
    x, cond = _inputs(m[0])
    for fault in CHAIN_FAULTS:
        bad = _planted_run_pipefuse(fault)(
            m[4], m[2], tsam.linear_schedule(100), torch.from_numpy(x),
            torch.from_numpy(cond), t.plan.temporal, t.plan.patches,
            t.plan.stages, exchange=knobs["exchange"])
        print(f"planted {fault}: vs reference {_rel(bad.image, j.image):.3e}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_pipefuse.py
    _print_readings()
