"""The multi-rank slice of the port against the JAX package, on the CPU:
kernels K2 and K5's plain versions against the reference's oracle and its
Pallas kernels in interpret mode (5e-5), the padded DiT forwards against the
reference's (fp32 atol 1e-5, kernel off and on), the uneven all-gathers on 4
gloo ranks against an oracle (exact), and ``run_spmd`` /
``run_spmd_guidance`` on 4 gloo ranks against the reference's on 4 XLA host
devices with the same bridged weights (image relative error < 1e-3, the
reference's emulated-vs-spmd bar). The reference runs in a subprocess (its
device count is fixed when jax starts), the port's ranks in processes of
their own, each with a timeout. Sizes are ``tiny-dit.reduced()`` in fp32."""
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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core import spmd as tspmd  # noqa: E402
from repro_torch.core.guidance import GuidancePlan  # noqa: E402
from repro_torch.core.schedule import TemporalPlan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models.diffusion import dit as tdit  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_BAR = dict(rtol=0.0, atol=5e-5)
FORWARD_BAR = dict(rtol=0.0, atol=1e-5)
REL_BAR = 1e-3
RANK_TIMEOUT = 240


# ----------------------------------------------------------------------
# kernels K2 and K5: plain versions vs the reference
# ----------------------------------------------------------------------

def _padded_inputs(B, Nl, Npad, H=2, hd=32, lead=(), seed=0):
    """Random everywhere: the slab's rows past valid_tokens and the
    buffer's scratch tail too, so a missing mask or blend shows."""
    rng = np.random.default_rng(seed)
    mk = lambda n: (0.5 * rng.standard_normal(lead + (B, n, H, hd))
                    ).astype(np.float32)
    return mk(Nl), mk(Nl), mk(Nl), mk(Npad), mk(Npad)


def _jax_padded_oracle(q, kf, vf, kst, vst, tok_start, valid, n_tokens):
    """The reference's SPMD branch of ``dit.block_stack``: mask-blend,
    dynamic_update_slice, masked attend."""
    Nl = q.shape[1]
    mask = (jnp.arange(Nl) < valid)[None, :, None, None]
    cur_k = jax.lax.dynamic_slice_in_dim(kst, tok_start, Nl, axis=1)
    cur_v = jax.lax.dynamic_slice_in_dim(vst, tok_start, Nl, axis=1)
    full_k = jax.lax.dynamic_update_slice_in_dim(
        kst, jnp.where(mask, kf, cur_k), tok_start, axis=1)
    full_v = jax.lax.dynamic_update_slice_in_dim(
        vst, jnp.where(mask, vf, cur_v), tok_start, axis=1)
    key_mask = (jnp.arange(kst.shape[1]) < n_tokens)[None, None, None, :]
    return jlayers.attend(q, full_k, full_v, mask=key_mask)


@pytest.mark.parametrize("tok_start,valid", [
    (0, 64), (64, 64), (192, 64),    # whole-slab fresh at several offsets
    (64, 40), (128, 8), (192, 33),   # uneven valid tails (incl. non-tile)
    (0, 0), (256, 0),                # an empty slab, and one past the image
])
def test_k2_plain_version_matches_reference(tok_start, valid):
    N, Nl = 256, 64
    arrs = _padded_inputs(1, Nl, N + Nl)
    got = ops.stale_kv_attention_padded(*map(torch.from_numpy, arrs),
                                        tok_start, valid, n_tokens=N).numpy()
    pallas = np.asarray(jops.stale_kv_attention_padded(
        *map(jnp.asarray, arrs), tok_start, valid, n_tokens=N))
    oracle = np.asarray(_jax_padded_oracle(*map(jnp.asarray, arrs),
                                           tok_start, valid, N))
    np.testing.assert_allclose(got, pallas, **KERNEL_BAR)
    np.testing.assert_allclose(got, oracle, **KERNEL_BAR)


@pytest.mark.parametrize("uncond_fresh", [1, 0])
@pytest.mark.parametrize("tok_start,valid", [(0, 32), (64, 32), (96, 9)])
def test_k5_plain_version_matches_reference(uncond_fresh, tok_start, valid):
    N, Nl = 128, 32
    arrs = _padded_inputs(2, Nl, N + Nl, lead=(2,), seed=1)
    got = ops.stale_kv_attention_guided(*map(torch.from_numpy, arrs),
                                        tok_start, valid, uncond_fresh,
                                        n_tokens=N).numpy()
    pallas = np.asarray(jops.stale_kv_attention_guided(
        *map(jnp.asarray, arrs), tok_start, valid, uncond_fresh, n_tokens=N))
    oracle = np.stack([np.asarray(_jax_padded_oracle(
        *(jnp.asarray(a[g]) for a in arrs), tok_start,
        valid if g == 0 or uncond_fresh else 0, N)) for g in range(2)])
    np.testing.assert_allclose(got, pallas, **KERNEL_BAR)
    np.testing.assert_allclose(got, oracle, **KERNEL_BAR)


def test_k2_k5_wrappers_check_layouts_and_never_fall_back():
    q, kf, vf, ks, vs = map(torch.from_numpy, _padded_inputs(1, 16, 80))
    ops.reset_launch_counts()
    ops.stale_kv_attention_padded(q, kf, vf, ks, vs, 16, 8, n_tokens=64)
    assert ops.launch_counts() == {}          # CPU: the plain version
    with pytest.raises(ValueError, match="valid_tokens"):
        ops.stale_kv_attention_padded(q, kf, vf, ks, vs, 0, 17, n_tokens=64)
    with pytest.raises(ValueError, match="outside"):
        ops.stale_kv_attention_padded(q, kf, vf, ks, vs, 65, 8, n_tokens=64)
    with pytest.raises(ValueError, match="n_tokens"):
        ops.stale_kv_attention_padded(q, kf, vf, ks, vs, 0, 8, n_tokens=81)
    with pytest.raises(ValueError, match="stale"):
        ops.stale_kv_attention_padded(q, kf, vf, ks[:, :, :1], vs, 0, 8,
                                      n_tokens=64)
    meta = [t.to("meta") for t in (q, kf, vf, ks, vs)]
    with pytest.raises(ValueError, match="no stale_kv_attention_padded kernel"):
        ops.stale_kv_attention_padded(*meta, 0, 8, n_tokens=64)
    g = [torch.stack([t, t]) for t in (q, kf, vf, ks, vs)]
    with pytest.raises(ValueError, match="uncond_fresh"):
        ops.stale_kv_attention_guided(*g, 0, 8, 2, n_tokens=64)
    with pytest.raises(ValueError, match="branch"):
        ops.stale_kv_attention_guided(q, kf, vf, ks, vs, 0, 8, 1, n_tokens=64)
    with pytest.raises(ValueError, match="no stale_kv_attention_guided kernel"):
        ops.stale_kv_attention_guided(*(t.to("meta") for t in g), 0, 8, 1,
                                      n_tokens=64)


# ----------------------------------------------------------------------
# the padded DiT forwards
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-dit").reduced()       # 8 token rows of 8
    jparams = jdit.nondegenerate_params(jdit.init_params(jax.random.PRNGKey(0),
                                                         jcfg))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return (jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)), np_params,
            bridge.params_from_jax(np_params, device="cpu"))


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_padded_forward_matches_reference(model, use_pallas, guided):
    """A 3-row slab at row 6 of 8 (one scratch row past the image) with 2
    real rows, against buffers scratch-padded to n_tokens + 24 with random
    scratch; every row's eps and fresh K/V (scratch rows included) must
    agree. The reference takes its padded Pallas kernel when
    ``use_pallas_attention`` is on; the port always runs K2's wrapper."""
    jcfg, jparams, tcfg, _, tparams = model
    jcfg = jcfg.replace(use_pallas_attention=use_pallas)
    rng = np.random.default_rng(7)
    L, H = jcfg.n_layers, jcfg.n_heads
    hd = jcfg.d_model // H
    Pmax, row_start, valid = 3, 6, 2 * jcfg.tokens_per_side
    lead = (2,) if guided else ()
    x = rng.standard_normal((2, Pmax * jcfg.patch_size, jcfg.latent_size,
                             jcfg.channels)).astype(np.float32)
    npad = jcfg.n_tokens + Pmax * jcfg.tokens_per_side
    bk, bv = (rng.standard_normal(lead + (L, 2, npad, H, hd)).astype(np.float32)
              for _ in range(2))
    cond = np.array([1, 2])
    if guided:
        def one(c, k, v):
            return jdit.forward_patch(jparams, jcfg, jnp.asarray(x), 40, c,
                                      row_start, buffers=(k, v),
                                      valid_tokens=jnp.int32(valid))
        want_eps, want_kv = jax.vmap(one)(jdit.guidance_conds(jnp.asarray(cond)),
                                          jnp.asarray(bk), jnp.asarray(bv))
        got_eps, got_kv = tdit.forward_patch_cfg(
            tparams, tcfg, torch.from_numpy(x), 40, torch.from_numpy(cond),
            row_start, buffers=(torch.from_numpy(bk), torch.from_numpy(bv)),
            valid_tokens=valid)
    else:
        want_eps, want_kv = jdit.forward_patch(
            jparams, jcfg, jnp.asarray(x), 40, jnp.asarray(cond), row_start,
            buffers=(jnp.asarray(bk), jnp.asarray(bv)),
            valid_tokens=jnp.int32(valid))
        got_eps, got_kv = tdit.forward_patch(
            tparams, tcfg, torch.from_numpy(x), 40, torch.from_numpy(cond),
            row_start, buffers=(torch.from_numpy(bk), torch.from_numpy(bv)),
            valid_tokens=valid)
    np.testing.assert_allclose(got_eps.numpy(), np.asarray(want_eps),
                               **FORWARD_BAR)
    for g, w in zip(got_kv, want_kv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FORWARD_BAR)


# ----------------------------------------------------------------------
# the uneven all-gathers on 4 gloo ranks
# ----------------------------------------------------------------------

GATHER_CASES = [([3, 1, 4, 2], 0), ([3, 0, 2, 1], 1)]


def _gather_rank(ctx, cases):
    from repro_torch.core import comm
    out = []
    for sizes, axis in cases:
        rng = np.random.default_rng(ctx.rank)
        shape = [2, 5]
        shape[axis] = max(sizes)
        local = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out.append((comm.uneven_all_gather_padded(local, sizes, None, axis).numpy(),
                    comm.uneven_all_gather_broadcast(local, sizes, None, axis).numpy()))
    return out


@pytest.fixture(scope="module")
def gathered():
    return ranks.spawn(_gather_rank, 4, device_type="cpu",
                       args=(GATHER_CASES,), timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("strategy", ["padded", "broadcast"])
@pytest.mark.parametrize("case", range(len(GATHER_CASES)))
def test_uneven_all_gather_equivalence(gathered, case, strategy):
    """Paper §V-A: both strategies give every rank the oracle's
    concatenation of the valid prefixes (a zero-size rank adds nothing)."""
    sizes, axis = GATHER_CASES[case]
    slabs = []
    for r in range(4):
        rng = np.random.default_rng(r)
        shape = [2, 5]
        shape[axis] = max(sizes)
        slabs.append(np.take(rng.standard_normal(shape).astype(np.float32),
                             range(sizes[r]), axis=axis))
    oracle = np.concatenate(slabs, axis=axis)
    for r in range(4):
        got = gathered[r][case][0 if strategy == "padded" else 1]
        np.testing.assert_array_equal(got, oracle)


# ----------------------------------------------------------------------
# run_spmd / run_spmd_guidance: port on gloo ranks vs reference on devices
# ----------------------------------------------------------------------

SCALE = 2.5
PLAN4 = dict(steps=[12, 12, 6, 6], ratios=[1, 1, 2, 2], excluded=[False] * 4,
             m_base=12, m_warmup=2)
PATCHES4 = [3, 2, 2, 1]
PLAN2 = dict(steps=[12, 6], ratios=[1, 2], excluded=[False] * 2, m_base=12,
             m_warmup=2)
PATCHES2 = [5, 3]
#: label -> (function, plan, patches, exchange, guidance as (mode, scale,
#: cond devices, uncond devices) or None)
VARIANTS = {
    "sync": ("run_spmd", PLAN4, PATCHES4, "sync", None),
    "stale_async": ("run_spmd", PLAN4, PATCHES4, "stale_async", None),
    "predictive": ("run_spmd", PLAN4, PATCHES4, "predictive", None),
    "fused": ("run_spmd", PLAN4, PATCHES4, "sync", ("fused", SCALE, (), ())),
    "split": ("run_spmd_guidance", PLAN2, PATCHES2, "sync",
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
    cfg = get_config("tiny-dit").reduced()
    sched = sampler.linear_schedule(T=100)
    x_T, cond = jnp.asarray(data["x_T"]), jnp.asarray(data["cond"])
    out = {}
    for label, (fn, plan, patches, exchange, g) in variants.items():
        guidance = GuidancePlan(g[0], g[1], g[2], g[3]) if g else None
        args = (params, cfg, sched, x_T, cond, TemporalPlan(**plan), patches)
        if fn == "run_spmd":
            img = spmd.run_spmd(*args, exchange=exchange, guidance=guidance)
        else:
            img = spmd.run_spmd_guidance(*args, guidance, exchange=exchange)
        out[label] = np.asarray(img)
    np.savez(sys.argv[2], **out)
    print("JAX_SPMD_OK")
""")


def _spmd_rank(ctx, path, variants):
    """One port rank: load the bridged weights, run every variant, and
    count the patch forwards (padded evals) it ran."""
    from repro_torch.configs import get_config
    from repro_torch.core import sampler, spmd
    from repro_torch.models.diffusion import dit

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
    sched = sampler.linear_schedule(T=100)
    x_T, cond = torch.from_numpy(data["x_T"]), torch.from_numpy(data["cond"])
    evals = {"n": 0}
    forward_patch = dit.forward_patch

    def counting(*a, **kw):
        if kw.get("valid_tokens") is not None:
            evals["n"] += 1
        return forward_patch(*a, **kw)

    dit.forward_patch = counting
    out = {}
    for label, (fn, plan, patches, exchange, g) in variants.items():
        evals["n"] = 0
        guidance = GuidancePlan(g[0], g[1], g[2], g[3]) if g else None
        args = (params, cfg, sched, x_T, cond, TemporalPlan(**plan), patches)
        if fn == "run_spmd":
            img = spmd.run_spmd(*args, exchange=exchange, guidance=guidance)
        else:
            img = spmd.run_spmd_guidance(*args, guidance, exchange=exchange)
        out[label] = (img.numpy(), evals["n"])
    return out


@pytest.fixture(scope="module")
def spmd_runs(model, tmp_path_factory):
    """Both packages on the same weights, noise and classes: the reference
    in a subprocess with 4 XLA host devices, the port on 4 gloo ranks."""
    _, _, _, np_params, _ = model
    tmp = tmp_path_factory.mktemp("spmd")
    rng = np.random.default_rng(3)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = np.asarray(v)
    walk(np_params, "")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, x_T=rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
             cond=np.array([1, 2]),
             variants=np.array(VARIANTS, dtype=object), **flat)
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
                      args=(str(inputs), VARIANTS), timeout=RANK_TIMEOUT)
    return want, got


@pytest.mark.parametrize("label", list(VARIANTS))
def test_spmd_matches_reference(spmd_runs, label):
    """Every rank returns the reference's image (relative error < 1e-3), and
    skips the forwards of its inactive substeps: a ratio-2 rank runs half
    the patch evals of a ratio-1 rank, where the reference computes them
    all in lockstep and discards the inactive ones."""
    want, got = spmd_runs
    fn, plan, patches, _, g = VARIANTS[label]
    ref_img = want[label]
    for rank_out in got:
        img, _ = rank_out[label]
        rel = np.linalg.norm(img - ref_img) / np.linalg.norm(ref_img)
        assert rel < REL_BAR, (label, rel)
    intervals = (plan["m_base"] - plan["m_warmup"]) // 2
    n = len(patches)
    evals = [rank_out[label][1] for rank_out in got]
    assert evals == [intervals * 2 // plan["ratios"][r % n]
                     for r in range(len(got))], evals


# ----------------------------------------------------------------------
# rejections
# ----------------------------------------------------------------------

def test_executor_rejections(model):
    _, _, tcfg, _, tparams = model
    sched = tsam.linear_schedule(100)
    x_T = torch.zeros(1, 16, 16, 3)
    cond = torch.tensor([1])
    plan = TemporalPlan([8], [1], [False], 8, 2)
    with pytest.raises(ValueError, match="spmd_guidance"):
        tspmd.run_spmd(tparams, tcfg, sched, x_T, cond, plan, [8],
                       guidance=GuidancePlan("split", 2.0, (0,), (1,)))
    with pytest.raises(ValueError, match="split"):
        tspmd.run_spmd_guidance(tparams, tcfg, sched, x_T, cond, plan, [8],
                                GuidancePlan("fused", 2.0))
    with pytest.raises(ValueError, match="interleaved"):
        tspmd.run_spmd_guidance(tparams, tcfg, sched, x_T, cond, plan, [8],
                                GuidancePlan("interleaved", 2.0, (0,), (1,)))
    with pytest.raises(RuntimeError, match="process group"):
        tspmd.run_spmd(tparams, tcfg, sched, x_T, cond, plan, [8])
    conf = tpipe.StadiConfig.from_occupancies([0.0, 0.0, 0.5, 0.5], m_base=8,
                                              m_warmup=2)
    mk = lambda **kw: tpipe.StadiPipeline(
        tcfg, tparams, sched, dataclasses.replace(conf, **kw), device="cpu")
    for kw, match in (
            (dict(backend="spmd", cfg_scale=2.0, planner="stadi_guidance",
                  guidance="split"), "backend='spmd_guidance'"),
            (dict(backend="spmd_guidance", cfg_scale=2.0),
             "fused CFG runs on the plain 'spmd' backend"),
            (dict(backend="spmd_guidance", cfg_scale=2.0,
                  planner="stadi_guidance", guidance="interleaved"),
             "interleaved uncond reuse"),
            (dict(backend="spmd_guidance"), "needs a guided plan")):
        with pytest.raises(ValueError, match=match):
            mk(**kw).generate(x_T, cond)
    with pytest.raises(RuntimeError, match="process group"):
        mk(backend="spmd").generate(x_T, cond)


def _mismatch_rank(ctx):
    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    cfg = get_config("tiny-dit").reduced()
    plan = TemporalPlan([8, 8], [1, 1], [False, False], 8, 2)
    msgs = []
    for fn, args in ((spmd.run_spmd, ()),
                     (spmd.run_spmd_guidance, (GuidancePlan("split", 2.0, (0,),
                                                            (1,)),))):
        try:
            fn({}, cfg, tsam.linear_schedule(100), torch.zeros(1, 16, 16, 3),
               torch.tensor([1]), plan, [4, 4], *args)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def test_rank_count_must_match_the_plan():
    (msgs,) = ranks.spawn(_mismatch_rank, 1, device_type="cpu",
                          timeout=RANK_TIMEOUT)
    assert "2 workers, 1 ranks" in msgs[0]
    assert "needs 4 ranks, have 1" in msgs[1]


def _split_groups_rank(ctx):
    from repro_torch.core import spmd
    first, again = spmd._split_groups(1), spmd._split_groups(1)
    return first is again, len(first)


def test_split_groups_are_made_once_per_process_group():
    """NCCL builds a communicator per group (seconds each), so split
    guidance makes its branch and pair groups once per process group and
    every later call reuses them."""
    out = ranks.spawn(_split_groups_rank, 2, device_type="cpu",
                      timeout=RANK_TIMEOUT)
    assert out == [(True, 3), (True, 3)]


def _tensor_rank(ctx):
    return {"rank": ctx.rank, "t": torch.full((4096,), float(ctx.rank))}


def test_ranks_return_tensors():
    """A rank's tensor comes back by value, so it survives the rank's exit
    (torch's shared-memory queue reduction needs the rank alive until the
    parent reads it)."""
    out = ranks.spawn(_tensor_rank, 2, device_type="cpu", timeout=RANK_TIMEOUT)
    for r, o in enumerate(out):
        assert o["rank"] == r and torch.equal(o["t"], torch.full((4096,), float(r)))


def test_backend_rule(monkeypatch):
    """NCCL by default on CUDA, refused (before any process group) when
    there are more ranks than cards, naming --dist-backend gloo; gloo on
    CUDA only by name; gloo on the CPU."""
    assert ranks.resolve_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="CPU ranks run gloo"):
        ranks.resolve_backend("cpu", 2, "nccl")
    with pytest.raises(ValueError, match="unknown dist backend"):
        ranks.resolve_backend("cpu", 2, "mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ranks.resolve_backend("cuda", 1) == "nccl"
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        ranks.resolve_backend("cuda", 2)
    assert ranks.resolve_backend("cuda", 2, "gloo") == "gloo"
    assert [ranks.rank_device(r, "cuda").index for r in range(3)] == [0, 0, 0]


def test_cli_spmd_on_cpu_ranks_matches_emulation():
    """The CLI starts the ranks itself: ``--device cpu --spmd`` on 2 gloo
    ranks, held to the emulated backend by ``--check-vs-emulation``."""
    from repro_torch.launch import stadi_infer
    out = stadi_infer.main(["--device", "cpu", "--reduced", "--m-base", "8",
                            "--m-warmup", "2", "--spmd", "--check-vs-emulation"])
    assert out["backend"] == "spmd" and out["ranks"] == 2 and out["finite"]
    assert out["dist_backend"] == "gloo"
    assert out["rel_err_vs_emulation"] < REL_BAR
    assert "--spmd" not in stadi_infer._LATER_FLAGS
