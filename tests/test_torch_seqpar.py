"""The sequence-parallel slice of the port against the JAX package, on the
CPU: the seq partitioners, device grouping, SeqShard lowering and replay, the
"ring" policy, the stadi_seq planner and the ring-contention cost model equal
the reference's (``==``); the emulated seq path is bitwise its unsharded self
and shard-count invariant; the ring-attention reference and a block stack
with a ring ``attend_fn`` agree with the reference's (fp32, 1e-5); kernel
K4's plain version agrees with the reference's Pallas kernel in interpret
mode (5e-5); the head-scatter and ring-hop collectives on gloo ranks equal an
oracle; and ``run_spmd_seq`` on 4 gloo ranks agrees with the reference's on
4 XLA host devices (< 1e-3) and with the port's emulated image (< 1e-5).
Sizes are ``tiny-dit.reduced()`` in fp32."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import planners as jplan  # noqa: E402
from repro.core import sampler as jsam  # noqa: E402
from repro.core import seqpar as jseq  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core.schedule import TemporalPlan as JTemporalPlan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.diffusion import dit as jdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.diffusion import DiTConfig  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import patch_parallel as tpp  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import planners as tplan  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402
from repro_torch.core import seqpar as tseq  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core import spmd as tspmd  # noqa: E402
from repro_torch.core.schedule import TemporalPlan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models.diffusion import dit as tdit  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_BAR = dict(rtol=0.0, atol=5e-5)
FORWARD_BAR = dict(rtol=0.0, atol=1e-5)
REL_BAR = 1e-3
RANK_TIMEOUT = 240


def _plain(x):
    """Dataclasses of either package -> (class name, field dict)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _same(fn_j, fn_t, *args, **kw):
    """Both raise ValueError with the same message, or return equal values."""
    try:
        want = fn_j(*args, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_t(*args, **kw)
        assert str(got.value) == str(e)
        return None
    got = fn_t(*args, **kw)
    assert _plain(got) == _plain(want)
    return got


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tiny-dit").reduced()       # 4 heads, 8 token rows
    jparams = jdit.nondegenerate_params(jdit.init_params(jax.random.PRNGKey(0),
                                                         jcfg))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    return (jcfg, jparams, DiTConfig(**dataclasses.asdict(jcfg)), np_params,
            bridge.params_from_jax(np_params, device="cpu"), x_T,
            np.array([1]))


# ----------------------------------------------------------------------
# partitioners and device grouping (==)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_heads,rows,n_shards,speeds", [
    (4, 8, 1, None), (4, 8, 2, None), (4, 8, 4, [1.0, 0.8, 0.6, 0.5]),
    (16, 64, 3, [2.0, 1.0, 0.5]), (8, 8, 8, None), (5, 9, 2, [9.0, 1.0]),
    (2, 8, 3, None), (4, 2, 4, None), (4, 8, 0, None),
])
def test_partitioners_equal(n_heads, rows, n_shards, speeds):
    for fn in ("head_partition", "ring_segments"):
        args = (n_heads, n_shards, speeds) if fn == "head_partition" \
            else (rows, n_shards, speeds)
        _same(getattr(jseq, fn), getattr(tseq, fn), *args)
    _same(jseq.make_seq_plan, tseq.make_seq_plan, n_heads, rows, n_shards,
          speeds)


@settings(max_examples=100, deadline=None)
@given(n_heads=st.integers(1, 64), rows=st.integers(1, 128),
       n_shards=st.integers(1, 8),
       speeds=st.one_of(st.none(), st.lists(st.floats(0.05, 4.0), min_size=1,
                                            max_size=8)))
def test_seq_plan_properties_equal(n_heads, rows, n_shards, speeds):
    """The reference's property sweep (tests/test_seqpar.py): every plan the
    port makes equals the reference's, and the derived fractions too."""
    n_shards = min(n_shards, n_heads, rows)
    got = _same(jseq.make_seq_plan, tseq.make_seq_plan, n_heads, rows,
                n_shards, speeds)
    want = jseq.make_seq_plan(n_heads, rows, n_shards, speeds)
    assert (got.n_shards, got.hops, got.head_fracs, got.seg_fracs,
            got.even_heads()) == (want.n_shards, want.hops, want.head_fracs,
                                  want.seg_fracs, want.even_heads())


def test_seq_plan_validation_and_grouping_equal():
    for heads, segments in (((2, 2), (8,)), ((4, 0), (4, 4)),
                            ((2, 2), (8, 0))):
        with pytest.raises(ValueError) as want:
            jseq.SeqPlan(heads, segments)
        with pytest.raises(ValueError) as got:
            tseq.SeqPlan(heads, segments)
        assert str(got.value) == str(want.value)
    for plan, n_heads, rows in ((((2, 2), (4, 4)), 8, 8),
                                (((2, 2), (4, 4)), 4, 16),
                                (((2, 2), (4, 4)), 4, 8)):
        _same(jseq.validate_seq, tseq.validate_seq, jseq.SeqPlan(*plan),
              n_heads, rows)
    for speeds, S in (([1.0, 0.5, 0.8, 0.6], 2), ([1.0, 0.9, 0.8, 0.7, 0.1], 2),
                      ([1.0, 0.5], 3), ([0.3, 0.2, 0.9], 1), ([1.0], 0)):
        _same(jseq.seq_group_speeds, tseq.seq_group_speeds, speeds, S)


# ----------------------------------------------------------------------
# IR, ring policy, staleness bound, cost model (==)
# ----------------------------------------------------------------------

SEQS = [None, ((4,), (8,)), ((2, 2), (4, 4)), ((2, 1, 1), (3, 3, 2))]


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("policy", [("ring", 2), ("ring", 3), ("stale_async", 2),
                                    ("predictive", 3), ("sync", 1)])
def test_seqshard_lowering_replay_and_simulate_equal(seq, policy):
    jp = JTemporalPlan([16, 16], [1, 2], [False, False], 16, 4)
    tp = TemporalPlan([16, 16], [1, 2], [False, False], 16, 4)
    js = jseq.SeqPlan(*seq) if seq else None
    ts = tseq.SeqPlan(*seq) if seq else None
    jpol, tpol = jcomm.get_exchange(*policy), tcomm.get_exchange(*policy)
    assert _plain(list(tev.lower(tp, [4, 4], tpol, seq_shards=ts))) == \
        _plain(list(jev.lower(jp, [4, 4], jpol, seq_shards=js)))
    recs = tev.replay(tp, [4, 4], tpol, seq_shards=ts)
    assert _plain(recs) == _plain(jev.replay(jp, [4, 4], jpol, seq_shards=js))
    assert tseq.max_hop_staleness(recs) == jseq.max_hop_staleness(
        jev.replay(jp, [4, 4], jpol, seq_shards=js))
    jt = jsim.build_trace(jp, [4, 4], jax_get_config("tiny-dit").reduced(),
                          exchange=policy[0], exchange_refresh=policy[1],
                          seq=js)
    tt = tsim.build_trace(tp, [4, 4], get_config("tiny-dit").reduced(),
                          exchange=policy[0], exchange_refresh=policy[1],
                          seq=ts)
    assert _plain(tt) == _plain(jt)
    for speeds in ([1.0, 0.6], [1.0, 0.8, 0.6, 0.5], [0.9, 0.9, 0.4, 0.4, 0.2]):
        for cm in (dict(t_fixed=1e-3, t_row=5e-4, t_ctx=2e-6, link_bw=1e9),
                   dict(t_fixed=1e-5, t_row=1e-5, t_ctx=5e-3, link_bw=1e9,
                        link_latency=1e-7)):
            if ts is not None and ts.n_shards > len(speeds):
                continue
            assert tsim.simulate_trace(tt, speeds, tsim.CostModel(**cm)) == \
                jsim.simulate_trace(jt, speeds, jsim.CostModel(**cm))


def test_ring_policy_and_hop_rows_equal():
    for refresh in (1, 2, 3, 5):
        j, t = jcomm.get_exchange("ring", refresh), tcomm.get_exchange("ring", refresh)
        assert dataclasses.astuple(j) == dataclasses.astuple(t)
        assert [j.kind(b) for b in range(12)] == [t.kind(b) for b in range(12)]
    for segs in ([3, 3, 2], [8], [5, 0, 3], [], [1, 1]):
        assert tcomm.ring_hop_rows(segs) == jcomm.ring_hop_rows(segs)


def _knobs(pkg, **kw):
    defaults = dict(occupancies=[0.0, 0.2, 0.4, 0.5], m_base=16, m_warmup=4,
                    planner="stadi_seq", seq_shards=0, n_heads=4,
                    kv_row_bytes=4096, latent_bytes=16384, exchange_refresh=2)
    defaults.update(kw)
    occ = defaults.pop("occupancies")
    cm = defaults.pop("cost_model", None)
    if cm is not None:
        defaults["cost_model"] = pkg.CostModel(**cm)
    mod = jpipe if pkg is jsim else tpipe
    return mod.StadiConfig.from_occupancies(occ, **defaults)


PLANNER_CASES = [
    dict(cost_model=dict(t_fixed=1e-3, t_row=5e-4, t_ctx=0.0, link_bw=1e6,
                         link_latency=1e-3)),          # compute bound: pure patch
    dict(cost_model=dict(t_fixed=1e-5, t_row=1e-5, t_ctx=5e-3, link_bw=1e9,
                         link_latency=1e-7)),          # attention bound: shards
    dict(seq_shards=2, cost_model=dict(t_fixed=1e-3, t_row=5e-4)),   # pinned
    dict(seq_shards=1),                                # pinned pure patch
    dict(seq_shards=4, occupancies=[0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7]),
    dict(seq_shards=8),                                # infeasible
    dict(seq_shards=2, n_heads=None),                  # no head count
    dict(),                                            # default cost model
]


@pytest.mark.parametrize("case", range(len(PLANNER_CASES)))
def test_stadi_seq_planner_equal(case):
    kw = dict(PLANNER_CASES[case])
    jk, tk = _knobs(jsim, **kw), _knobs(tsim, **kw)
    try:
        want = jplan.get_planner("stadi_seq")(jk.speeds, jk, 8)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tplan.get_planner("stadi_seq")(tk.speeds, tk, 8)
        assert str(got.value) == str(e)
        return
    got = tplan.get_planner("stadi_seq")(tk.speeds, tk, 8)
    assert _plain(got) == _plain(want) and got.planner == "stadi_seq"


@settings(max_examples=40, deadline=None)
@given(speeds=st.lists(st.floats(0.1, 1.0), min_size=1, max_size=6),
       forced=st.sampled_from([0, 1, 2, 3]), t_ctx=st.sampled_from([0.0, 2e-3]),
       p_total=st.sampled_from([8, 16]))
def test_stadi_seq_planner_sweep_equal(speeds, forced, t_ctx, p_total):
    from repro.core.hetero import DeviceProfile as JD
    from repro_torch.core.hetero import DeviceProfile as TD
    kw = dict(m_base=16, m_warmup=4, planner="stadi_seq", seq_shards=forced,
              n_heads=4, kv_row_bytes=2048, latent_bytes=8192)
    jk = jpipe.StadiConfig(cluster=(JD("d"),), cost_model=jsim.CostModel(
        1e-4, 1e-4, t_ctx=t_ctx), **kw)
    tk = tpipe.StadiConfig(cluster=(TD("d"),), cost_model=tsim.CostModel(
        1e-4, 1e-4, t_ctx=t_ctx), **kw)
    _same(jplan.get_planner("stadi_seq"), tplan.get_planner("stadi_seq"),
          speeds, jk, p_total)


# ----------------------------------------------------------------------
# the emulated seq path: bitwise and shard-count invariant
# ----------------------------------------------------------------------

def test_run_seqpar_is_bitwise_run_schedule_and_shard_invariant(model):
    _, _, tcfg, _, tparams, x_T, cond = model
    sched = tsam.linear_schedule(100)
    x, c = torch.from_numpy(x_T), torch.from_numpy(cond)
    plan = TemporalPlan([8, 8, 4, 4], [1, 1, 2, 2], [False] * 4, 8, 2)
    patches = [2, 2, 2, 2]
    base = tpp.run_schedule(tparams, tcfg, sched, x, c, plan, patches,
                            exchange="ring")
    one = tseq.run_seqpar(tparams, tcfg, sched, x, c, plan, patches,
                          tseq.SeqPlan((4,), (8,)))
    assert torch.equal(one.image, base.image) and one.trace.seq is None
    for seq in (tseq.make_seq_plan(4, 8, 2), tseq.make_seq_plan(4, 8, 4)):
        res = tseq.run_seqpar(tparams, tcfg, sched, x, c, plan, patches, seq)
        assert torch.equal(res.image, base.image)
        assert res.trace.seq == seq
        assert all(r.seq_hops == seq.hops for r in res.trace.events
                   if not r.synchronous)
    with pytest.raises(ValueError, match="sums to"):
        tseq.run_seqpar(tparams, tcfg, sched, x, c, plan, patches,
                        tseq.SeqPlan((2, 1), (4, 4)))


def test_seq_pipeline_matches_reference(model):
    """The emulated seq path end to end against the reference's pipeline:
    the same plan (seq included), trace records and image (< 1e-3), and
    the simulate backend's modeled latency equal."""
    jcfg, jparams, tcfg, _, tparams, x_T, cond = model
    kw = dict(m_base=8, m_warmup=2, seq_shards=2, exchange="ring",
              exchange_refresh=2)
    occ = [0.0, 0.2, 0.4, 0.5]
    jres = jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(T=100),
                               jpipe.StadiConfig.from_occupancies(occ, **kw)
                               ).generate(jnp.asarray(x_T), jnp.asarray(cond))
    tres = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(T=100),
                               tpipe.StadiConfig.from_occupancies(occ, **kw),
                               device="cpu").generate(torch.from_numpy(x_T),
                                                      torch.from_numpy(cond))
    assert _plain(tres.plan) == _plain(jres.plan)
    assert _plain(tres.trace) == _plain(jres.trace)
    assert _rel(tres.image.numpy(), jres.image) < REL_BAR
    cm = dict(t_fixed=1e-5, t_row=1e-5, t_ctx=2e-3)
    lat = []
    for mod, sim_mod, cfg, params in ((jpipe, jsim, jcfg, jparams),
                                      (tpipe, tsim, tcfg, tparams)):
        conf = mod.StadiConfig.from_occupancies(
            occ, backend="simulate", cost_model=sim_mod.CostModel(**cm), **kw)
        extra = {} if mod is jpipe else {"device": "cpu"}
        lat.append(mod.StadiPipeline(cfg, params, None, conf, **extra)
                   .generate(None, None).latency_s)
    assert lat[0] == lat[1] and lat[0] > 0
    auto = dict(kw, planner="stadi_seq", seq_shards=0,
                cost_model=dict(t_fixed=1e-5, t_row=1e-5, t_ctx=5e-3))
    plans = [mod.StadiPipeline(cfg, params, None, mod.StadiConfig.from_occupancies(
        occ, **dict(auto, cost_model=sim_mod.CostModel(**auto["cost_model"]))),
        **({} if mod is jpipe else {"device": "cpu"})).plan()
        for mod, sim_mod, cfg, params in ((jpipe, jsim, jcfg, jparams),
                                          (tpipe, tsim, tcfg, tparams))]
    assert _plain(plans[1]) == _plain(plans[0]) and plans[1].seq is not None


# ----------------------------------------------------------------------
# ring attention, the ring attend_fn, kernel K4's plain version (numerics)
# ----------------------------------------------------------------------

def test_ring_attention_reference_matches_jax():
    rng = np.random.default_rng(0)
    B, S, T, H, hd = 2, 6, 8, 4, 16
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, hd), (B, T, H, hd), (B, T, H, hd)))
    mask = np.broadcast_to(np.arange(T) < 6, (1, 1, 1, T))
    for seq, m in (((4,), (8,)), None), (((2, 2), (4, 4)), None), \
            (((2, 1, 1), (3, 3, 2)), None), (((2, 2), (5, 3)), mask):
        want = jseq.ring_attention_reference(
            *map(jnp.asarray, (q, k, v)), jseq.SeqPlan(*seq),
            mask=None if m is None else jnp.asarray(m))
        got = tseq.ring_attention_reference(
            *map(torch.from_numpy, (q, k, v)), tseq.SeqPlan(*seq),
            mask=None if m is None else torch.from_numpy(m.copy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_BAR)
        dense = jlayers.attend(*map(jnp.asarray, (q, k, v)),
                               mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(dense), **FORWARD_BAR)


@pytest.mark.parametrize("valid", [None, 24])
def test_block_stack_with_ring_attend_fn_matches_jax(model, valid):
    """A block stack whose buffered reads go through the ring-attention
    reference (uneven heads and segments) against the reference's, on a
    slab at row 2 — the padded layout (scratch-padded buffers with random
    scratch, 3 real rows of 4) and the plain one."""
    jcfg, jparams, tcfg, _, tparams, _, _ = model
    rng = np.random.default_rng(4)
    L, H, wp = jcfg.n_layers, jcfg.n_heads, jcfg.tokens_per_side
    hd = jcfg.d_model // H
    Nl = 4 * wp
    npad = jcfg.n_tokens + (Nl if valid is not None else 0)
    h = rng.standard_normal((1, Nl, jcfg.d_model)).astype(np.float32)
    c = rng.standard_normal((1, jcfg.d_model)).astype(np.float32)
    bk, bv = (rng.standard_normal((L, 1, npad, H, hd)).astype(np.float32)
              for _ in range(2))
    plan = ((2, 1, 1), (3, 3, 2))
    want_h, want_kv = jdit.block_stack(
        jparams["blocks"], jcfg, jnp.asarray(h), jnp.asarray(c), 2 * wp,
        buffers=(jnp.asarray(bk), jnp.asarray(bv)),
        valid_tokens=None if valid is None else jnp.int32(valid),
        attend_fn=lambda q, k, v, m: jseq.ring_attention_reference(
            q, k, v, jseq.SeqPlan(*plan), mask=m))
    got_h, got_kv = tdit.block_stack(
        tparams["blocks"], tcfg, torch.from_numpy(h), torch.from_numpy(c),
        2 * wp, buffers=(torch.from_numpy(bk), torch.from_numpy(bv)),
        valid_tokens=valid,
        attend_fn=lambda q, k, v, m: tseq.ring_attention_reference(
            q, k, v, tseq.SeqPlan(*plan), mask=m))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **FORWARD_BAR)
    for g, w in zip(got_kv, want_kv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FORWARD_BAR)
    assert torch.equal(torch.from_numpy(bk), torch.from_numpy(bk.copy()))


def _merge(parts):
    """The ring's fp32 online log-sum-exp merge of (out, lse) partials."""
    num = den = run_m = None
    for o, lse in parts:
        o = np.asarray(o, np.float32)
        lse = np.asarray(lse, np.float32)
        if num is None:
            num, den, run_m = o, np.ones_like(lse), lse
        else:
            m_new = np.maximum(run_m, lse)
            corr, w = np.exp(run_m - m_new), np.exp(lse - m_new)
            num = num * corr[..., None] + o * w[..., None]
            den = den * corr + w
            run_m = m_new
    return num / np.maximum(den, 1e-30)[..., None]


@pytest.mark.parametrize("n_segs,T_seg,valid_last", [
    (2, 128, 128), (2, 128, 96), (3, 64, 17), (4, 32, 32),
])
def test_k4_plain_version_matches_reference(n_segs, T_seg, valid_last):
    """The reference's four parametrizations (tests/test_kernels.py): each
    segment's (out, lse) against the reference's Pallas kernel in interpret
    mode, and the streamed merge against one dense attend."""
    rng = np.random.default_rng(14)
    B, S, H, hd = 1, 64, 2, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    segs = [tuple(rng.standard_normal((B, T_seg, H, hd)).astype(np.float32)
                  for _ in range(2)) for _ in range(n_segs)]
    valids = [T_seg] * (n_segs - 1) + [valid_last]
    parts = []
    for (k, v), valid in zip(segs, valids):
        o, lse = ops.lse_attention(*map(torch.from_numpy, (q, k, v)), valid)
        jo, jlse = jops.lse_attention(*map(jnp.asarray, (q, k, v)), valid)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **KERNEL_BAR)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **KERNEL_BAR)
        parts.append((o.numpy(), lse.numpy()))
    kcat = np.concatenate([k[:, :va] for (k, _), va in zip(segs, valids)], 1)
    vcat = np.concatenate([v[:, :va] for (_, v), va in zip(segs, valids)], 1)
    want = jlayers.attend(*map(jnp.asarray, (q, kcat, vcat)))
    np.testing.assert_allclose(_merge(parts), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_k4_empty_segment_has_zero_weight():
    """valid_len = 0: the port's out is 0 (the reference's is the mean of V)
    and both LSEs are below -1e29, so the merged result equals the real
    segment's alone, as the reference's does; compared on lse and the merge,
    not on out."""
    rng = np.random.default_rng(15)
    B, S, H, hd, T = 1, 32, 2, 32, 64
    q, k1, v1, k0, v0 = (rng.standard_normal(shape).astype(np.float32)
                         for shape in [(B, S, H, hd)] + [(B, T, H, hd)] * 4)
    o1, l1 = ops.lse_attention(*map(torch.from_numpy, (q, k1, v1)), T)
    o0, l0 = ops.lse_attention(*map(torch.from_numpy, (q, k0, v0)), 0)
    _, jl0 = jops.lse_attention(*map(jnp.asarray, (q, k0, v0)), 0)
    assert float(l0.max()) < -1e29 and float(jnp.max(jl0)) < -1e29
    assert torch.equal(o0, torch.zeros_like(o0))
    for order in ([(o1, l1), (o0, l0)], [(o0, l0), (o1, l1)]):
        np.testing.assert_allclose(_merge([(o.numpy(), l.numpy()) for o, l in order]),
                                   o1.numpy(), rtol=1e-6, atol=1e-6)


def test_k4_wrapper_checks_and_never_falls_back():
    q = torch.zeros(1, 4, 2, 32)
    k = torch.zeros(1, 8, 2, 32)
    ops.reset_launch_counts()
    ops.lse_attention(q, k, k, 8)
    assert ops.launch_counts() == {}          # CPU: the plain version
    with pytest.raises(ValueError, match="valid_len"):
        ops.lse_attention(q, k, k, 9)
    with pytest.raises(ValueError, match="k/v"):
        ops.lse_attention(q, k[:, :, :1], k, 4)
    with pytest.raises(ValueError, match="no lse_attention kernel"):
        ops.lse_attention(*(t.to("meta") for t in (q, k, k)), 4)


# ----------------------------------------------------------------------
# collectives on gloo ranks
# ----------------------------------------------------------------------

def _collectives_rank(ctx):
    g = torch.Generator().manual_seed(ctx.rank)
    q = torch.randn(1, 3, 4, 2, generator=g)
    scattered = tcomm.ulysses_scatter_heads(q)
    back = tcomm.ulysses_gather_heads(scattered)
    hop = tcomm.ring_hop(torch.full((2, 3), float(ctx.rank)))
    return q.numpy(), scattered.numpy(), back.numpy(), hop.numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_and_ring_hop_collectives(world):
    """The head scatter gives member j head group j of every member's q,
    token blocks in member order; the regather undoes it; a hop returns the
    previous member's tensor."""
    out = ranks.spawn(_collectives_rank, world, device_type="cpu",
                      timeout=RANK_TIMEOUT)
    qs = [o[0] for o in out]
    Hs = 4 // world
    for j, (q, scattered, back, hop) in enumerate(out):
        want = np.concatenate([qj[:, :, j * Hs:(j + 1) * Hs] for qj in qs], 1)
        np.testing.assert_array_equal(scattered, want)
        np.testing.assert_array_equal(back, q)
        np.testing.assert_array_equal(hop, np.full((2, 3), (j - 1) % world))


# ----------------------------------------------------------------------
# run_spmd_seq: the port on 4 gloo ranks against the reference on devices
# ----------------------------------------------------------------------

#: label -> (plan, patches, seq (heads, segments), exchange)
SPMD_SEQ_VARIANTS = {
    "ring": (dict(steps=[8, 4], ratios=[1, 2], excluded=[False, False],
                  m_base=8, m_warmup=2), [5, 3], ((2, 2), (4, 4)), "ring"),
    "sync_s4": (dict(steps=[8], ratios=[1], excluded=[False], m_base=8,
                     m_warmup=2), [8], ((1, 1, 1, 1), (2, 2, 2, 2)), "sync"),
}

JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import sampler, spmd
    from repro.core.schedule import TemporalPlan
    from repro.core.seqpar import SeqPlan

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
    for label, (plan, patches, seq, exchange) in variants.items():
        img = spmd.run_spmd_seq(params, cfg, sched, x_T, cond,
                                TemporalPlan(**plan), patches, SeqPlan(*seq),
                                exchange=exchange)
        out[label] = np.asarray(img)
    np.savez(sys.argv[2], **out)
    print("JAX_SPMD_SEQ_OK")
""")


def _spmd_seq_rank(ctx, path, variants):
    """One port rank: the bridged weights, every variant, the patch forwards
    it ran and the K4 calls it made (the plain version on the CPU), and the
    emulated image of the same schedule."""
    from repro_torch.configs import get_config
    from repro_torch.core import patch_parallel, sampler, seqpar, spmd
    from repro_torch.kernels import ref as kref
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
    counts = {"evals": 0, "k4": 0}
    forward_patch, lse_ref = dit.forward_patch, kref.lse_attention_ref

    def counting_forward(*a, **kw):
        if kw.get("valid_tokens") is not None:
            counts["evals"] += 1
        return forward_patch(*a, **kw)

    def counting_k4(*a, **kw):
        counts["k4"] += 1
        return lse_ref(*a, **kw)

    dit.forward_patch, kref.lse_attention_ref = counting_forward, counting_k4
    out = {}
    for label, (plan, patches, seq, exchange) in variants.items():
        counts.update(evals=0, k4=0)
        img = spmd.run_spmd_seq(params, cfg, sched, x_T, cond,
                                TemporalPlan(**plan), patches,
                                seqpar.SeqPlan(*seq), exchange=exchange)
        emu = patch_parallel.run_schedule(params, cfg, sched, x_T, cond,
                                          TemporalPlan(**plan), patches,
                                          exchange=exchange)
        out[label] = (img.numpy(), emu.image.numpy(), dict(counts))
    return out


@pytest.fixture(scope="module")
def spmd_seq_runs(model, tmp_path_factory):
    """Both packages on the same weights, noise and class: the reference in
    a subprocess with 4 XLA host devices, the port on 4 gloo ranks."""
    _, _, _, np_params, _, x_T, cond = model
    tmp = tmp_path_factory.mktemp("spmd_seq")
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"p/{prefix}{k}"] = np.asarray(v)
    walk(np_params, "")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, x_T=x_T, cond=cond,
             variants=np.array(SPMD_SEQ_VARIANTS, dtype=object), **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    env.pop("STADI_HOST_DEVICES", None)
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(inputs),
                        str(tmp / "jax.npz")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0 and "JAX_SPMD_SEQ_OK" in r.stdout, r.stderr[-3000:]
    want = dict(np.load(tmp / "jax.npz"))
    got = ranks.spawn(_spmd_seq_rank, 4, device_type="cpu",
                      args=(str(inputs), SPMD_SEQ_VARIANTS),
                      timeout=RANK_TIMEOUT)
    return want, got


@pytest.mark.parametrize("label", list(SPMD_SEQ_VARIANTS))
def test_spmd_seq_matches_reference(spmd_seq_runs, label):
    """Every rank returns the reference's image (< 1e-3) and the port's
    emulated image (< 1e-5, the reference's own spmd_seq bar); rank s * N + d
    runs worker d's patch evals, and K4 once per layer per ring hop of each."""
    want, got = spmd_seq_runs
    plan, patches, seq, _ = SPMD_SEQ_VARIANTS[label]
    S, N = len(seq[0]), len(patches)
    L = get_config("tiny-dit").reduced().n_layers
    intervals = plan["m_base"] - plan["m_warmup"]
    for rank, rank_out in enumerate(got):
        img, emu, counts = rank_out[label]
        assert _rel(img, want[label]) < REL_BAR, (label, rank)
        assert _rel(img, emu) < 1e-5, (label, rank, _rel(img, emu))
        np.testing.assert_array_equal(img, got[0][label][0])
        evals = intervals // plan["ratios"][rank % N]
        assert counts == {"evals": evals, "k4": L * S * evals}, (rank, counts)


# ----------------------------------------------------------------------
# rejections and the CLI
# ----------------------------------------------------------------------

def test_seq_rejections_match_reference(model):
    jcfg, jparams, tcfg, _, tparams, x_T, cond = model
    conf = dict(m_base=8, m_warmup=2)

    def both(occ, **kw):
        """The reference's and the port's error for one config (raised by
        the constructor or by generate), or None when neither raises."""
        msgs = []
        for mod, cfg, params, extra, x, c in (
                (jpipe, jcfg, jparams, {}, jnp.asarray(x_T), jnp.asarray(cond)),
                (tpipe, tcfg, tparams, {"device": "cpu"},
                 torch.from_numpy(x_T), torch.from_numpy(cond))):
            try:
                config = mod.StadiConfig.from_occupancies(occ, **conf, **kw)
                pipe = mod.StadiPipeline(cfg, params, jsam.linear_schedule(100)
                                         if mod is jpipe else
                                         tsam.linear_schedule(100), config,
                                         **extra)
                if kw.get("backend") == "spmd_seq":
                    plan = pipe.plan()
                    mod.check_backend_can_run(plan, config)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        return msgs

    for occ, kw in (([0.0, 0.4], dict(seq_shards=3)),
                    ([0.0] * 8, dict(seq_shards=8)),
                    ([0.0, 0.4], dict(seq_shards=-1)),
                    ([0.0, 0.4], dict(seq_shards=2, rebalance_every=2)),
                    ([0.0, 0.4], dict(seq_shards=2, backend="spmd")),
                    ([0.0, 0.4], dict(backend="spmd_seq")),
                    ([0.0, 0.4], dict(seq_shards=2, backend="spmd_seq"))):
        j, t = both(occ, **kw)
        assert t == j, (kw, j, t)
    # the capability check's messages, word for word
    jconf = jpipe.StadiConfig.from_occupancies([0.0, 0.4], **conf)
    tconf = tpipe.StadiConfig.from_occupancies([0.0, 0.4], **conf)
    jp = jpipe.StadiPipeline(jcfg, jparams, jsam.linear_schedule(100), jconf).plan()
    tp = tpipe.StadiPipeline(tcfg, tparams, tsam.linear_schedule(100), tconf,
                             device="cpu").plan()
    for plan_kw, kw in (({}, dict(seq_shards=2, backend="spmd")),
                        ({}, dict(backend="spmd_seq")),
                        ({"seq": ((2, 1, 1), (3, 3, 2))},
                         dict(seq_shards=3, backend="spmd_seq"))):
        msgs = []
        for mod, seq_mod, plan, config in ((jpipe, jseq, jp, jconf),
                                           (tpipe, tseq, tp, tconf)):
            if plan_kw:
                plan = dataclasses.replace(plan, seq=seq_mod.SeqPlan(*plan_kw["seq"]))
            with pytest.raises(ValueError) as e:
                mod.check_backend_can_run(plan, dataclasses.replace(config, **kw))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    plan = TemporalPlan([8, 8], [1, 1], [False, False], 8, 2)
    with pytest.raises(ValueError, match="divisible"):
        tspmd.run_spmd_seq(tparams, tcfg, tsam.linear_schedule(100),
                           torch.from_numpy(x_T), torch.from_numpy(cond), plan,
                           [4, 4], seq=tseq.SeqPlan((2, 1, 1), (3, 3, 2)))
    with pytest.raises(RuntimeError, match="process group"):
        tspmd.run_spmd_seq(tparams, tcfg, tsam.linear_schedule(100),
                           torch.from_numpy(x_T), torch.from_numpy(cond), plan,
                           [4, 4], seq=tseq.SeqPlan((2, 2), (4, 4)))
    # guidance: refused by the capability check (the reference's message up
    # to its list of guided backends, which has backends the port lacks)
    msgs = []
    for mod, cfg, params, sched, extra in (
            (jpipe, jcfg, jparams, jsam.linear_schedule(100), {}),
            (tpipe, tcfg, tparams, tsam.linear_schedule(100), {"device": "cpu"})):
        config = mod.StadiConfig.from_occupancies(
            [0.0, 0.4], seq_shards=2, cfg_scale=2.0, backend="spmd_seq", **conf)
        with pytest.raises(ValueError) as e:
            mod.check_backend_can_run(
                mod.StadiPipeline(cfg, params, sched, config, **extra).plan(),
                config)
        msgs.append(str(e.value))
    assert all(m.startswith("guided generation (cfg_scale=2.0) needs a guided "
                            "backend (") and m.endswith("not 'spmd_seq'")
               for m in msgs), msgs
    with pytest.raises(ValueError, match="not implemented on the 'spmd_seq'"):
        tpipe.get_executor("spmd_seq")(
            params=tparams, model_cfg=tcfg, sched=None, x_T=None, cond=None,
            plan=dataclasses.replace(tp, seq=tseq.SeqPlan((2, 2), (4, 4)),
                                     guidance=object()),
            config=tconf)
    with pytest.raises(KeyError, match="spmd_seq"):
        tpipe.get_executor("no-such-backend")
    with pytest.raises(KeyError, match="stadi_seq"):
        tplan.get_planner("no-such-planner")


def test_cli_spmd_seq_on_cpu_ranks_matches_emulation():
    """``--seq-shards 2 --backend spmd_seq --device cpu`` starts 2 x 2 gloo
    ranks itself; ``--check-vs-emulation`` holds them to the emulated
    backend."""
    from repro_torch.launch import stadi_infer
    out = stadi_infer.main(["--device", "cpu", "--reduced", "--m-base", "8",
                            "--m-warmup", "2", "--occupancies", "0.0,0.4",
                            "--seq-shards", "2", "--exchange", "ring",
                            "--backend", "spmd_seq", "--check-vs-emulation"])
    assert out["backend"] == "spmd_seq" and out["ranks"] == 4 and out["finite"]
    assert out["rel_err_vs_emulation"] < REL_BAR
    assert "--seq-shards" not in stadi_infer._LATER_FLAGS
