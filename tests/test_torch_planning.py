"""The port's framework-free planning layer equals the reference's (``==``):
schedule, hetero, planners, comm, events and simulate, on the cases of
tests/test_schedule.py, tests/test_events.py and tests/test_comm.py plus
hypothesis sweeps over the same input spaces."""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import hetero as jhet  # noqa: E402
from repro.core import planners as jplan  # noqa: E402
from repro.core import schedule as jsl  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core.pipeline import StadiConfig as JStadiConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import hetero as thet  # noqa: E402
from repro_torch.core import planners as tplan  # noqa: E402
from repro_torch.core import schedule as tsl  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.pipeline import StadiConfig as TStadiConfig  # noqa: E402

speeds_st = st.lists(st.floats(0.05, 1.0), min_size=1, max_size=8)
SETTINGS = settings(max_examples=60, deadline=None)


def _same(fn_j, fn_t, *args, **kw):
    """Both raise the same exception type, or both return equal values."""
    try:
        want = fn_j(*args, **kw)
    except (ValueError, KeyError) as e:
        with pytest.raises(type(e)):
            fn_t(*args, **kw)
        return
    assert _plain(fn_t(*args, **kw)) == _plain(want)


def _plain(x):
    """Dataclasses of either package -> (class name, field dict)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


# ----------------------------------------------------------------------
# schedule
# ----------------------------------------------------------------------

@SETTINGS
@given(speeds=speeds_st, m_base=st.sampled_from([8, 16, 100, 101]),
       m_warmup=st.sampled_from([0, 2, 4, 8]),
       tiers=st.sampled_from([(1, 2), (1,), (1, 2, 4)]))
def test_temporal_allocation_equal(speeds, m_base, m_warmup, tiers):
    _same(jsl.temporal_allocation, tsl.temporal_allocation, speeds, m_base,
          m_warmup, tiers=tiers)


@SETTINGS
@given(speeds=speeds_st, p_total=st.sampled_from([8, 16, 32, 64]),
       gran=st.sampled_from([1, 2, 4]), min_mult=st.sampled_from([None, 1, 2, 3]))
def test_spatial_allocation_equal(speeds, p_total, gran, min_mult):
    plan = jsl.temporal_allocation(speeds, 100, 4)
    min_patch = None if min_mult is None else gran * min_mult
    _same(jsl.spatial_allocation, tsl.spatial_allocation, speeds, plan.steps,
          p_total, gran, min_patch)


@settings(max_examples=30, deadline=None)
@given(speeds=st.lists(st.floats(0.3, 1.0), min_size=1, max_size=5),
       tiers=st.sampled_from([(1, 2), (1, 2, 4)]))
def test_makespan_allocation_equal(speeds, tiers):
    _same(jsl.makespan_optimal_allocation, tsl.makespan_optimal_allocation,
          speeds, 100, 4, 32, tiers=tiers)


def test_schedule_fixed_cases_equal():
    for args in [([1.0, 0.5], 100, 4), ([1.0, 0.8], 100, 4),
                 ([1.0, 0.2], 100, 4), ([1.0], 100, 4, 0.2, 0.5),
                 ([1.0], 4, 4), ([1.0], 101, 4)]:
        _same(jsl.temporal_allocation, tsl.temporal_allocation, *args)
    for args in [([1.0, 0.5], [100, 52], 32), ([1.0, 0.3], [100, 52], 32),
                 ([1.0], [100], 33, 2)]:
        _same(jsl.spatial_allocation, tsl.spatial_allocation, *args)
    assert tsl.patch_bounds([3, 0, 5]) == jsl.patch_bounds([3, 0, 5])
    assert tsl.effective_speed(0.8, 0.3) == jsl.effective_speed(0.8, 0.3)


# ----------------------------------------------------------------------
# hetero
# ----------------------------------------------------------------------

@SETTINGS
@given(n_blocks=st.integers(1, 40), speeds=st.lists(st.floats(0.0, 1.0),
                                                     min_size=0, max_size=8))
def test_stage_partition_equal(n_blocks, speeds):
    _same(jhet.stage_partition, thet.stage_partition, n_blocks, speeds)


@SETTINGS
@given(occ=st.lists(st.floats(0.0, 0.95), min_size=1, max_size=6),
       measured=st.lists(st.floats(0.05, 1.0), min_size=6, max_size=6),
       rounds=st.integers(1, 4))
def test_profiler_and_cluster_equal(occ, measured, rounds):
    caps = [1.0 - 0.1 * i for i in range(len(occ))]
    jc, tc = jhet.make_cluster(occ, caps), thet.make_cluster(occ, caps)
    assert [dataclasses.astuple(d) for d in jc] == \
        [dataclasses.astuple(d) for d in tc]
    assert jhet.speeds(jc) == thet.speeds(tc)
    jp = jhet.OnlineProfiler(jhet.speeds(jc), alpha=0.5)
    tp = thet.OnlineProfiler(thet.speeds(tc), alpha=0.5)
    cm_j, cm_t = jsim.CostModel(1e-3, 5e-4), tsim.CostModel(1e-3, 5e-4)
    n = len(occ)
    subs, rows = [2] * n, [3 + i for i in range(n)]
    for _ in range(rounds):
        jhet.feed_profiler(jp, cm_j, subs, rows, measured[:n])
        thet.feed_profiler(tp, cm_t, subs, rows, measured[:n])
    assert jp.speeds == tp.speeds
    assert jp.drift(jhet.speeds(jc)) == tp.drift(thet.speeds(tc))


# ----------------------------------------------------------------------
# planners
# ----------------------------------------------------------------------

@SETTINGS
@given(speeds=st.lists(st.floats(0.1, 1.0), min_size=1, max_size=6),
       name=st.sampled_from(["uniform", "spatial", "temporal", "stadi",
                             "makespan"]),
       p_total=st.sampled_from([8, 32, 64]),
       tiers=st.sampled_from([(1, 2), (1, 2, 4)]))
def test_planners_equal(speeds, name, p_total, tiers):
    from repro.core.hetero import DeviceProfile as JD
    from repro_torch.core.hetero import DeviceProfile as TD
    knobs_j = JStadiConfig(cluster=(JD("d"),), m_base=16, m_warmup=4,
                           tiers=tiers)
    knobs_t = TStadiConfig(cluster=(TD("d"),), m_base=16, m_warmup=4,
                           tiers=tiers)
    try:
        want = jplan.get_planner(name)(speeds, knobs_j, p_total)
    except ValueError:
        with pytest.raises(ValueError):
            tplan.get_planner(name)(speeds, knobs_t, p_total)
        return
    got = tplan.get_planner(name)(speeds, knobs_t, p_total)
    assert _plain(got) == _plain(want)
    assert got.active == want.active


def test_planner_registry():
    assert set(tplan.PLANNERS) == {"uniform", "spatial", "temporal", "stadi",
                                   "makespan", "stadi_pipefuse",
                                   "stadi_guidance", "stadi_seq"}
    assert set(tplan.PLANNERS) <= set(jplan.PLANNERS)
    with pytest.raises(KeyError):
        tplan.get_planner("nope")


# ----------------------------------------------------------------------
# comm
# ----------------------------------------------------------------------

def test_exchange_registry_equal():
    assert set(tcomm.EXCHANGES) == {"sync", "stale_async", "predictive",
                                    "ring"}
    assert tcomm.EXCHANGE_KINDS == jcomm.EXCHANGE_KINDS
    for name in tcomm.EXCHANGES:
        for refresh in (1, 2, 3, 5):
            j, t = jcomm.get_exchange(name, refresh), tcomm.get_exchange(name, refresh)
            assert dataclasses.astuple(j) == dataclasses.astuple(t)
            assert [j.kind(b) for b in range(12)] == [t.kind(b) for b in range(12)]
    with pytest.raises(KeyError):
        tcomm.get_exchange("nope")
    with pytest.raises(ValueError):
        tcomm.get_exchange("stale_async", 0)


@SETTINGS
@given(sizes=st.lists(st.integers(0, 32), min_size=0, max_size=8))
def test_wire_rows_equal(sizes):
    assert tcomm.uneven_all_gather_rows(sizes) == jcomm.uneven_all_gather_rows(sizes)
    assert tcomm.ring_hop_rows(sizes) == jcomm.ring_hop_rows(sizes)


# ----------------------------------------------------------------------
# events
# ----------------------------------------------------------------------

plan_st = st.builds(
    lambda speeds, mb, mw, tiers: (speeds, mb, mw, tiers),
    st.lists(st.floats(0.1, 1.0), min_size=1, max_size=5),
    st.sampled_from([8, 16, 24]), st.sampled_from([0, 2, 4]),
    st.sampled_from([(1, 2), (1, 2, 4)]))
policy_st = st.tuples(st.sampled_from(["sync", "stale_async", "predictive"]),
                      st.integers(1, 4))


def _plan_pair(speeds, mb, mw, tiers, p_total=16):
    try:
        jp = jsl.temporal_allocation(speeds, mb, mw, tiers=tiers)
    except ValueError:
        return None
    patches = jsl.spatial_allocation(speeds, jp.steps, p_total)
    tp = tsl.TemporalPlan(**dataclasses.asdict(jp))
    return jp, tp, patches


@SETTINGS
@given(p=plan_st, pol=policy_st)
def test_lower_replay_and_trace_equal(p, pol):
    pair = _plan_pair(*p)
    if pair is None:
        return
    jp, tp, patches = pair
    jpol, tpol = jcomm.get_exchange(*pol), tcomm.get_exchange(*pol)
    assert _plain(list(tev.lower(tp, patches, tpol))) == \
        _plain(list(jev.lower(jp, patches, jpol)))
    assert _plain(tev.replay(tp, patches, tpol)) == \
        _plain(jev.replay(jp, patches, jpol))
    jcfg = jax_get_config("tiny-dit").reduced()
    tcfg = get_config("tiny-dit").reduced()
    jt = jsim.build_trace(jp, patches, jcfg, batch=2, exchange=pol[0],
                          exchange_refresh=pol[1])
    tt = tsim.build_trace(tp, patches, tcfg, batch=2, exchange=pol[0],
                          exchange_refresh=pol[1])
    assert _plain(tt) == _plain(jt)
    cm = dict(t_fixed=1e-3, t_row=5e-4, t_ctx=2e-6, link_bw=1e9)
    speeds = list(p[0])
    assert tsim.simulate_trace(tt, speeds, tsim.CostModel(**cm)) == \
        jsim.simulate_trace(jt, speeds, jsim.CostModel(**cm))


def _drive_with_replan(ev_mod, plan, patches, new_plan, new_patches):
    gen = ev_mod.lower(plan, patches)
    seen, sent = [], False
    ev = next(gen)
    while True:
        seen.append(ev)
        try:
            if isinstance(ev, ev_mod.Exchange) and not sent and ev.fine_step >= 4:
                ev = gen.send((new_plan, new_patches))
                sent = True
            else:
                ev = next(gen)
        except StopIteration:
            return seen


def test_lower_replan_via_send_equal():
    """tests/test_events.py::test_lower_replan_via_send on both packages."""
    jargs = (jsl.TemporalPlan([8, 8], [1, 1], [False, False], 8, 2), [4, 4],
             jsl.TemporalPlan([4, 4], [1, 1], [False, False], 4, 0), [6, 2])
    targs = (tsl.TemporalPlan([8, 8], [1, 1], [False, False], 8, 2), [4, 4],
             tsl.TemporalPlan([4, 4], [1, 1], [False, False], 4, 0), [6, 2])
    got = _drive_with_replan(tev, *targs)
    assert _plain(got) == _plain(_drive_with_replan(jev, *jargs))
    assert sum(isinstance(e, tev.Replan) for e in got) == 1


def test_fit_cost_model_equal():
    rows, times = [1, 2, 4, 8], [0.011, 0.013, 0.019, 0.031]
    assert dataclasses.asdict(tsim.fit_cost_model(rows, times)) == \
        dataclasses.asdict(jsim.fit_cost_model(rows, times))
    cm = tsim.CostModel(1e-3, 1e-4, t_ctx=1e-6, t_xattn=1e-7)
    jcm = jsim.CostModel(1e-3, 1e-4, t_ctx=1e-6, t_xattn=1e-7)
    assert (cm.step_time(5, 0.5), cm.attn_time(64, 1.0, 0.5),
            cm.xattn_time(5, 8, 0.5)) == \
        (jcm.step_time(5, 0.5), jcm.attn_time(64, 1.0, 0.5),
         jcm.xattn_time(5, 8, 0.5))


def test_simulate_refuses_later_axes():
    tp = tsl.TemporalPlan([8, 8], [1, 1], [False, False], 8, 2)
    trace = tsim.build_trace(tp, [4, 4], get_config("tiny-dit").reduced())
    trace.stages = [1, 1]                 # the pipefuse slice prices stages
    assert tsim.simulate_trace(trace, [1.0, 1.0],
                               tsim.CostModel(1e-3, 1e-3)) > 0.0
    trace = tsim.build_trace(tp, [4, 4], get_config("tiny-dit").reduced())
    trace.frames = object()
    with pytest.raises(NotImplementedError, match="frames"):
        tsim.simulate_trace(trace, [1.0, 1.0], tsim.CostModel(1e-3, 1e-3))
