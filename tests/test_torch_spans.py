"""The port's span and counter recorder (``repro_torch.spans``) and the
spans the program records: off it records nothing and reads no clock; on
it nests spans on ``time.time_ns()``; the kernels' launch counters are its
always-on part; the exchange's spans agree across 4 gloo ranks and carry
the wire bytes of the plan's arithmetic; the serving engine stamps every
request's submit, admission and completion on the same clock."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import comm, sampler  # noqa: E402
from repro_torch.core.pipeline import StadiConfig, StadiPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models.diffusion import dit  # noqa: E402
from repro_torch.serving import DiffusionServingEngine  # noqa: E402

RANK_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module's tiny shapes (the suite runs in
    several worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


class _Clock:
    """A fake ``time.time_ns``: 10, 20, 30, ..."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        self.now += 10
        return self.now


def _no_clock():
    raise AssertionError("the clock was read")


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    monkeypatch.setattr(spans.time, "time_ns", _no_clock)
    s = spans.span("forward", batch=1, tokens=64)
    assert s is spans.OFF and spans.span("other") is spans.OFF
    with s as inner:
        inner.set(admitted=3)
    assert spans.count("exchange.calls") == 0
    assert spans.take() == {"spans": [], "counters": {}}


def test_on_nests_spans_and_take_clears(monkeypatch):
    monkeypatch.setattr(spans.time, "time_ns", _Clock())
    spans.enable()
    with spans.span("engine.round", index=0):
        with spans.span("engine.state"):
            pass
        with spans.span("forward", batch=2) as f:
            with spans.span("exchange", seq=0):
                pass
            f.set(tokens=64)
    with spans.span("generate"):
        pass
    assert spans.count("exchange.calls") == 1
    assert spans.count("exchange.calls", 2) == 3
    got = spans.take()
    assert got["spans"] == [
        ("engine.round", 10, 80, None, {"index": 0}),
        ("engine.state", 20, 30, 0, {}),
        ("forward", 40, 70, 0, {"batch": 2, "tokens": 64}),
        ("exchange", 50, 60, 2, {"seq": 0}),
        ("generate", 90, 100, None, {}),
    ]
    assert got["counters"] == {"exchange.calls": 3}
    assert spans.take() == {"spans": [], "counters": {}}


def test_stamps_are_on_time_ns():
    spans.enable()
    t0 = time.time_ns()
    with spans.span("forward"):
        time.sleep(0.001)
    t1 = time.time_ns()
    ((_, s, e, _, _),) = spans.take()["spans"]
    assert t0 <= s < e <= t1 and e - s >= 1_000_000


def test_timed_reads_its_stamps_off_and_records_only_on(monkeypatch):
    monkeypatch.setattr(spans.time, "time_ns", _Clock())
    with spans.timed("engine.round", index=0) as r:
        pass
    assert (r.start_ns, r.end_ns) == (10, 20) and r.seconds == 10e-9
    assert spans.take()["spans"] == []
    spans.enable()
    with spans.timed("engine.round", index=1) as r:
        r.set(lanes=2)
    assert spans.take()["spans"] == [
        ("engine.round", 30, 40, None, {"index": 1, "lanes": 2})]


def test_a_span_open_across_take_is_dropped():
    spans.enable()
    with spans.span("outer"):
        spans.take()
        with spans.span("inner"):
            pass
    assert [s[0] for s in spans.take()["spans"]] == ["inner"]


def test_launch_counters_are_the_always_on_part():
    ops.reset_launch_counts()
    spans.count("launch.stale_kv_attention")
    spans.count("launch.stale_kv_attention")
    spans.count("launch.cfg_epilogue")
    assert ops.launch_counts() == {"stale_kv_attention": 2, "cfg_epilogue": 1}
    spans.enable()
    spans.count("exchange.calls")
    got = spans.take()["counters"]
    assert got == {"launch.stale_kv_attention": 2, "launch.cfg_epilogue": 1,
                   "exchange.calls": 1}
    assert ops.launch_counts() == {"stale_kv_attention": 2, "cfg_epilogue": 1}
    ops.reset_launch_counts()
    assert ops.launch_counts() == {}


# ----------------------------------------------------------------------
# the program's spans
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny-dit").reduced()
    gen = torch.Generator().manual_seed(0)
    params = dit.nondegenerate_params(dit.init_params(gen, cfg), gen)
    return cfg, params


def _pipe(tiny, occupancies=(0.0, 0.5), backend="emulated"):
    cfg, params = tiny
    config = StadiConfig.from_occupancies(list(occupancies), m_base=8,
                                          m_warmup=2, backend=backend)
    return StadiPipeline(cfg, params, sampler.linear_schedule(100), config,
                         device="cpu")


def _x(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, cfg.latent_size, cfg.latent_size, cfg.channels),
                       generator=g)


def test_generate_spans_its_forwards(tiny):
    cfg, _ = tiny
    pipe = _pipe(tiny)
    spans.enable()
    pipe.generate(_x(cfg, 0), torch.tensor([1]))
    recorded = spans.take()["spans"]
    assert recorded[0][:1] == ("generate",) and recorded[0][3] is None
    assert recorded[0][4] == {"backend": "emulated"}
    forwards = [s for s in recorded if s[0] == "forward"]
    assert forwards and all(s[3] == 0 for s in forwards)
    assert {s[4]["batch"] for s in forwards} == {1}
    full = cfg.n_tokens
    assert max(s[4]["tokens"] for s in forwards) == full
    assert all(0 < s[4]["tokens"] <= full for s in forwards)


def _engine_run(tiny, on: bool):
    cfg, _ = tiny
    engine = DiffusionServingEngine(_pipe(tiny), slots=2)
    for j in range(4):
        engine.submit(_x(cfg, j), j % 3, cfg_scale=3.0 if j % 2 else None)
    if on:
        spans.enable()
    engine.run_to_completion()
    return engine, spans.take()["spans"]


def test_engine_stamps_submit_admit_done_on_one_clock(tiny):
    t0 = time.time_ns()
    engine, recorded = _engine_run(tiny, on=False)
    t1 = time.time_ns()
    assert recorded == []
    done = engine.completed
    assert len(done) == 4 and {r.guided for r in done} == {True, False}
    for r in done:
        assert t0 <= r.submit_ns <= r.admit_ns <= r.done_ns <= t1
        assert r.wall_latency_s == (r.done_ns - r.submit_ns) * 1e-9
    # two slots: the last two requests waited for the first two
    late = sorted(done, key=lambda r: r.uid)[2:]
    assert all(r.queue_rounds > 0 and r.admit_ns > r.submit_ns for r in late)
    assert all(rep.wall_s > 0 for rep in engine.rounds)


def test_engine_round_spans_give_wall_seconds_and_nest_state(tiny):
    engine, recorded = _engine_run(tiny, on=True)
    rounds = [i for i, s in enumerate(recorded) if s[0] == "engine.round"]
    assert len(rounds) == len(engine.rounds)
    for i, rep in zip(rounds, engine.rounds):
        name, s, e, parent, attrs = recorded[i]
        assert parent is None and attrs["index"] == rep.index
        assert rep.wall_s == (e - s) * 1e-9
        assert attrs["lanes"] == len(rep.warmup_lanes) + len(rep.adaptive_lanes)
    names = {s[0] for s in recorded}
    assert {"engine.admit", "engine.state", "engine.retire",
            "forward"} <= names
    for name, s, e, parent, attrs in recorded:
        if name in ("engine.admit", "engine.retire"):
            assert recorded[parent][0] == "engine.round"
        if name == "engine.state":
            assert recorded[parent][0] in ("engine.round", "engine.retire")
    admitted = sum(s[4]["admitted"] for s in recorded
                   if s[0] == "engine.admit")
    finished = sum(s[4]["finished"] for s in recorded
                   if s[0] == "engine.retire")
    assert admitted == finished == 4


# ----------------------------------------------------------------------
# the exchange on 4 gloo ranks
# ----------------------------------------------------------------------

SIZES = ([2, 2, 2, 2], [3, 1, 4, 2], [3, 0, 2, 1])


def _exchange_rank(ctx, sizes_list, tiny_params):
    torch.set_num_threads(1)
    spans.enable()
    for sizes in sizes_list:
        local = torch.zeros(2, max(sizes), 3, dtype=torch.bfloat16)
        comm.uneven_all_gather_padded(local, sizes, None, axis=1)
        comm.uneven_all_gather_broadcast(local, sizes, None, axis=1)
    gathers = spans.take()
    cfg, params = tiny_params
    config = StadiConfig.from_occupancies([0.0] * ctx.world, m_base=8,
                                          m_warmup=2, backend="spmd")
    pipe = StadiPipeline(cfg, params, sampler.linear_schedule(100), config,
                         device="cpu")
    spans.enable()
    pipe.generate(_x(cfg, 0), torch.tensor([1]))
    return gathers, spans.take()


@pytest.fixture(scope="module")
def exchanged(tiny):
    return ranks.spawn(_exchange_rank, 4, device_type="cpu",
                       args=(SIZES, tiny), timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("case", range(len(SIZES)))
def test_exchange_bytes_are_the_plans_wire_rows(exchanged, case):
    """Each gather's span carries this rank's wire bytes: the padded
    gather's ``uneven_all_gather_rows`` rows, the broadcasts' other
    sources' real rows; a row here is 2 x 3 bf16 values, 12 bytes."""
    sizes = SIZES[case]
    for rank, (gathers, _) in enumerate(exchanged):
        padded, bcast = gathers["spans"][2 * case:2 * case + 2]
        assert padded[0] == bcast[0] == "exchange"
        assert padded[4]["seq"] == 2 * case and bcast[4]["seq"] == 2 * case + 1
        rows = comm.uneven_all_gather_rows(sizes)
        assert padded[4]["bytes_in"] == padded[4]["bytes_out"] == rows * 12
        assert bcast[4]["bytes_in"] == (sum(sizes) - sizes[rank]) * 12
        assert bcast[4]["bytes_out"] == sizes[rank] * 3 * 12


def test_exchange_counters_add_up_the_spans(exchanged):
    for gathers, _ in exchanged:
        xs = gathers["spans"]
        assert gathers["counters"] == {
            "exchange.calls": len(xs),
            "exchange.bytes_in": sum(s[4]["bytes_in"] for s in xs)}


def test_spmd_ranks_agree_on_the_exchange_seq(exchanged):
    """Every rank of a spmd generate records the same exchanges in the
    same order, and each is the padded gather's wire rows of its shape."""
    per_rank = [[s for s in run["spans"] if s[0] == "exchange"]
                for _, run in exchanged]
    seqs = [[s[4]["seq"] for s in xs] for xs in per_rank]
    assert seqs[0] == list(range(len(seqs[0]))) and len(seqs[0]) > 2
    assert all(q == seqs[0] for q in seqs)
    assert all([s[4]["bytes_in"] for s in xs] ==
               [s[4]["bytes_in"] for s in per_rank[0]] for xs in per_rank)
    for _, run in exchanged:
        xs = [s for s in run["spans"] if s[0] == "exchange"]
        assert run["counters"]["exchange.bytes_in"] == sum(
            s[4]["bytes_in"] for s in xs)
        generate = [i for i, s in enumerate(run["spans"])
                    if s[0] == "generate"]
        assert len(generate) == 1
        assert all(s[3] == generate[0] for s in xs)
        assert np.all(np.array([s[4]["bytes_in"] for s in xs]) > 0)
