"""The join of the program's spans to device events (``portbench/program.py``)
on synthetic spans, launches and device operations."""
import numpy as np
import pytest

from portbench import program


def _span(name, s, e, parent=None, **attrs):
    return (name, s, e, parent, attrs)


def _image(t0, forwards=((100, 500),), exchanges=()):
    """The spans of one image starting at ``t0``: a ``generate`` span over
    1000 ns, its forwards, and its exchanges ``(seq, bytes, start, end)``."""
    out = [_span("generate", t0, t0 + 1000, backend="emulated")]
    for s, e in forwards:
        out.append(_span("forward", t0 + s, t0 + e, 0, batch=1, tokens=64))
    for seq, nbytes, s, e in exchanges:
        out.append(_span("exchange", t0 + s, t0 + e, 0, seq=seq,
                         bytes_in=nbytes, bytes_out=nbytes))
    return out


def _concat(*images):
    """Recorded spans of several images, parents re-indexed."""
    out = []
    for img in images:
        base = len(out)
        out += [(n, s, e, None if p is None else p + base, a)
                for n, s, e, p, a in img]
    return out


def test_device_time_goes_to_the_span_that_launched_it():
    spans = [_span("engine.round", 0, 1000, index=0, lanes=2),
             _span("engine.state", 100, 200, 0),
             _span("forward", 300, 600, 0, batch=2, tokens=64),
             _span("engine.state", 700, 800, 0)]
    launches = {1: 150, 2: 350, 3: 400, 4: 750, 5: 900}
    ops = [(1000, 1100, "index_kernel", 1), (1100, 1400, "gemm", 2),
           (1400, 1500, "gemm", 3), (1500, 1550, "copy", 4),
           (1600, 1650, "other", 5)]
    s = program.summarize({"spans": spans, "counters": {}}, ops, launches,
                          (0, 2000))
    assert s["unmatched"] == 0 and s["ops"] == 5
    assert s["forward_ops"] == 2
    assert s["state_s"] == pytest.approx(150e-9)
    assert s["device_s"] == pytest.approx({"engine.state": 150e-9,
                                           "forward": 400e-9,
                                           "engine.round": 50e-9})
    assert s["rounds"] == 1
    assert program.state_ms_per_round([s]) == pytest.approx(150e-6)


def test_innermost_open_span_walks_up_past_closed_siblings():
    spans = [_span("generate", 0, 1000), _span("forward", 100, 200, 0),
             _span("forward", 300, 400, 0)]
    tree = program._Tree(spans)
    assert tree.innermost(150) == 1
    assert tree.innermost(250) == 0        # between the forwards: generate
    assert tree.innermost(1500) is None
    assert tree.innermost(-1) is None


def test_idle_gaps_go_to_the_innermost_span_open_across_them():
    spans = [_span("generate", 0, 1000), _span("forward", 100, 500, 0)]
    ops = [(0, 100, "a", 1), (300, 400, "b", 2), (900, 1000, "c", 3)]
    launches = {1: 0, 2: 150, 3: 600}
    s = program.summarize({"spans": spans}, ops, launches, (0, 1000))
    # gaps: [100, 300] mid 200 (forward), [400, 900] mid 650 (generate)
    assert s["idle_s"] == pytest.approx({"forward": 200e-9,
                                         "generate": 500e-9})


def test_host_us_per_op_takes_host_time_outside_the_stretch():
    # three images; the second is the traced stretch, where the profiler
    # slows the forward's host code
    imgs = [_image(0, ((100, 500),)), _image(2000, ((100, 900),)),
            _image(4000, ((100, 600),))]
    launches = {1: 2150, 2: 2200, 3: 2950}   # two in the forward, one not
    ops = [(2300, 2400, "a", 1), (2400, 2500, "b", 2), (2960, 2990, "c", 3)]
    s = program.summarize({"spans": _concat(*imgs)}, ops, launches,
                          (2000, 3000))
    assert (s["images_in"], s["images_out"], s["forward_ops"]) == (1, 2, 2)
    # outside: (400 + 500) ns / 2 images = 450 ns an image, over 2 ops
    assert program.host_us_per_op([s]) == pytest.approx(450e-3 / 2)
    assert program.profiler_host_cost([s]) == pytest.approx(800 / 450)


def _rank(starts, end, unmatched=0, extra_kernel=False, images=1):
    """One rank's summary of two collectives (seq 0 and 1) whose NCCL
    kernels start at ``starts`` and end at ``end`` (plus 5000 for seq 1)."""
    spans, ops, launches = [], [], {}
    corr = 0
    for k in range(images):
        t0 = k * 100_000
        ex = [(q, 1000, 100 + q * 5000, 4000 + q * 5000) for q in range(2)]
        img = _image(t0, forwards=(), exchanges=ex)
        spans = _concat(spans, img)
        for q in range(2):
            n = 2 if (extra_kernel and q == 1) else 1
            for _ in range(n):
                corr += 1
                launches[corr] = t0 + 200 + q * 5000
                ops.append((t0 + starts + q * 5000, t0 + end + q * 5000,
                            "ncclDevKernel_AllGather_RING_LL", corr))
    for _ in range(unmatched):
        corr += 1
        ops.append((50, 60, "orphan", corr))
    ops.sort()
    return program.summarize({"spans": spans, "counters": {
        "exchange.bytes_in": 2000 * images}}, ops, launches,
        (0, images * 100_000))


def test_exchange_splits_waiting_from_moving():
    # three ranks; the last launches 3000 ns late, the first 1000 ns late
    sums = [_rank(1000, 4000), _rank(0, 4000), _rank(3000, 4000)]
    # waits a collective: 2000, 3000, 0 -> mean 5000/3 ns; two collectives
    assert program.exchange_wait_ms_per_image(sums) == pytest.approx(
        2 * 5000 / 3 * 1e-6)
    # every rank moves 1000 bytes in (4000 - 3000) ns a collective: 1 GB/s
    assert program.exchange_gbps(sums) == pytest.approx(1.0)
    assert sums[0]["bytes_in_per_image"] == 2000
    assert "2 collectives on every rank" in program.lines(sums)[-1]


def test_exchange_gives_nothing_when_counts_or_clocks_disagree():
    ok = [_rank(0, 4000), _rank(0, 4000)]
    assert program.exchange_gbps(ok) is not None
    two_kernels = [_rank(0, 4000), _rank(0, 4000, extra_kernel=True)]
    assert program.exchange_gbps(two_kernels) is None
    assert program.exchange_wait_ms_per_image(two_kernels) is None
    assert "without one NCCL kernel" in program.lines(two_kernels)[-1]
    skewed = [_rank(0, 4000), _rank(0, 4000 + 150_000)]
    assert program.exchange_gbps(skewed) is None
    assert "clocks disagree" in program.lines(skewed)[-1]


def test_the_join_gives_nothing_over_one_percent_unmatched():
    # 4 matched operations: one orphan is 20 %
    sums = [_rank(0, 4000, unmatched=1)]
    assert not program.joined(sums[0])
    assert program.exchange_gbps(sums) is None
    many = _rank(0, 4000, images=60)           # 240 matched operations
    assert program.joined(many)
    assert program.exchange_gbps([many]) is not None
    s = program.summarize({"spans": [_span("engine.round", 0, 10),
                                     _span("engine.state", 1, 5, 0)]},
                          [(20, 30, "k", 1), (30, 40, "k", 2)], {1: 2},
                          (0, 100))
    assert s["unmatched"] == 1
    assert program.state_ms_per_round([s]) is None


def test_queue_wait_counts_a_request_never_admitted():
    stamps = [(0, 10**9), (0, 2 * 10**9)] + [(0, 10**8)] * 8
    got = program.queue_wait_p88(stamps + [(0, None)], 5 * 10**9)
    want = np.percentile([1.0, 2.0] + [0.1] * 8 + [5.0], 88)
    assert got == pytest.approx(want)
    assert program.queue_wait_p88([], 0) is None


def test_recorded_spans_join_as_recorded():
    """The recorder's own ``take()`` feeds the join unchanged."""
    from repro_torch import spans

    spans.disable()
    spans.take()
    spans.enable()
    try:
        with spans.span("generate", backend="emulated") as g:
            with spans.span("forward", batch=1, tokens=64) as f:
                pass
        taken = spans.take()
    finally:
        spans.disable()
    ops = [(g.end_ns + 10, g.end_ns + 20, "k", 7)]
    s = program.summarize(taken, ops, {7: f.start_ns}, (g.start_ns,
                                                        g.end_ns + 30))
    assert s["forward_ops"] == 1 and s["images_in"] == 1
