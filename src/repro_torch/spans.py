"""The port's one store of spans and counters: host intervals of the
program's layers and counts of their work, kept in memory per process.

    from repro_torch import spans
    spans.enable()
    with spans.span("forward", batch=1, tokens=4096):
        ...
    spans.count("exchange.bytes_in", n)
    got = spans.take()      # {"spans": [...], "counters": {...}}, cleared

A span is ``(name, start_ns, end_ns, parent, attrs)``: its host interval on
``time.time_ns()``, the clock torch's profiler stamps device events with,
so a device operation can be placed in the span whose host interval holds
its launch; ``parent`` is the index (in the same list) of the innermost
span open when it opened, or None, so a layer's self time is its span less
its children. Spans nest within one thread: the engine, the pipeline and a
rank's executor each run in one.

The recorder is off by default and nothing in the program turns it on.
Off, :func:`span` returns one shared object that does nothing (no clock is
read, nothing is recorded) and :func:`count` adds nothing. Each process
keeps its own, so each rank of a multi-rank run records its own.

The kernels' launch counters (``repro_torch.kernels.ops.launch_counts``)
are the always-on part of the counter table, under ``launch.<kernel>``:
they count whether the recorder is on or not, and :func:`take` leaves them
(``ops.reset_launch_counts`` clears them).
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

#: counters under this prefix always count (the kernels' launches)
LAUNCH = "launch."

_on = False
_spans: List[list] = []          # [name, start_ns, end_ns, parent, attrs]
_open: List[int] = []            # indices of the open spans, innermost last
_counters: collections.Counter = collections.Counter()


class _Off:
    """What :func:`span` returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class Span:
    """A host interval on ``time.time_ns()``: ``start_ns`` and ``end_ns``
    are read on entry and exit, and the span is recorded if the recorder
    was on at entry."""
    __slots__ = ("name", "attrs", "start_ns", "end_ns", "_rec")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = None
        self._rec = None

    def __enter__(self):
        self.start_ns = time.time_ns()
        if _on:
            self._rec = [self.name, self.start_ns, None,
                         _open[-1] if _open else None, self.attrs]
            _open.append(len(_spans))
            _spans.append(self._rec)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._rec is not None:
            self._rec[2] = self.end_ns
            if _open and _spans[_open[-1]] is self._rec:
                _open.pop()
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def span(name: str, **attrs):
    """A span of ``name`` while the recorder is on, else :data:`OFF`."""
    return Span(name, attrs) if _on else OFF


def timed(name: str, **attrs) -> Span:
    """A span whose stamps the caller reads whether the recorder is on or
    not (two clock reads): for a layer that reports its own wall seconds on
    the recorder's clock."""
    return Span(name, attrs)


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to a counter while the recorder is on (a ``launch.``
    counter always); returns the counter's value."""
    if _on or name.startswith(LAUNCH):
        _counters[name] += n
    return _counters[name]


def counters() -> Dict[str, int]:
    """Copy of the counter table."""
    return dict(_counters)


def reset(prefix: str) -> None:
    """Clear the counters whose names start with ``prefix``."""
    for name in [k for k in _counters if k.startswith(prefix)]:
        del _counters[name]


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> Dict:
    """The recorded spans (closed ones, as tuples, with their parents'
    indices) and the counters, and clears both; the ``launch.`` counters
    stay. A span still open is dropped, and its children lose their
    parent."""
    global _spans
    recs, _spans = _spans, []
    _open.clear()
    keep: Dict[int, Optional[int]] = {}
    out = []
    for i, (name, s, e, parent, attrs) in enumerate(recs):
        if e is None:
            continue
        keep[i] = len(out)
        out.append((name, s, e, keep.get(parent), dict(attrs)))
    got = {"spans": out, "counters": dict(_counters)}
    for name in [k for k in _counters if not k.startswith(LAUNCH)]:
        del _counters[name]
    return got
