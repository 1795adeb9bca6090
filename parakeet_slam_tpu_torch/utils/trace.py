"""The program's spans and counters: named stretches of host work and
running counts, kept in memory; off by default.

    from parakeet_slam_tpu_torch.utils import trace
    trace.reset(); trace.enable()
    with trace.span("frame", rid=i):
        with trace.span("frame.upload.wait", wait=True):
            stream.synchronize()
    trace.count("keyframes")
    trace.disable()
    trace.spans(), trace.counters()

Off (the default), `span()` returns one shared context manager that does
nothing and `count()` returns at once: a site costs one test of a module
flag; no clock is read, nothing is allocated and no profiler range is
entered. The one exception is a CUDA graph's capture (`recording()`, which
`filter/captured.CapturedStep` opens around it): the counts made while it
records, tracer on or off, are the captured work's, kept by the step and
added again after each replay (`add`), as the kernel wrappers' launches
are; the capture itself runs nothing, so they are not counted then.

On, each span records its name, its start and end from `time.time_ns()`,
the index of the span it was opened in (-1 for none), `rid` (a frame's
index, a solve's number: a span opened without one takes its parent's, so
every span of a frame or a solve shares it) and `wait`
(the span does nothing but block on the device: a device-to-host read, a
synchronise). A span's self time, its host time outside its waits, is its
duration less that of the outermost wait spans under it (`self_ns`).

`time.time_ns()` is the clock that the profiler (Kineto) stamps its host
events on, and CUPTI's device timestamps are brought onto it: a span lands
on a `torch.profiler` trace's timeline at `(t_ns - trace_start_ns) / 1000`
microseconds, with `trace_start_ns` the profile's
`prof.profiler.kineto_results.trace_start_ns()`.

The state is the process's own, one host thread's: spans opened on two
threads at once would nest wrongly."""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int   # index into spans(), -1 for a span opened in none
    rid: int | None
    wait: bool


class _Off:
    """The shared context manager of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_spans: list = []      # Span, or [name, start, None, parent, rid, wait] while open
_open: list = []       # indices of the open spans, innermost last
_counters: dict = {}
_rec: dict | None = None   # the counts of the capture that records now
_live = False              # _on, or a capture recording: count() records


class _On:
    __slots__ = ("name", "rid", "wait", "i", "rec")

    def __init__(self, name, rid, wait):
        self.name, self.rid, self.wait = name, rid, wait

    def __enter__(self):
        parent = _open[-1] if _open else -1
        rid = self.rid if self.rid is not None or parent < 0 else _spans[parent][4]
        self.i, self.rec = len(_spans), [self.name, time.time_ns(), None, parent, rid, self.wait]
        _spans.append(self.rec)
        _open.append(self.i)
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        i, r = self.i, self.rec
        if i < len(_spans) and _spans[i] is r:  # not forgotten by a reset meanwhile
            _spans[i] = Span(r[0], r[1], end, r[3], r[4], r[5])
            _open.pop()
        return False


def span(name: str, rid: int | None = None, wait: bool = False):
    """A context manager that records the enclosed host work as a span."""
    if not _on:
        return _OFF
    return _On(name, rid, wait)


def count(name: str, n=1) -> None:
    """Add n to counter `name` (while a capture records, to its counts)."""
    if not _live:
        return
    into = _counters if _rec is None else _rec
    into[name] = into.get(name, 0) + n


def add(counts: dict) -> None:
    """Add a recorded capture's counts to the counters: once a replay."""
    if not _on:
        return
    for name, n in counts.items():
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """While a CUDA graph captures: `count()` records into the dict this
    yields, whether the tracer is on or off, and not into the counters."""
    global _rec, _live
    outer, _rec = _rec, {}
    _live = True
    try:
        yield _rec
    finally:
        _rec = outer
        _live = _on or _rec is not None


def enable() -> None:
    global _on, _live
    _on = _live = True


def disable() -> None:
    global _on, _live
    _on = False
    _live = _rec is not None


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span and counter (spans still open stay open, unrecorded)."""
    _spans.clear()
    _open.clear()
    _counters.clear()


def spans() -> list[Span]:
    """The closed spans, in the order they were opened; `parent` indexes
    this list (a parent still open, or forgotten by `reset`, reads -1)."""
    index, out = {}, []
    for i, s in enumerate(_spans):
        if isinstance(s, Span):
            index[i] = len(out)
            out.append(s)
    return [s._replace(parent=index.get(s.parent, -1)) for s in out]


def counters() -> dict:
    return dict(_counters)


def self_ns(spans_: list[Span], i: int) -> int:
    """Span i's duration less the outermost wait spans under it."""
    kids: dict = {}
    for j, s in enumerate(spans_):
        kids.setdefault(s.parent, []).append(j)
    waited, todo = 0, list(kids.get(i, []))
    while todo:
        j = todo.pop()
        if spans_[j].wait:
            waited += spans_[j].end_ns - spans_[j].start_ns
        else:
            todo.extend(kids.get(j, []))
    return spans_[i].end_ns - spans_[i].start_ns - waited
