"""The program's own spans and counters in a run (the port's
`utils/trace.py`), and the arithmetic that the readers of `program_span`
metrics and the idle-gap labels do with them.

A driver brackets its window with `w = window_begin(run)` and
`window_end(run, w)`. With `--trace 1` they reset and turn on the program's
tracer and run the card's clock sampler (`clocks.py`) beside the window,
and afterwards put into `run.counters`: the program's counters
(`program_counters`), each `flush` span's self time (`flush_self_ms`: its
host time outside its waits), each solve's `ba.problem` and `ba.pack` time
(`ba_pack_ms`) and the clock samples (`clock_samples`); they print the
counters, each span name's count and durations, and the clocks as notes.
With `--trace 0` they do nothing: the tracer stays off.

`stretch_spans(trace_start_ns, wall_s)` brings the spans of a profiled
stretch onto the profiler's clock (microseconds since the profile's
`trace_start_ns`): the tracer stamps its spans with `time.time_ns()`, the
clock that the profiler stamps its host events on and brings CUPTI's
device timestamps onto. A span on that clock is (name, start_us, end_us,
parent, rid, wait), with `parent` an index into the same list or -1."""

from __future__ import annotations

import statistics

FLUSH = ("flush",)
PACK = ("ba.problem", "ba.pack")


def _tracer():
    from parakeet_slam_tpu_torch.utils import trace

    return trace


def window_begin(run):
    """At the window's start: with `--trace 1`, the program's tracer reset
    and on, and the clock sampler started and returned (else None)."""
    if not run.trace:
        return None
    from slambench.harness import clocks

    tr = _tracer()
    tr.reset()
    tr.enable()
    return clocks.Sampler().start()


def window_end(run, sampler) -> None:
    """After the window: the tracer off, `sampler` (what `window_begin`
    returned) stopped, and the window's aggregates in `run.counters` (see
    the module docstring)."""
    if not run.trace:
        return
    tr = _tracer()
    tr.disable()
    spans = tr.spans()
    counters = tr.counters()
    run.counters["program_counters"] = counters
    run.counters["flush_self_ms"] = [tr.self_ns(spans, i) / 1e6 for i, s in enumerate(spans)
                                     if s.name in FLUSH]
    run.counters["ba_pack_ms"] = pack_ms_per_solve(spans)
    run.note("program counters over the window: "
             + (", ".join(f"{k} {v!r}" for k, v in sorted(counters.items())) or "none"))
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
    run.note("program spans over the window (count, median ms, max ms): " + "; ".join(
        f"{k} {len(v)} {statistics.median(v):.3f} {max(v):.3f}"
        for k, v in sorted(by_name.items())))
    fl = run.counters["flush_self_ms"]
    if fl:
        run.note(f"program spans: {len(fl)} flushes, host ms outside their waits: median "
                 f"{statistics.median(fl):.3f}, max {max(fl):.3f}")
    pk = run.counters["ba_pack_ms"]
    if pk:
        run.note(f"program spans: {len(pk)} solves, ba.problem + ba.pack ms: median "
                 f"{statistics.median(pk):.3f}, max {max(pk):.3f}")
    if sampler is not None:
        got = sampler.stop()
        for line in got["notes"]:
            run.note(line)
        if got["samples"]:
            run.counters["clock_samples"] = got["samples"]


def pack_ms_per_solve(spans) -> list:
    """For each `ba.solve` span, the milliseconds of the `ba.problem` and
    `ba.pack` spans since the previous solve ended (the problem is made and
    packed before its solve starts)."""
    out, acc = [], 0
    for s in spans:
        if s.name in PACK:
            acc += s.end_ns - s.start_ns
        elif s.name == "ba.solve":
            out.append(acc / 1e6)
            acc = 0
    return out


def stretch_spans(trace_start_ns: int, wall_s: float) -> list:
    """The program's spans that overlap a profiled stretch, on the
    profiler's clock: (name, start_us, end_us, parent, rid, wait), parent
    re-indexed into this list (-1 where the parent lies outside it). The
    stretch is [0, wall_s] seconds after `trace_start_ns`. Empty when the
    tracer recorded nothing."""
    spans = _tracer().spans()
    hi = wall_s * 1e6
    keep = {}
    out = []
    for i, s in enumerate(spans):
        a, b = (s.start_ns - trace_start_ns) / 1e3, (s.end_ns - trace_start_ns) / 1e3
        if b >= 0.0 and a <= hi:
            keep[i] = len(out)
            out.append([s.name, a, b, s.parent, s.rid, s.wait])
    for r in out:
        r[3] = keep.get(r[3], -1)
    return [tuple(r) for r in out]


def label(spans, t0: float, t1: float) -> str | None:
    """The name of the innermost span open on the host for at least half of
    [t0, t1] (an idle gap of the device), or None."""
    need = 0.5 * (t1 - t0)
    best, best_key = None, None
    for i, (name, a, b, parent, _, _) in enumerate(spans):
        if min(b, t1) - max(a, t0) < need:
            continue
        depth, p = 0, parent
        while p >= 0:
            depth, p = depth + 1, spans[p][3]
        key = (depth, a)
        if best_key is None or key > best_key:
            best, best_key = name, key
    return best


def _merge(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_inside_us(ops, spans, names, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which no device activity of `ops`
    ((name, start_us, end_us)) runs and a span named in `names` is open."""
    busy = _merge([(max(s, lo), min(e, hi)) for _, s, e in ops if e > lo and s < hi])
    idle, cur = [], lo
    for a, b in busy:
        if a > cur:
            idle.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        idle.append((cur, hi))
    inside = _merge([(s[1], s[2]) for s in spans if s[0] in names])
    total, j = 0.0, 0
    for a, b in idle:
        while j < len(inside) and inside[j][1] <= a:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < b:
            total += min(b, inside[k][1]) - max(a, inside[k][0])
            k += 1
    return total
