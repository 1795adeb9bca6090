"""A traced stretch of the window: `torch.profiler` with the device's
activity only (the host's CUDA runtime and driver calls come with it), kept
in memory and reduced to a summary; no trace file is written.

The summary holds every device activity (kernels, copies, memsets) with
its interval, the host's CUDA API calls by name, the device's busy time
(the union of the activities' intervals), the stretch's wall time on the
host's clock between two synchronisations, and the program's spans over
the stretch on the profiler's clock (`spans.stretch_spans`; none unless
the driver's window turned the program's tracer on)."""

from __future__ import annotations

import re
import time
from collections import Counter
from dataclasses import dataclass, field

from slambench.harness import spans

_API = re.compile(r"cu[A-Z]|cuda[A-Z]")
# idle gaps shorter than this are the device's own latency between queued
# operations (a graph's nodes), not the host's
SHORT_GAP_US = 50.0


@dataclass
class Summary:
    ops: list = field(default_factory=list)       # (name, start_us, end_us), by start
    api: Counter = field(default_factory=Counter)  # host CUDA API calls by name
    api_events: list = field(default_factory=list)  # (name, start_us, end_us)
    wall_s: float = 0.0
    spans: list = field(default_factory=list)  # spans.stretch_spans' tuples

    def kernels(self, pattern: str | None = None) -> list:
        """Device activities whose name contains `pattern` (all when None)."""
        return [o for o in self.ops if pattern is None or pattern in o[0]]

    @property
    def busy_s(self) -> float:
        return union_us([(s, e) for _, s, e in self.ops]) / 1e6

    @property
    def host_calls(self) -> int:
        return sum(self.api.values())

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the host's CUDA call in them (or none), with the operation
        that ended each gap, and first the program's innermost span open
        over at least half of the gap where there is one."""
        by_name = Counter()
        for name, s, e in self.ops:
            by_name[name[:120]] += (e - s) / 1e6
        gaps = Counter()
        ops = sorted(self.ops, key=lambda o: o[1])
        api = sorted(self.api_events, key=lambda a: a[1])
        end, j = None, 0
        for name, s, e in ops:
            if end is not None and s - end >= SHORT_GAP_US:
                while j < len(api) and api[j][2] < end:
                    j += 1
                calls, k = set(), j
                while k < len(api) and api[k][1] < s:
                    calls.add(api[k][0])
                    k += 1
                host = ",".join(sorted(calls))[:60] if calls else "no CUDA call"
                span = spans.label(self.spans, end, s)
                where = f"{span} | " if span else ""
                gaps[f"{where}host {host} | then {name[:60]}"] += (s - end) / 1e6
            elif end is not None and s > end:
                gaps[f"gaps under {SHORT_GAP_US:g} us (between queued operations)"] += \
                    (s - end) / 1e6
            end = e if end is None else max(end, e)
        return {"device_ops": [[n, v] for n, v in by_name.most_common(top)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}


def union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Stretch:
    """`with Stretch() as st: ...` profiles the block; `st.summary` after."""

    def __init__(self):
        self.summary = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof.events(), wall)
            self.summary.spans = spans.stretch_spans(
                self._prof.profiler.kineto_results.trace_start_ns(), wall)
        return False


def summarize(events, wall_s: float) -> Summary:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = Summary(wall_s=wall_s)
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            out.ops.append((e.name, float(tr.start), float(tr.end)))
        elif _API.match(e.name):
            out.api[e.name] += 1
            out.api_events.append((e.name, float(tr.start), float(tr.end)))
    out.ops.sort(key=lambda o: o[1])
    if not out.ops:
        raise RuntimeError("torch.profiler recorded no device activity in the traced stretch")
    return out
