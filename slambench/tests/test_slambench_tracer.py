"""The readers of the program's spans and counters and of the card's
clocks, on a synthetic stretch; the idle-gap label; the window's brackets
(off with `--trace 0`); the clock sampler's parsing and its silence without
nvidia-smi. The one clock that the device trace and the program's spans
share is checked on the card (`test_slambench_card.py`)."""

from __future__ import annotations

import pytest

from slambench.harness import clocks, spans, spec
from slambench.harness.trace import Summary
from slambench.tests.conftest import tiny_run


def _stretch():
    """A 12 ms stretch: device busy 0-2, 6-10 and 11.8-12 ms; a frame
    0-10 ms whose flush (2.5-9 ms) waits 2.5-3 ms and selects closures
    3-5.5 ms; a pack 10.2-11.5 ms outside any frame."""
    st = Summary(ops=[("graph", 0.0, 2000.0), ("graph", 6000.0, 10000.0),
                      ("graph", 11800.0, 12000.0)], wall_s=0.012)
    st.spans = [("frame", 0.0, 10000.0, -1, 7, False),
                ("flush", 2500.0, 9000.0, 0, 7, False),
                ("flush.flags.wait", 2500.0, 3000.0, 1, 7, True),
                ("flush.closures.select", 3000.0, 5500.0, 1, 7, False),
                ("ba.pack", 10200.0, 11500.0, -1, None, False)]
    return st


def test_idle_inside_named_spans():
    st = _stretch()
    # idle 2-6 ms; inside the flush 2.5-6 ms
    assert spans.idle_inside_us(st.ops, st.spans, ("flush",), 0.0, 12000.0) == 3500.0
    # the pack: idle all through it
    assert spans.idle_inside_us(st.ops, st.spans, spans.PACK, 0.0, 12000.0) == \
        pytest.approx(1300.0)
    # cut to the stretch's bounds
    assert spans.idle_inside_us(st.ops, st.spans, spans.PACK, 0.0, 11000.0) == \
        pytest.approx(800.0)
    assert spans.idle_inside_us(st.ops, [], ("flush",), 0.0, 12000.0) == 0.0


def test_gap_label_is_the_innermost_span_over_half_the_gap():
    st = _stretch()
    # the gap 2-6 ms: the frame and the flush cover over half, the select 2.5 of 4 ms
    assert spans.label(st.spans, 2000.0, 6000.0) == "flush.closures.select"
    # 2-3 ms: the flags' wait covers half
    assert spans.label(st.spans, 2000.0, 3000.0) == "flush.flags.wait"
    # 5.6-6 ms: past the select, inside the flush
    assert spans.label(st.spans, 5600.0, 6000.0) == "flush"
    assert spans.label(st.spans, 10000.0, 11800.0) == "ba.pack"
    assert spans.label(st.spans, 12000.0, 13000.0) is None


def test_breakdown_names_the_span_over_each_gap():
    gaps = dict(_stretch().breakdown()["idle_gaps"])
    assert gaps == pytest.approx({
        "flush.closures.select | host no CUDA call | then graph": 4e-3,
        "ba.pack | host no CUDA call | then graph": 1.8e-3})
    bare = Summary(ops=_stretch().ops, wall_s=0.012)
    assert set(dict(bare.breakdown()["idle_gaps"])) == {"host no CUDA call | then graph"}


def _run_with(**counters):
    run = tiny_run("kitti00.stereo_drive")
    run.trace = True
    run.counters.update(counters)
    return run


def test_readers_on_a_synthetic_stretch():
    run = _run_with(frames_traced=2, flush_self_ms=[3.0, 9.0, 4.0], ba_pack_ms=[50.0, 52.0],
                    clock_samples=[{"sm_mhz": 1980.0, "max_sm_mhz": 1980.0}] * 3
                    + [{"sm_mhz": 1755.0, "max_sm_mhz": 1980.0}])
    run.stretch = _stretch()
    read = {m: spec.metric_reader(m)(run) for m in (
        "flush_host_ms", "flush_idle_ms_per_frame", "ba_pack_ms", "ba_pack_idle_ms",
        "clock_low_share", "clock_low_share.ba")}
    assert read == pytest.approx({"flush_host_ms": 4.0, "flush_idle_ms_per_frame": 1.75,
                                  "ba_pack_ms": 51.0, "ba_pack_idle_ms": 1.3,
                                  "clock_low_share": 25.0, "clock_low_share.ba": 25.0})


def test_readers_silent_without_spans_or_samples():
    run = _run_with(frames_traced=2)
    run.stretch = Summary(ops=[("graph", 0.0, 1.0)], wall_s=1e-3)  # no `spans`: the parent
    for m in ("flush_host_ms", "flush_idle_ms_per_frame", "ba_pack_ms", "ba_pack_idle_ms",
              "clock_low_share", "clock_low_share.ba"):
        assert spec.metric_reader(m)(run) is None, m


def test_window_is_off_with_trace_0(tracer, monkeypatch):
    def boom():
        raise AssertionError("the tracer turned on in a --trace 0 run")

    monkeypatch.setattr(tracer, "enable", boom)
    run = tiny_run("euroc_mh.joint_ba")
    w = spans.window_begin(run)
    spans.window_end(run, w)
    assert w is None and run.counters == {} and run.notes == []


def test_window_aggregates_the_programs_spans(tracer, monkeypatch):
    monkeypatch.setattr(clocks.shutil, "which", lambda _: None)
    run = tiny_run("euroc_mh.joint_ba")
    run.trace = True
    w = spans.window_begin(run)
    assert tracer.enabled()
    for rid in range(2):
        with tracer.span("ba.problem"):
            pass
        with tracer.span("ba.pack"):
            pass
        with tracer.span("ba.solve", rid=rid):
            tracer.count("captures")
    with tracer.span("flush"):
        with tracer.span("flush.flags.wait", wait=True):
            pass
    spans.window_end(run, w)
    assert not tracer.enabled()
    sp = tracer.spans()
    assert run.counters["program_counters"] == {"captures": 2}
    assert run.counters["ba_pack_ms"] == [
        (sp[k].end_ns - sp[k].start_ns + sp[k + 1].end_ns - sp[k + 1].start_ns) / 1e6
        for k in (0, 3)]
    assert run.counters["flush_self_ms"] == [
        (sp[6].end_ns - sp[6].start_ns - (sp[7].end_ns - sp[7].start_ns)) / 1e6]
    assert "clock_samples" not in run.counters
    assert any("not sampled (no nvidia-smi" in n for n in run.notes)
    assert spec.metric_reader("clock_low_share.ba")(run) is None


def test_stretch_spans_are_on_the_profilers_clock(tracer):
    import torch

    a = torch.ones(128, 128)
    with tracer.span("before"):
        pass
    tracer.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("frame", rid=3):
            with tracer.span("frame.replay"):
                a @ a
    t0 = prof.profiler.kineto_results.trace_start_ns()
    got = spans.stretch_spans(t0, 10.0)
    assert [(g[0], g[3], g[4]) for g in got] == [("frame", -1, 3), ("frame.replay", 0, 3)]
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    assert got[1][1] <= mm.time_range.start <= mm.time_range.end <= got[1][2]


def test_clock_lines_parse():
    s = clocks.parse("2026/10/18 13:00:00.000, 1755, 1980, 2619, 412.50, 51, 0x0000000000000004")
    assert s == {"sm_mhz": 1755.0, "max_sm_mhz": 1980.0, "mem_mhz": 2619.0, "power_w": 412.5,
                 "temp_c": 51.0, "reasons": 4}
    assert clocks.reason_names(0x4) == "sw_power_cap" and clocks.reason_names(0) == "none"
    assert clocks.parse("2026/10/18, [N/A], 1980, 2619, 1, 1, 0x0") is None
    assert clocks.parse("Failed to initialize NVML") is None
    assert clocks.low_share([]) is None
