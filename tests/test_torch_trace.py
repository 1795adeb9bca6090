"""The program's tracer (`utils/trace.py`) on the CPU: the off path records
nothing and touches no clock, no allocation and no profiler range; spans
nest with their parents, share their frame's or solve's `rid` and give a
self time without their waits; a span lands on `torch.profiler`'s clock;
an eager `SLAMSystem` flush with a planted closure gives its span tree and
counters equal to the system's keyframes and closures; the BA's spans; and
the metrics drain, which queues nothing without a log file or the tracer
and counts the resamples the JSONL logs."""

import json

import numpy as np
import pytest
import torch

from parakeet_slam_tpu_torch import system
from parakeet_slam_tpu_torch.backend import ba, graph
from parakeet_slam_tpu_torch.core import config as pcm
from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.data.panoramic import make_panoramic_world
from parakeet_slam_tpu_torch.eval import profiling
from parakeet_slam_tpu_torch.frontend.camera import Pinhole
from parakeet_slam_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _cfg():
    """A small equirect system whose closures always run the inline
    optimize (`loop_min_innovation` 0)."""
    return pcm.SLAMConfig(
        filter=pcm.FilterConfig(
            num_particles=8, max_landmarks=64, max_observations=16, lm_dim=3, obs_dim=2,
            pose_dim=7, sig_dim=0, desc_words=8, measurement_model="equirect_3d",
            motion_model="se3_odometry", motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0)),
        frontend=pcm.FrontendConfig(max_features=32, camera="equirect", image_size=(64, 128)),
        backend=pcm.BackendConfig(max_keyframes=32, max_landmarks=128, loop_inlier_radius=0.7,
                                  loop_min_innovation=0.0),
    )


def _closure_run(sys_, frames=4):
    """Six keyframes made by `_make_keyframe`, the sixth seeing the second's
    points and descriptors again, its closure match dispatched; then
    `frames` frames of no observation through `process_obs`, whose fourth
    flushes: it resolves the closure, verifies it, accepts it and runs the
    pose-graph solve."""
    rng = np.random.default_rng(3)
    F, W = 32, 8
    shared = (rng.uniform(-5, 5, (F, 3)).astype(np.float32),
              rng.integers(0, 2**32, (F, W), dtype=np.uint32))
    for i in range(6):
        q = rng.normal(size=4)
        pose = torch.as_tensor(np.concatenate([rng.uniform(-3, 3, 3), q / np.linalg.norm(q)]),
                               dtype=torch.float32)
        world, desc = shared if i in (1, 5) else (
            rng.uniform(-5, 5, (F, 3)).astype(np.float32),
            rng.integers(0, 2**32, (F, W), dtype=np.uint32))
        snap = (geometry.se3_apply_inverse(pose, torch.as_tensor(world)),
                torch.as_tensor(desc.view(np.int32)), torch.ones(F, dtype=torch.bool))
        kf = sys_._make_keyframe(pose, snap, frame=25 * i)
    sys_._dispatch_loop_closure(kf)
    sys_._set_has_kf(True)
    Z = sys_.cfg.filter.max_observations
    obs = sys_._to_observation(torch.zeros(Z, 2), torch.zeros(Z, W, dtype=torch.int32),
                               torch.zeros(Z, dtype=torch.bool))
    for _ in range(frames):
        sys_.process_obs(obs, np.zeros(6, np.float32))


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_off_path_records_nothing_and_is_one_shared_object():
    assert not trace.enabled()
    noop = trace.span("frame", rid=1)
    assert trace.span("flush.flags.wait", wait=True) is noop
    with noop as got:
        trace.count("keyframes", 3)
    assert got is None
    assert trace.spans() == [] and trace.counters() == {}


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_a_capture_records_its_counts_for_its_replays(on):
    """Counts made while a capture records go to the recording, tracer on
    or off, and not to the counters; `add` puts a recording's counts into
    the counters once a replay, and only with the tracer on; after the
    recording the off path is the flag test again."""
    if on:
        trace.enable()
    trace.count("keyframes")
    with trace.recording() as rec:
        trace.count("dist.ring_bytes", 96)
        trace.count("dist.ring_bytes", 32)
        trace.count("dist.gather_bytes", 8)
    assert rec == {"dist.ring_bytes": 128, "dist.gather_bytes": 8}
    assert trace.counters() == ({"keyframes": 1} if on else {})
    trace.add(rec)
    trace.add(rec)
    trace.count("dist.gather_bytes", 1)
    want = {"keyframes": 1, "dist.ring_bytes": 256, "dist.gather_bytes": 17}
    assert trace.counters() == (want if on else {})
    assert trace.enabled() is on


def test_off_path_reads_no_clock_and_enters_no_profiler_range(monkeypatch):
    """A whole flush with a closure, the tracer off: the tracer's clock and
    `record_function` raise if any site reaches them, and the metrics
    drain queues nothing."""
    def boom(*a, **k):
        raise AssertionError("reached with the tracer off")

    monkeypatch.setattr(trace.time, "time_ns", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    sys_ = system.SLAMSystem(_cfg(), device="cpu")
    _closure_run(sys_)
    assert sys_.loop_closures and sys_._metrics_pending == []
    assert trace.spans() == [] and trace.counters() == {}


def test_spans_nest_share_rid_and_give_self_time():
    trace.enable()
    with trace.span("frame", rid=7):
        with trace.span("flush"):
            with trace.span("flush.flags.wait", wait=True):
                pass
            with trace.span("flush.closures"):
                with trace.span("flush.closures.fetch.wait", wait=True):
                    with trace.span("inner.wait", wait=True):
                        pass
    with trace.span("ba.solve", rid=2):
        trace.count("keyframes")
        trace.count("keyframes", 2)
    sp = trace.spans()
    assert [s.name for s in sp] == ["frame", "flush", "flush.flags.wait", "flush.closures",
                                    "flush.closures.fetch.wait", "inner.wait", "ba.solve"]
    assert [s.parent for s in sp] == [-1, 0, 1, 1, 3, 4, -1]
    assert [s.rid for s in sp] == [7] * 6 + [2]
    assert [s.wait for s in sp] == [False, False, True, False, True, True, False]
    assert all(s.start_ns <= s.end_ns for s in sp)
    assert all(sp[s.parent].start_ns <= s.start_ns and s.end_ns <= sp[s.parent].end_ns
               for s in sp if s.parent >= 0)
    dur = [s.end_ns - s.start_ns for s in sp]
    # the outermost waits under a span come off it, a wait inside a wait once
    assert trace.self_ns(sp, 1) == dur[1] - dur[2] - dur[4]
    assert trace.self_ns(sp, 3) == dur[3] - dur[4]
    assert trace.self_ns(sp, 0) == dur[0] - dur[2] - dur[4]
    assert trace.counters() == {"keyframes": 3}
    trace.reset()
    assert trace.spans() == [] and trace.counters() == {}


def test_a_span_lands_on_the_profilers_clock():
    """Under torch.profiler a span around a matmul encloses the op's
    interval once brought onto the profile's timeline with its
    `trace_start_ns()`."""
    a = torch.ones(256, 256)
    trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("mm"):
            a @ a
    t0 = prof.profiler.kineto_results.trace_start_ns()
    (s,) = trace.spans()
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mm) == 1
    lo, hi = (s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3
    assert lo <= mm[0].time_range.start <= mm[0].time_range.end <= hi


def test_profiling_trace_writes_the_spans_on_the_profilers_clock(tmp_path):
    """`eval/profiling.trace` turns the tracer on for its block and writes
    the spans beside the profiler's events, on one clock."""
    a = torch.ones(256, 256)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("frame"):
            a @ a
    assert not trace.enabled()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (frame,) = [e for e in events if e.get("cat") == "program_span"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert frame["name"] == "frame"
    assert frame["ts"] - 1 <= mm["ts"] and mm["ts"] + mm["dur"] <= frame["ts"] + frame["dur"] + 1


def test_flush_with_a_closure_gives_its_span_tree_and_counters():
    trace.enable()
    sys_ = system.SLAMSystem(_cfg(), device="cpu", capture=False)
    _closure_run(sys_)
    c = trace.counters()
    assert c["keyframes"] == len(sys_.keyframes) == 6
    assert c["closures_accepted"] == len(sys_.loop_closures) == 1
    assert c["closure_dispatches"] == 1 and c["closure_candidates"] >= 1
    assert c["pose_graph_solves"] == 1
    sp = trace.spans()
    frames = [i for i, s in enumerate(sp) if s.name == "frame"]
    assert [sp[i].rid for i in frames] == [0, 1, 2, 3]
    for i in frames:
        assert _children(sp, i)[0] == "frame.replay"
    (fl,) = [i for i, s in enumerate(sp) if s.name == "flush"]
    assert sp[fl].parent == frames[3] and sp[fl].rid == 3
    assert _children(sp, fl) == ["flush.flags.wait", "flush.closures", "flush.optimize"]
    (cl,) = [i for i, s in enumerate(sp) if s.name == "flush.closures"]
    assert _children(sp, cl) == ["flush.closures.fetch.wait", "flush.closures.select",
                                 "flush.verify", "flush.closures.accept"]
    (ve,) = [i for i, s in enumerate(sp) if s.name == "flush.verify"]
    (op,) = [i for i, s in enumerate(sp) if s.name == "flush.optimize"]
    assert _children(sp, ve) == ["flush.verify.wait"] and _children(sp, op) == [
        "flush.optimize.wait"]
    assert all(s.rid == 3 for s in sp if s.start_ns >= sp[fl].start_ns)
    waits = [s for s in sp if s.wait and s.start_ns >= sp[fl].start_ns]
    assert [s.name for s in waits] == ["flush.flags.wait", "flush.closures.fetch.wait",
                                       "flush.verify.wait", "flush.optimize.wait"]
    assert trace.self_ns(sp, fl) == (sp[fl].end_ns - sp[fl].start_ns
                                     - sum(s.end_ns - s.start_ns for s in waits))
    # the keyframes made before the frames, outside any frame
    kfs = [s for s in sp if s.name == "flush.keyframe"]
    assert len(kfs) == 6 and all(s.parent == -1 and s.rid is None for s in kfs)
    assert all(_children(sp, sp.index(s)) == ["flush.keyframe.wait"] for s in kfs)


def _tiny_ba_problem(rng, C=3, Lm=40):
    cam = Pinhole(100.0, 100.0, 64.0, 48.0, 128, 96)
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (C, 1))
    poses[:, 0] = np.arange(C) * 0.2
    pts = np.stack([rng.uniform(-1, 1, Lm), rng.uniform(-1, 1, Lm), rng.uniform(4, 6, Lm)],
                   axis=1).astype(np.float32)
    oc, op = np.repeat(np.arange(C), Lm), np.tile(np.arange(Lm), C)
    uv = cam.project(geometry.se3_apply_inverse(torch.as_tensor(poses[oc]),
                                                torch.as_tensor(pts[op]))).numpy()
    noisy = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    return cam, dict(cam_pose=poses, points=noisy, obs_cam=oc, obs_pt=op, obs_uv=uv)


@pytest.mark.parametrize("capture", [False, True], ids=["eager", "captured_rules"])
def test_ba_spans(capture):
    """ba.problem, then ba.pack inside `optimize_ba`, then ba.solve with the
    solve's number as its rid, one after the other for each solve."""
    cam, raw = _tiny_ba_problem(np.random.default_rng(0))
    trace.enable()
    for _ in range(2):
        prob = graph.make_ba_problem(**raw, device="cpu")
        ba.optimize_ba(cam, prob, iters=2, pcg_iters=5, capture=capture)
    sp = trace.spans()
    assert [s.name for s in sp] == ["ba.problem", "ba.pack", "ba.solve"] * 2
    assert all(s.parent == -1 for s in sp)
    assert all(a.end_ns <= b.start_ns for a, b in zip(sp, sp[1:]))
    r0, r1 = sp[2].rid, sp[5].rid
    assert isinstance(r0, int) and r1 == r0 + 1


def _pano_cfg(metrics_path):
    return pcm.SLAMConfig(
        filter=pcm.FilterConfig(
            num_particles=32, max_landmarks=256, max_observations=24, lm_dim=3, obs_dim=2,
            pose_dim=7, sig_dim=0, desc_words=8, measurement_model="equirect_3d",
            motion_model="se3_odometry", motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0),
            init_range_prior=14.0, init_range_sigma=8.0, new_landmark_loglik=-14.0,
            max_range=45.0, desc_weight=0.05),
        frontend=pcm.FrontendConfig(detector="fast", max_features=64, fast_threshold=0.12,
                                    nms_radius=4, camera="equirect", image_size=(128, 256)),
        backend=pcm.BackendConfig(max_keyframes=32, keyframe_translation=1.0,
                                  keyframe_rotation=0.4, gn_iters=8),
        metrics_path=metrics_path)


def test_metrics_drain_only_for_a_file_or_the_tracer(tmp_path):
    """Without a log file and with the tracer off nothing is queued; with
    both, the drain writes the JSONL as before and `resamples` equals the
    sum of its `resampled`."""
    world = make_panoramic_world(num_landmarks=120, num_steps=8, image_size=(128, 256), seed=11)
    images = [world.render(t) for t in range(8)]
    quiet = system.SLAMSystem(_pano_cfg(""), device="cpu")
    for t in range(3):
        quiet.process_frame(images[t], world.odom[t])
    assert not quiet.metrics.writing and quiet._metrics_pending == []
    path = tmp_path / "m.jsonl"
    sys_ = system.SLAMSystem(_pano_cfg(str(path)), device="cpu")
    trace.enable()
    for t in range(8):
        sys_.process_frame(images[t], world.odom[t])
    assert len(sys_._metrics_pending) == 8
    sys_.flush_metrics()
    sys_.metrics.flush()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["frame"] for r in recs] == list(range(1, 9))
    n = sum(r["resampled"] for r in recs)
    assert 0 < n < 8  # this world resamples on some frames and not on others
    assert trace.counters()["resamples"] == n
    (drain,) = [s for s in trace.spans() if s.name == "metrics.drain"]
    assert drain.wait
