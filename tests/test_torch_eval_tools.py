"""The port's last evaluation and utility modules: `eval/bench_system` (a
small CPU run of both kinds, its keys equal to the reference's), the numpy
baseline copy against the JAX package's file, `cli bench
--measure-baseline`, `profiling.trace` / `annotate`, and
`utils/viz.render_map_png` (the twin of tests/test_utils.py's render test)."""

import json
import os

import numpy as np
import pytest
import torch

from parakeet_slam_tpu.baseline import numpy_fastslam as j_baseline
from parakeet_slam_tpu.data import make_corridor
from parakeet_slam_tpu_torch import cli
from parakeet_slam_tpu_torch.baseline import numpy_fastslam as t_baseline
from parakeet_slam_tpu_torch.eval import bench_system, profiling

# the reference's result keys (parakeet_slam_tpu/eval/bench_system.py:102-111)
BENCH_KEYS = {"pipeline", "particles", "max_landmarks", "image", "fps_per_chip",
              "ms_per_frame", "keyframes", "device"}
SMALL = dict(P=16, L=128, Z=16, H=64, W=128)


@pytest.mark.parametrize("kind", ["pano", "stereo"])
def test_bench_system_cpu_smoke(kind):
    r = bench_system.bench_system(kind, frames=2, device="cpu", **SMALL)
    assert set(r) == BENCH_KEYS
    assert r["pipeline"] == kind and r["particles"] == 16 and r["max_landmarks"] == 128
    assert r["image"] == [64, 128] and r["device"] == "cpu"
    assert r["fps_per_chip"] > 0 and r["ms_per_frame"] > 0 and r["keyframes"] >= 1


def test_bench_system_configs_are_the_references():
    from parakeet_slam_tpu.eval import bench_system as j_bench

    for kind in ("pano", "stereo"):
        mine = getattr(bench_system, f"_{kind}_cfg")()
        ref = getattr(j_bench, f"_{kind}_cfg")()
        for part in ("filter", "frontend", "backend"):
            a, b = getattr(mine, part).__dict__, getattr(ref, part).__dict__
            assert a == {k: b[k] for k in a}, (kind, part)
    with pytest.raises(ValueError, match="kind"):
        bench_system.bench_frames("mono", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_system.bench_system("pano", frames=1, **SMALL)
        with pytest.raises(SystemExit):
            bench_system.main(["--config", "pano", "--frames", "1"])


def test_numpy_baseline_copy_matches_the_reference():
    """Five corridor frames through both copies from one seed: equal arrays."""
    sim = make_corridor(num_landmarks=40, num_steps=6, max_obs=8, seed=7)
    kw = dict(num_particles=16, motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
              sig_noise=0.5, max_range=6.5, fov_half_angle=2.5, seed=0)
    a, b = t_baseline.NumpyFastSLAM(**kw), j_baseline.NumpyFastSLAM(**kw)
    for i in range(5):
        for s in (a, b):
            s.motion_update(sim.odom[i])
            s.measurement_update(sim.obs_z[i], sim.obs_sig[i], sim.obs_valid[i])
        np.testing.assert_array_equal(a.estimate_pose(), b.estimate_pose())
        for pa, pb in zip(a.particles, b.particles):
            np.testing.assert_array_equal(pa.pose, pb.pose)
            assert pa.log_w == pb.log_w and len(pa.landmarks) == len(pb.landmarks)
            for la, lb in zip(pa.landmarks, pb.landmarks):
                np.testing.assert_array_equal(la.mean, lb.mean)
                np.testing.assert_array_equal(la.cov, lb.cov)


def test_measure_baseline_prints_bench_py_line(capsys, monkeypatch):
    monkeypatch.setattr(cli, "measure_baseline", lambda steps=100: 2.5)
    cli.main(["bench", "--measure-baseline"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"metric": "baseline_fps", "value": 2.5, "unit": "frames/s"}


def test_measure_baseline_runs_the_copy():
    fps = cli.measure_baseline(steps=2)
    assert np.isfinite(fps) and fps > 0


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    d = tmp_path / "trace"
    with profiling.trace(str(d)) as prof:
        with profiling.annotate("frame"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = d / "trace.json"
    assert prof is not None and path.stat().st_size > 0
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "frame" in names


def test_render_map(tmp_path):
    from parakeet_slam_tpu_torch.utils.viz import render_map_png

    cv2 = pytest.importorskip("cv2")
    p = str(tmp_path / "map.png")
    traj = np.cumsum(np.random.default_rng(0).normal(size=(50, 2)), axis=0)
    lms = np.random.default_rng(1).normal(size=(30, 2)) * 5
    assert render_map_png(p, traj, lms, gt_trajectory=traj + 0.1) == p
    img = cv2.imread(p)
    assert img is not None and img.shape == (800, 800, 3) and os.path.getsize(p) > 0
