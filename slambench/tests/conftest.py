"""The benchmark's own tests. Run from the checkout's root:

    python -m pytest slambench/tests -q

Tests marked `card` need a CUDA card and skip without one; whether a card
is present is decided inside the `card` fixture, never at import."""

from __future__ import annotations

import copy
import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny sizes of each cell for the CPU: (traffic params, config sections).
# kitti00's window ends on its supply of 0.1 x 120 + 8 = 20 frames (SECONDS)
# however slow the CPU, so that it always reaches its checked frames.
TINY = {
    "euroc_mh.joint_ba": ({"cameras": 4, "points": 300, "obs_per_cam": 120},
                          {"backend": {"gn_iters": 3, "pcg_iters": 10}}),
    "kitti00.stereo_drive": (
        {"image_size": [96, 320], "intrinsics": [180.0, 180.0, 160.0, 48.0], "max_rate_fps": 0.1,
         "warmup_frames": 6, "checked_window_frames": [2, 8], "trace_frames": 2},
        {"filter": {"num_particles": 16, "max_landmarks": 256, "max_observations": 32},
         "frontend": {"max_features": 64, "image_size": [96, 320],
                      "intrinsics": [180.0, 180.0, 160.0, 48.0]},
         "backend": {"max_keyframes": 64}}),
    "panoramic.sharded_filter4": (
        {},
        {"filter": {"num_particles": 16, "max_landmarks": 256, "max_observations": 32},
         "dist": {"particle_axis": 1}}),
}

SECONDS = {"kitti00.stereo_drive": 120.0}

# The sharded filter's cell is not in BENCHMARK.json until its world is
# sized from its source; its driver is run here from this definition (the
# world's shape as `drivers/sharded_filter.py` reads it, at a tiny size).
SHARDED = {
    "name": "panoramic.sharded_filter4", "config": "panoramic", "chips": 4,
    "traffic": {"kind": "sharded_filter", "params": {
        "landmarks": 300, "radius_m": 8.0, "lap_frames": 40, "min_range_m": 1.0,
        "pixel_noise": [0.75, 0.75], "desc_flips": 3, "odom_noise": [0.01, 0.005],
        "max_rate_fps": 400, "warmup_frames": 4, "sync_every": 4,
        "checked_frames": 2, "checked_window_frames": [1, 6], "trace_frames": 2}},
    "limits": {"pose_gap_max": 1e-3, "logw_gap_max": 1e-3, "est_gap": 1e-3,
               "lane_mismatch_share": 1e-4},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the test runs on the card")


@pytest.fixture
def tracer():
    """The port's tracer, off and empty before and after the test."""
    from parakeet_slam_tpu_torch.utils import trace

    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def tiny_run(name: str, seed: int = 2**31 + 11, seconds: float | None = None):
    """A `Run` of cell `name` at its tiny CPU size (`--seconds` from
    SECONDS, else 3)."""
    from slambench.harness import cli, spec

    if name == SHARDED["name"]:
        with open(os.path.join(spec.HERE, "configs", f"{SHARDED['config']}.json")) as f:
            config = json.load(f)
        cell = spec.Cell(name=name, chips=SHARDED["chips"],
                         workload={"config": SHARDED["config"], "traffic": "tiny",
                                   "limits": SHARDED["limits"]},
                         config=config, traffic=copy.deepcopy(SHARDED["traffic"]))
    else:
        cell = spec.load_cell(ROOT, name)
        cell.traffic = copy.deepcopy(cell.traffic)
        cell.config = copy.deepcopy(cell.config)
    params, sections = TINY[name]
    cell.traffic["params"].update(params)
    for sec, vals in sections.items():
        cell.config["run"][sec].update(vals)
    seconds = SECONDS.get(name, 3.0) if seconds is None else seconds
    return cli.Run(cell=cell, root=ROOT, seed=seed, seconds=seconds, trace=False,
                   t0_wall=time.time(), device="cpu")
