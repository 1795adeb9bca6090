"""The traffic made from the seed: the same seed gives the same inputs,
another seed others, and the street world's centre line is the port's."""

from __future__ import annotations

import numpy as np
import torch

from slambench.worlds import ba_problem
from slambench.worlds.drive import DriveWorld
from slambench.worlds.panoramic import PanoWalk

BA = {"cameras": 4, "points": 200, "obs_per_cam": 50, "noise_px": 0.5,
      "camera": [458.0, 457.0, 367.0, 248.0, 752, 480]}
DRIVE = {"lap_frames": 400, "speed_m": 1.0, "corner_radius_m": 20.0, "landmarks_per_m": 2.0,
         "lateral_m": [6.0, 18.0], "height_m": [-1.0, 8.0], "camera_height_m": 1.65,
         "image_size": [48, 160], "intrinsics": [90.0, 90.0, 80.0, 24.0], "baseline_m": 0.5372,
         "max_render_range_m": 70.0, "odom_noise": [0.02, 0.002]}
PANO = {"landmarks": 200, "radius_m": 8.0, "lap_frames": 20, "min_range_m": 1.0,
        "pixel_noise": [0.75, 0.75], "desc_flips": 3, "odom_noise": [0.01, 0.005]}
BIG = 2**31 + 77  # seeds reach past 32 signed bits


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_ba_problem_reproducible():
    a, b, c = (ba_problem.make(BA, s, "cpu") for s in (BIG, BIG, BIG + 1))
    assert _same(a, b) and not _same(a, c)
    assert a["obs_uv"].shape == (200, 2) and a["obs_pt"].max() < 200


def test_drive_world_and_frames_reproducible():
    a, b, c = (DriveWorld(DRIVE, s, "cpu", 6) for s in (BIG, BIG, BIG + 1))
    assert torch.equal(a.landmarks, b.landmarks) and not torch.equal(a.landmarks, c.landmarks)
    assert torch.equal(a.odom, b.odom)
    la, ra = a.render_stereo(0, 3)
    lb, rb = b.render_stereo(0, 3)
    assert np.array_equal(la, lb) and np.array_equal(ra, rb)
    assert la.dtype == np.float32 and la.min() >= 0.0 and la.max() <= 1.0
    assert np.array_equal(np.round(la * 255), la * 255), "8-bit levels, as the KITTI loader reads"


def test_drive_center_line_is_the_ports():
    from parakeet_slam_tpu_torch.data import synth_vision as sv

    port = sv.make_drive_world(num_landmarks=10, num_steps=60)
    lap = 8 * 90 - 8 * 20 + 2 * np.pi * 20  # make_drive_world's circuit_half 90
    w = DriveWorld(dict(DRIVE, lap_frames=lap), 1, "cpu", 60)
    assert np.abs(w.gt_pose.numpy() - port.gt_pose).max() < 1e-6


def test_pano_walk_reproducible():
    a, b, c = (PanoWalk(PANO, s, "cpu", 30, 16, 8, (64, 128)) for s in (BIG, BIG, BIG + 1))
    for k in ("z", "desc", "valid", "odom"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    assert not torch.equal(a.z, c.z)
    assert a.z.shape == (30, 16, 2) and bool(a.valid.all())
    assert float(a.z[..., 0].min()) >= 0.0 and float(a.z[..., 0].max()) < 128.0
