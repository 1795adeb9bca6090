"""Synthetic 2-D corridor simulator (benchmark config 1).

A copy of `parakeet_slam_tpu.data.corridor` (pure numpy): the same arguments
give the same arrays.

BASELINE.json:7 — "Synthetic 2D corridor: 100 landmarks, 500-step
odometry+bearing sim, 64 particles (CPU-runnable ref)". The robot drives a
rectangular loop corridor (so the run contains a loop closure); landmarks
line the walls and carry a random RGB-like appearance signature mimicking
the reference's color-blob observations (SURVEY.md §3 "Reference-style").

Generation is host-side numpy (once per run, seeded); outputs are dense
fixed-capacity arrays ready to feed the jitted filter: per step a noisy
odometry increment and up to Zmax range-bearing(+signature) observations
with a validity mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CorridorSim:
    gt_pose: np.ndarray    # [T, 3] ground-truth poses (x, y, theta)
    odom: np.ndarray       # [T, 3] noisy odometry increments (robot frame)
    obs_z: np.ndarray      # [T, Zmax, 2] (range, bearing) observations
    obs_sig: np.ndarray    # [T, Zmax, sig_dim] appearance signatures
    obs_valid: np.ndarray  # [T, Zmax] bool
    landmarks: np.ndarray  # [N, 2] ground-truth landmark positions
    landmark_sig: np.ndarray  # [N, sig_dim]


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def make_corridor(
    num_landmarks: int = 100,
    num_steps: int = 500,
    max_obs: int = 16,
    sig_dim: int = 3,
    max_range: float = 6.0,
    fov_half_angle: float = 2.4,
    odom_noise: tuple[float, float] = (0.015, 0.01),   # (trans std, rot std)
    meas_noise: tuple[float, float] = (0.08, 0.02),    # (range std, bearing std)
    sig_noise: float = 0.15,
    loop_size: tuple[float, float] = (20.0, 12.0),
    seed: int = 7,
) -> CorridorSim:
    rng = np.random.default_rng(seed)
    W, H = loop_size

    # Landmarks on the two walls of a rectangular loop corridor (offset ±1m
    # from the robot's centerline path).
    per_side = num_landmarks // 2
    t = rng.uniform(0.0, 1.0, size=num_landmarks)
    centerline = _loop_point(t, W, H)
    normals = _loop_normal(t, W, H)
    offsets = np.where(np.arange(num_landmarks) < per_side, 1.0, -1.0)
    jitter = rng.normal(0.0, 0.15, size=(num_landmarks, 2))
    landmarks = centerline + offsets[:, None] * normals + jitter
    landmark_sig = rng.uniform(0.0, 1.0, size=(num_landmarks, sig_dim))

    # Ground-truth trajectory: constant-speed traversal of the loop.
    s = np.linspace(0.0, 1.0, num_steps, endpoint=False)
    gt_xy = _loop_point(s, W, H)
    tangent = _loop_point((s + 1e-4) % 1.0, W, H) - gt_xy
    gt_th = np.arctan2(tangent[:, 1], tangent[:, 0])
    gt_pose = np.concatenate([gt_xy, gt_th[:, None]], axis=1)

    # Noisy odometry increments (relative pose deltas in the robot frame).
    odom = np.zeros((num_steps, 3))
    for i in range(1, num_steps):
        dx = gt_pose[i, 0] - gt_pose[i - 1, 0]
        dy = gt_pose[i, 1] - gt_pose[i - 1, 1]
        c, si = np.cos(gt_pose[i - 1, 2]), np.sin(gt_pose[i - 1, 2])
        local = np.array([c * dx + si * dy, -si * dx + c * dy])
        dth = _wrap(gt_pose[i, 2] - gt_pose[i - 1, 2])
        odom[i] = [
            local[0] + rng.normal(0, odom_noise[0]),
            local[1] + rng.normal(0, odom_noise[0]),
            dth + rng.normal(0, odom_noise[1]),
        ]

    # Observations: nearest in-FOV landmarks, range-bearing + signature.
    obs_z = np.zeros((num_steps, max_obs, 2))
    obs_sig = np.zeros((num_steps, max_obs, sig_dim))
    obs_valid = np.zeros((num_steps, max_obs), dtype=bool)
    for i in range(num_steps):
        d = landmarks - gt_pose[i, :2]
        r = np.hypot(d[:, 0], d[:, 1])
        phi = _wrap(np.arctan2(d[:, 1], d[:, 0]) - gt_pose[i, 2])
        visible = (r < max_range) & (np.abs(phi) < fov_half_angle)
        vis_idx = np.where(visible)[0]
        vis_idx = vis_idx[np.argsort(r[vis_idx])][:max_obs]
        n = len(vis_idx)
        obs_z[i, :n, 0] = r[vis_idx] + rng.normal(0, meas_noise[0], n)
        obs_z[i, :n, 1] = _wrap(phi[vis_idx] + rng.normal(0, meas_noise[1], n))
        obs_sig[i, :n] = landmark_sig[vis_idx] + rng.normal(0, sig_noise, (n, sig_dim))
        obs_valid[i, :n] = True

    return CorridorSim(
        gt_pose=gt_pose.astype(np.float32),
        odom=odom.astype(np.float32),
        obs_z=obs_z.astype(np.float32),
        obs_sig=obs_sig.astype(np.float32),
        obs_valid=obs_valid,
        landmarks=landmarks.astype(np.float32),
        landmark_sig=landmark_sig.astype(np.float32),
    )


def _loop_point(t, W, H):
    """Point on a rounded-rectangle loop, parameterized t in [0, 1)."""
    t = np.atleast_1d(t)
    perim = 2 * (W + H)
    d = t * perim
    pts = np.zeros((len(t), 2))
    for i, di in enumerate(d):
        if di < W:
            pts[i] = [di, 0.0]
        elif di < W + H:
            pts[i] = [W, di - W]
        elif di < 2 * W + H:
            pts[i] = [W - (di - W - H), H]
        else:
            pts[i] = [0.0, H - (di - 2 * W - H)]
    return pts


def _loop_normal(t, W, H):
    """Outward normal of the loop at parameter t."""
    eps = 1e-4
    p0 = _loop_point(t, W, H)
    p1 = _loop_point((t + eps) % 1.0, W, H)
    tang = p1 - p0
    tang /= np.linalg.norm(tang, axis=1, keepdims=True) + 1e-12
    return np.stack([tang[:, 1], -tang[:, 0]], axis=1)
