"""Synthetic vision worlds, the pose and odometry half (port of
`make_drive_world` and `_poses_from_track` of
`parakeet_slam_tpu.data.synth_vision`).

A KITTI 00-class stereo world: a vehicle drives a closed rounded-square
street circuit with building-facade landmarks on both sides. The numpy
random stream is the reference's, so the landmarks, poses and odometry
equal the JAX package's (the geometry runs in float32 torch here, as in
jnp there). Rendering and the dataset-format writers belong to the
frontend slice and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from parakeet_slam_tpu_torch.core import geometry

# body (x-forward, z-up, yaw) -> optical (z-forward, y-down) quaternion
_Q_BC = np.array([-0.5, 0.5, -0.5, 0.5], np.float32)


@dataclass
class VisionWorld:
    """A landmark world and a camera trajectory through it."""

    landmarks: np.ndarray          # [N, 3] world positions
    gt_pose: np.ndarray            # [T, 7] world-from-camera (t, qxyzw)
    odom: np.ndarray               # [T, 6] noisy body-frame twist increments
    image_size: tuple[int, int]    # (H, W)
    intrinsics: tuple[float, float, float, float]
    baseline: float                # stereo baseline (0 = monocular)
    max_render_range: float
    seed: int

    def __len__(self):
        return self.gt_pose.shape[0]


def _poses_from_track(xy, yaw, height, rng, odom_noise):
    """Yaw-only body track -> optical-frame SE(3) poses + noisy odometry."""
    T = len(xy)
    se2 = torch.tensor(np.stack([xy[:, 0], xy[:, 1], yaw], 1), dtype=torch.float32)
    p = geometry.se2_to_se3(se2)
    q = geometry.quat_multiply(p[:, 3:], torch.as_tensor(_Q_BC))
    t = torch.cat([p[:, :2], torch.as_tensor(np.asarray(height, np.float32))[:, None]], 1)
    poses_t = torch.cat([t, q], 1)
    rel = geometry.se3_log(geometry.se3_between(poses_t[:-1], poses_t[1:])).numpy()
    odom = np.zeros((T, 6), np.float32)
    for i in range(1, T):  # the reference's draw order
        noise = np.concatenate(
            [rng.normal(0, odom_noise[0], 3), rng.normal(0, odom_noise[1], 3)]
        )
        odom[i] = rel[i - 1] + noise
    return poses_t.numpy(), odom


def make_drive_world(
    num_landmarks: int = 10000,
    num_steps: int = 700,
    image_size: tuple[int, int] = (376, 1241),
    intrinsics: tuple[float, ...] = (718.856, 718.856, 607.1928, 185.2157),
    baseline: float = 0.5372,
    circuit_half: float = 90.0,
    speed: float = 1.0,
    odom_noise: tuple[float, float] = (0.02, 0.002),
    seed: int = 21,
) -> VisionWorld:
    """KITTI 00-class stereo world (driver config 3): a closed rounded-square
    street circuit (perimeter ~ 8*half) with facade landmarks on both sides;
    the final frames revisit the start."""
    rng = np.random.default_rng(seed)
    rc = 20.0
    side = 2 * circuit_half - 2 * rc
    L = 4 * side + 2 * np.pi * rc

    def center(s):
        s = np.mod(s, L)
        seg = np.empty((len(s), 2))
        yaw = np.empty(len(s))
        for i, si in enumerate(s):
            k = 0
            while si >= (side if k % 2 == 0 else np.pi * rc / 2):
                si -= side if k % 2 == 0 else np.pi * rc / 2
                k += 1
            if k % 2 == 0:  # straight, unrotated: along the bottom edge heading +x
                p = np.array([-circuit_half + rc + si, -circuit_half])
                a = 0.0
            else:  # quarter arc around the bottom-right corner
                a = si / rc
                c = np.array([circuit_half - rc, -circuit_half + rc])
                p = c + rc * np.array([np.sin(a), -np.cos(a)])
            rot = (k // 2) * (np.pi / 2)
            cr, sr = np.cos(rot), np.sin(rot)
            seg[i] = np.array([cr * p[0] - sr * p[1], sr * p[0] + cr * p[1]])
            yaw[i] = rot + a
        return seg, yaw

    s = np.arange(num_steps) * speed
    xy, yaw = center(s)
    s_lm = rng.uniform(0, L, num_landmarks)
    lat = rng.uniform(6.0, 18.0, num_landmarks) * rng.choice([-1.0, 1.0], num_landmarks)
    hgt = rng.uniform(-1.0, 8.0, num_landmarks)
    c_lm, yaw_lm = center(s_lm)
    normal = np.stack([-np.sin(yaw_lm), np.cos(yaw_lm)], axis=1)
    lm_xy = c_lm + normal * lat[:, None]
    landmarks = np.concatenate([lm_xy, hgt[:, None]], axis=1).astype(np.float32)
    height = np.full(num_steps, 1.65)  # camera height above ground
    poses, odom = _poses_from_track(xy, yaw, height, rng, odom_noise)
    return VisionWorld(
        landmarks=landmarks, gt_pose=poses, odom=odom, image_size=image_size,
        intrinsics=tuple(float(x) for x in intrinsics[:4]), baseline=baseline,
        max_render_range=70.0, seed=seed,
    )
