"""Synthetic panoramic 360-degree world (port of
`parakeet_slam_tpu.data.panoramic`): equirectangular (or pinhole) frames of
a random landmark shell rendered as Gaussian blobs, so the whole vision
pipeline (detect, describe, match, filter, backend) runs with ground truth
and no external data. Each landmark has a stable random texture, so BRIEF
descriptors repeat across frames. The numpy streams are the reference's;
the geometry runs in float32 torch, as in jnp there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from parakeet_slam_tpu_torch.core import geometry


@dataclass
class SyntheticWorld:
    landmarks: np.ndarray        # [N, 3]
    gt_pose: np.ndarray          # [T, 7] world-from-camera SE(3)
    odom: np.ndarray             # [T, 6] noisy twist increments
    image_size: tuple[int, int]  # (H, W)
    camera: str                  # equirect | pinhole
    seed: int

    def __len__(self):
        return self.gt_pose.shape[0]

    def render(self, i: int) -> np.ndarray:
        """Frame i as a grayscale [H, W] float32 image."""
        return _render_frame(self.landmarks, self.gt_pose[i], self.image_size, self.camera,
                             self.seed)

    def render_stereo(self, i: int, baseline: float = 0.3):
        """(left, right): the right camera displaced by `baseline` along the
        camera x-axis (pinhole worlds only)."""
        assert self.camera == "pinhole"
        pose = self.gt_pose[i]
        right_pose = pose.copy()
        right_pose[:3] = geometry.se3_apply(
            torch.as_tensor(pose), torch.tensor([baseline, 0.0, 0.0])
        ).numpy()
        right = _render_frame(self.landmarks, right_pose, self.image_size, self.camera, self.seed)
        return self.render(i), right


def _project_equirect(p_cam, H, W):
    r = np.linalg.norm(p_cam, axis=-1) + 1e-9
    az = np.arctan2(p_cam[:, 1], p_cam[:, 0])
    el = np.arcsin(np.clip(p_cam[:, 2] / r, -1, 1))
    u = (az + np.pi) / (2 * np.pi) * W
    v = (np.pi / 2 - el) / np.pi * H
    return u, v, r


def _render_frame(landmarks, pose, image_size, camera, seed):
    H, W = image_size
    img = np.zeros((H, W), np.float32)
    q = torch.as_tensor(pose[3:])
    p_cam = geometry.quat_rotate(
        geometry.quat_conjugate(q)[None], torch.as_tensor(landmarks - pose[:3])
    ).numpy()
    rng_tex = np.random.default_rng(seed + 99)
    # stable per-landmark blob signature: size + two satellite offsets make
    # the local BRIEF patterns distinct per landmark
    sizes = rng_tex.uniform(1.5, 3.0, len(landmarks))
    sat = rng_tex.uniform(-6, 6, (len(landmarks), 2, 2))
    sat_amp = rng_tex.uniform(0.3, 0.9, (len(landmarks), 2))

    if camera == "equirect":
        u, v, r = _project_equirect(p_cam, H, W)
        vis = r < 40.0
    else:
        fx = fy = 0.6 * W
        cx, cy = W / 2, H / 2
        z = p_cam[:, 2]
        vis = z > 0.3
        zs = np.where(vis, z, 1.0)
        u = fx * p_cam[:, 0] / zs + cx
        v = fy * p_cam[:, 1] / zs + cy
        vis &= (u >= -8) & (u < W + 8) & (v >= -8) & (v < H + 8)

    ys, xs = np.mgrid[0:H, 0:W]
    for j in np.where(vis)[0]:
        for du, dv, amp in (
            (0.0, 0.0, 1.0),
            (sat[j, 0, 0], sat[j, 0, 1], sat_amp[j, 0]),
            (sat[j, 1, 0], sat[j, 1, 1], sat_amp[j, 1]),
        ):
            uu = u[j] + du
            vv = v[j] + dv
            if camera == "equirect":
                dx = np.abs(xs - uu)
                dx = np.minimum(dx, W - dx)  # azimuth wrap
            else:
                dx = xs - uu
            d2 = dx * dx + (ys - vv) ** 2
            img += amp * np.exp(-d2 / (2 * sizes[j] ** 2))
    return np.clip(img, 0.0, 1.0)


def make_panoramic_world(
    num_landmarks: int = 300,
    num_steps: int = 40,
    image_size: tuple[int, int] = (128, 256),
    camera: str = "equirect",
    radius: float = 8.0,
    odom_noise: tuple[float, float] = (0.01, 0.005),
    seed: int = 11,
) -> SyntheticWorld:
    """The camera walks a circle inside a shell of landmarks, looking
    outward (panoramic): every frame sees all azimuths."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(num_landmarks, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[:, 2] *= 0.4  # flatten vertically so most are near the horizon
    dist = rng.uniform(radius * 1.5, radius * 3.0, num_landmarks)
    landmarks = dirs * dist[:, None]

    th = np.linspace(0, 2 * np.pi, num_steps, endpoint=False)
    se2 = torch.tensor(
        np.stack([0.3 * radius * np.cos(th), 0.3 * radius * np.sin(th), th + np.pi / 2], 1),
        dtype=torch.float32,
    )
    poses = geometry.se2_to_se3(se2)
    if camera == "pinhole":
        # pinhole cameras look along +z (y down): tilt the yaw-only body
        # pose into an optical frame whose z-axis is the heading
        q_bc = torch.tensor([-0.5, 0.5, -0.5, 0.5])
        poses = torch.cat([poses[:, :3], geometry.quat_multiply(poses[:, 3:], q_bc)], 1)
    gt = poses.numpy()
    rel = geometry.se3_log(geometry.se3_between(poses[:-1], poses[1:])).numpy()
    odom = np.zeros((num_steps, 6), np.float32)
    for i in range(1, num_steps):
        noise = np.concatenate([rng.normal(0, odom_noise[0], 3), rng.normal(0, odom_noise[1], 3)])
        odom[i] = rel[i - 1] + noise
    return SyntheticWorld(
        landmarks=landmarks.astype(np.float32), gt_pose=gt, odom=odom,
        image_size=image_size, camera=camera, seed=seed,
    )
