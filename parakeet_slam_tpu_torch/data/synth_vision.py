"""Synthetic vision worlds (port of `parakeet_slam_tpu.data.synth_vision`):
a TUM fr1/desk-class monocular world (benchmark config 2), a KITTI
00-class stereo world (benchmark config 3) and a EuRoC machine-hall world
of several sessions (benchmark config 4), rendered as Gaussian-blob images
through a real camera, and the TUM, EuRoC and KITTI on-disk writers.

The numpy random streams are the reference's, so the landmarks, poses,
odometry and textures equal the JAX package's (the geometry runs in
float32 torch here, as in jnp there). Rendering is a vectorised local-patch
splat (numpy `add.at` over [N_blobs, S, S] windows); each landmark carries
a stable 3-blob texture so BRIEF descriptors repeat across frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from parakeet_slam_tpu_torch.core import geometry

# body (x-forward, z-up, yaw) -> optical (z-forward, y-down) quaternion
_Q_BC = np.array([-0.5, 0.5, -0.5, 0.5], np.float32)

_PATCH_R = 12  # splat window radius (3 sigma of the largest blob + satellites)


def _splat(img, u, v, amp, sigma, wrap_x):
    """Accumulate Gaussian blobs at float centres (u, v) into img in place;
    only a (2R+1)^2 window per blob is touched."""
    H, W = img.shape
    if len(u) == 0:
        return
    R = _PATCH_R
    off = np.arange(-R, R + 1)
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    gx = ui[:, None] + off[None, :]                       # [N, S]
    gy = vi[:, None] + off[None, :]                       # [N, S]
    dx = gx - u[:, None]
    dy = gy - v[:, None]
    val = amp[:, None, None] * np.exp(
        -(dx[:, None, :] ** 2 + dy[:, :, None] ** 2) / (2.0 * sigma[:, None, None] ** 2)
    )                                                     # [N, S, S]
    ok_y = (gy >= 0) & (gy < H)
    if wrap_x:
        gx = gx % W
        ok_x = np.ones_like(gx, bool)
    else:
        ok_x = (gx >= 0) & (gx < W)
    mask = ok_y[:, :, None] & ok_x[:, None, :]
    np.add.at(
        img,
        (np.clip(gy, 0, H - 1)[:, :, None].repeat(2 * R + 1, axis=2),
         np.clip(gx, 0, W - 1)[:, None, :].repeat(2 * R + 1, axis=1)),
        np.where(mask, val, 0.0),
    )


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

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 99)
        n = len(self.landmarks)
        self._sizes = rng.uniform(1.6, 3.0, n).astype(np.float32)
        self._sat = rng.uniform(-6, 6, (n, 2, 2)).astype(np.float32)
        self._sat_amp = rng.uniform(0.35, 0.9, (n, 2)).astype(np.float32)

    def __len__(self):
        return self.gt_pose.shape[0]

    def _render_pose(self, pose: np.ndarray) -> np.ndarray:
        H, W = self.image_size
        fx, fy, cx, cy = self.intrinsics
        t, q = pose[:3], torch.as_tensor(pose[3:])
        p_cam = geometry.quat_rotate(
            geometry.quat_conjugate(q)[None], torch.as_tensor(self.landmarks - t)
        ).numpy()
        z = p_cam[:, 2]
        vis = (z > 0.25) & (z < self.max_render_range)
        zs = np.where(vis, z, 1.0)
        u = fx * p_cam[:, 0] / zs + cx
        v = fy * p_cam[:, 1] / zs + cy
        m = _PATCH_R
        vis &= (u >= -m) & (u < W + m) & (v >= -m) & (v < H + m)
        j = np.where(vis)[0]
        img = np.zeros((H, W), np.float32)
        # centre blob + two satellite blobs per visible landmark
        us = np.concatenate([u[j], u[j] + self._sat[j, 0, 0], u[j] + self._sat[j, 1, 0]])
        vs = np.concatenate([v[j], v[j] + self._sat[j, 0, 1], v[j] + self._sat[j, 1, 1]])
        amps = np.concatenate(
            [np.ones(len(j), np.float32), self._sat_amp[j, 0], self._sat_amp[j, 1]]
        )
        sig = np.concatenate([self._sizes[j]] * 3)
        _splat(img, us, vs, amps, sig, wrap_x=False)
        return np.clip(img, 0.0, 1.0)

    def render(self, i: int) -> np.ndarray:
        """Grayscale [H, W] float32 frame i in [0, 1]."""
        return self._render_pose(self.gt_pose[i])

    def render_stereo(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        assert self.baseline > 0, "monocular world"
        pose = self.gt_pose[i]
        right_pose = pose.copy()
        right_pose[:3] = geometry.se3_apply(
            torch.as_tensor(pose), torch.tensor([self.baseline, 0.0, 0.0])
        ).numpy()
        return self._render_pose(pose), self._render_pose(right_pose)


def _odometry(poses, rng, odom_noise):
    """Noisy body-frame twist increments [T, 6] of a pose track (row 0 is
    zero), drawn in the reference's order."""
    T = len(poses)
    poses_t = torch.as_tensor(poses)
    rel = geometry.se3_log(geometry.se3_between(poses_t[:-1], poses_t[1:])).numpy()
    odom = np.zeros((T, 6), np.float32)
    for i in range(1, T):
        noise = np.concatenate(
            [rng.normal(0, odom_noise[0], 3), rng.normal(0, odom_noise[1], 3)]
        )
        odom[i] = rel[i - 1] + noise
    return odom


def _poses_from_track(xy, yaw, height, rng, odom_noise):
    """Yaw-only body track -> optical-frame SE(3) poses + noisy odometry."""
    T = len(xy)
    se2 = torch.tensor(np.stack([xy[:, 0], xy[:, 1], yaw], 1), dtype=torch.float32)
    p = geometry.se2_to_se3(se2)
    q = geometry.quat_multiply(p[:, 3:], torch.as_tensor(_Q_BC))
    t = torch.cat([p[:, :2], torch.as_tensor(np.asarray(height, np.float32))[:, None]], 1)
    poses = torch.cat([t, q], 1).numpy()
    return poses, _odometry(poses, rng, odom_noise)


def make_desk_world(
    num_landmarks: int = 1000,
    num_steps: int = 600,
    image_size: tuple[int, int] = (480, 640),
    intrinsics: tuple[float, ...] = (517.3, 516.5, 318.6, 255.3),
    orbit_radius: float = 1.8,
    odom_noise: tuple[float, float] = (0.004, 0.002),
    seed: int = 20,
) -> VisionWorld:
    """TUM fr1/desk-class monocular world (benchmark config 2): a handheld-like
    camera orbits a cluttered desk twice, so the second orbit revisits the
    first (loop closures); 640x480 at fr1 intrinsics, ~1k landmarks."""
    rng = np.random.default_rng(seed)
    n_desk = int(num_landmarks * 0.6)
    n_room = num_landmarks - n_desk
    desk = np.stack(
        [rng.uniform(-0.7, 0.7, n_desk), rng.uniform(-0.5, 0.5, n_desk),
         rng.uniform(0.0, 0.35, n_desk)], axis=1,
    )
    # room shell: points on walls 2.5-4 m out, at desk-to-ceiling heights
    az = rng.uniform(0, 2 * np.pi, n_room)
    r = rng.uniform(2.5, 4.0, n_room)
    room = np.stack([r * np.cos(az), r * np.sin(az), rng.uniform(-0.7, 1.4, n_room)], axis=1)
    landmarks = np.concatenate([desk, room]).astype(np.float32)

    th = np.linspace(0, 4 * np.pi, num_steps, endpoint=False)  # two orbits
    # handheld wobble on radius and height
    wob_r = 0.12 * np.sin(3.1 * th) + 0.05 * np.sin(7.3 * th)
    wob_h = 0.08 * np.sin(2.3 * th + 1.0)
    rad = orbit_radius + wob_r
    xy = np.stack([rad * np.cos(th), rad * np.sin(th)], axis=1)
    yaw = th + np.pi  # face the desk centre
    height = 0.85 + wob_h
    poses, _ = _poses_from_track(xy, yaw, height, rng, odom_noise)
    # pitch the camera down toward the desk surface (about optical x)
    pitch = np.deg2rad(22.0)
    q_pitch = np.array([np.sin(pitch / 2) * -1.0, 0.0, 0.0, np.cos(pitch / 2)], np.float32)
    poses[:, 3:] = geometry.quat_multiply(
        torch.as_tensor(poses[:, 3:]), torch.as_tensor(q_pitch)
    ).numpy()
    # the odometry is drawn again after the pitch (the increments change)
    odom = _odometry(poses, rng, odom_noise)
    return VisionWorld(
        landmarks=landmarks, gt_pose=poses, odom=odom, image_size=image_size,
        intrinsics=tuple(float(x) for x in intrinsics[:4]), baseline=0.0,
        max_render_range=8.0, seed=seed,
    )


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
    """KITTI 00-class stereo world (benchmark config 3): a closed rounded-square
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


def make_hall_world(
    num_landmarks: int = 8000,
    num_steps: int = 400,
    session: int = 0,
    image_size: tuple[int, int] = (480, 752),
    intrinsics: tuple[float, ...] = (458.654, 457.296, 367.215, 248.375),
    odom_noise: tuple[float, float] = (0.01, 0.004),
    seed: int = 30,
) -> VisionWorld:
    """EuRoC MH-class multi-session world (benchmark config 4): a machine
    hall (points on its four walls and around 12 interior structures) flown
    in an oval loop, two laps. `session` varies the loop's radius, height
    and phase; the landmarks depend on `seed` alone, so every session
    revisits the same structure and the cross-session closures and the
    joint BA of config 4 have real overlap to work on."""
    rng = np.random.default_rng(seed)  # session-independent: one shared world
    hx, hy, hz = 9.0, 6.0, 3.0  # hall half-extents (z: 0..2*hz)
    n_wall = int(num_landmarks * 0.6)
    n_struct = num_landmarks - n_wall
    side = rng.integers(0, 4, n_wall)
    u = rng.uniform(-1, 1, n_wall)
    z = rng.uniform(0.0, 2 * hz, n_wall)
    wx = np.where(side == 0, hx, np.where(side == 1, -hx, u * hx))
    wy = np.where(side < 2, u * hy, np.where(side == 2, hy, -hy))
    walls = np.stack([wx, wy, z], axis=1)
    n_clusters = 12
    centers = np.stack([
        rng.uniform(-hx * 0.7, hx * 0.7, n_clusters),
        rng.uniform(-hy * 0.7, hy * 0.7, n_clusters),
        rng.uniform(0.2, 2 * hz * 0.7, n_clusters),
    ], axis=1)
    ci = rng.integers(0, n_clusters, n_struct)
    struct = centers[ci] + rng.normal(0, 0.6, (n_struct, 3))
    landmarks = np.concatenate([walls, struct]).astype(np.float32)

    srng = np.random.default_rng(seed + 1000 + session)
    rx = 4.5 + 0.6 * session
    ry = 2.8 + 0.35 * session
    h0 = 1.0 + 0.45 * session
    th = np.linspace(0, 4 * np.pi, num_steps, endpoint=False) + session * 1.1
    wob = 0.15 * np.sin(2.7 * th) + 0.06 * np.sin(6.1 * th)
    xy = np.stack([(rx + wob) * np.cos(th), (ry + wob) * np.sin(th)], axis=1)
    # facing along the direction of travel
    yaw = np.arctan2((ry + wob) * np.cos(th), -(rx + wob) * np.sin(th))
    height = h0 + 0.25 * np.sin(1.7 * th)
    poses, odom = _poses_from_track(xy, yaw, height, srng, odom_noise)
    return VisionWorld(
        landmarks=landmarks, gt_pose=poses, odom=odom, image_size=image_size,
        intrinsics=tuple(float(x) for x in intrinsics[:4]), baseline=0.0,
        max_render_range=14.0, seed=seed,
    )


def write_tum_format(world: VisionWorld, out_dir: str, fps: float = 30.0):
    """Write rgb/*.png + rgb.txt + groundtruth.txt (the TUM RGB-D layout
    that `data/tum.py` reads)."""
    import cv2

    out = Path(out_dir)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    rgb_lines = ["# color images", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for i in range(len(world)):
        ts = i / fps
        name = f"rgb/{ts:.6f}.png"
        cv2.imwrite(str(out / name), (world.render(i) * 255).astype(np.uint8))
        rgb_lines.append(f"{ts:.6f} {name}")
        gt_lines.append(f"{ts:.6f} " + " ".join(f"{x:.6f}" for x in world.gt_pose[i]))
    (out / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (out / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")


def write_euroc_format(world: VisionWorld, out_dir: str, fps: float = 20.0):
    """Write mav0/cam0/{data.csv,data/*.png} and
    mav0/state_groundtruth_estimate0/data.csv (the ASL layout that
    `data/euroc.py` reads; the ground-truth quaternion is stored qw first).
    Returns out_dir."""
    import cv2

    out = Path(out_dir)
    cam = out / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True, exist_ok=True)
    gt_dir = out / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True, exist_ok=True)
    cam_rows = ["#timestamp [ns],filename"]
    gt_rows = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
               "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []"]
    for i in range(len(world)):
        ts_ns = int(i / fps * 1e9)
        name = f"{ts_ns}.png"
        cv2.imwrite(str(cam / "data" / name), (world.render(i) * 255).astype(np.uint8))
        cam_rows.append(f"{ts_ns},{name}")
        p = world.gt_pose[i]
        gt_rows.append(f"{ts_ns},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f},"
                       f"{p[6]:.6f},{p[3]:.6f},{p[4]:.6f},{p[5]:.6f}")  # qw first
    (cam / "data.csv").write_text("\n".join(cam_rows) + "\n")
    (gt_dir / "data.csv").write_text("\n".join(gt_rows) + "\n")
    return str(out)


def write_kitti_format(world: VisionWorld, out_dir: str, sequence: str = "00"):
    """Write sequences/NN/{image_0,image_1,calib.txt,times.txt} and
    poses/NN.txt (the KITTI odometry layout that `data/kitti.py` reads).
    Returns the sequence directory."""
    import cv2

    out = Path(out_dir)
    seq = out / "sequences" / sequence
    (seq / "image_0").mkdir(parents=True, exist_ok=True)
    (seq / "image_1").mkdir(parents=True, exist_ok=True)
    (out / "poses").mkdir(parents=True, exist_ok=True)
    fx, fy, cx, cy = world.intrinsics
    P0 = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -fx * world.baseline
    with open(seq / "calib.txt", "w") as f:
        for name, P in (("P0", P0), ("P1", P1), ("P2", P0), ("P3", P1)):
            f.write(name + ": " + " ".join(f"{x:.12e}" for x in P.ravel()) + "\n")
    times, pose_rows = [], []
    for i in range(len(world)):
        left, right = world.render_stereo(i)
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), (left * 255).astype(np.uint8))
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), (right * 255).astype(np.uint8))
        times.append(f"{i * 0.1:.6e}")
        p = world.gt_pose[i]
        R = geometry.quat_to_matrix(torch.as_tensor(p[3:])).numpy()
        M = np.concatenate([R, p[:3, None]], axis=1)  # world-from-cam0 3x4
        pose_rows.append(" ".join(f"{x:.9e}" for x in M.ravel()))
    (seq / "times.txt").write_text("\n".join(times) + "\n")
    (out / "poses" / f"{sequence}.txt").write_text("\n".join(pose_rows) + "\n")
    return str(seq)
