"""KITTI odometry dataset loader, sequence 00 for benchmark config 3 (a copy
of `parakeet_slam_tpu.data.kitti`, numpy only).

Format (the KITTI odometry devkit):
  sequences/NN/image_0/*.png, image_1/*.png  rectified stereo grayscale
  sequences/NN/calib.txt                     P0..P3 3x4 projections
  sequences/NN/times.txt                     per-frame timestamps
  poses/NN.txt                               3x4 ground-truth cam0 poses
Images are decoded to grayscale float32 [0, 1] by OpenCV, imported on first
use.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class KITTISequence:
    root: Path          # .../sequences/NN
    n_frames: int
    timestamps: np.ndarray
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float     # meters between cam0 and cam1
    gt_pose: np.ndarray | None  # [T, 3, 4] world-from-cam0

    def __len__(self):
        return self.n_frames

    def image(self, i: int, right: bool = False) -> np.ndarray:
        import cv2

        cam = "image_1" if right else "image_0"
        p = self.root / cam / f"{i:06d}.png"
        img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(p)
        return img.astype(np.float32) / 255.0

    def gt_positions(self) -> np.ndarray:
        """[T, 3] ground-truth camera positions (for ATE)."""
        if self.gt_pose is None:
            raise ValueError("no ground truth available")
        return self.gt_pose[:, :, 3]


def _parse_calib(path: Path):
    vals = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals[k.strip()] = np.array([float(x) for x in v.split()]).reshape(3, 4)
    return vals


def load_kitti(sequence_dir: str, poses_file: str | None = None) -> KITTISequence:
    root = Path(sequence_dir)
    calib = _parse_calib(root / "calib.txt")
    P0, P1 = calib["P0"], calib["P1"]
    fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
    # P1[0, 3] = -fx * baseline for the right camera
    baseline = -P1[0, 3] / fx
    times_path = root / "times.txt"
    ts = np.loadtxt(times_path) if times_path.exists() else None
    n = len(sorted((root / "image_0").glob("*.png")))
    if ts is None:
        ts = np.arange(n, dtype=np.float64) * 0.1
    gt = None
    if poses_file is None:
        cand = root.parent.parent / "poses" / f"{root.name}.txt"
        poses_file = str(cand) if cand.exists() else None
    if poses_file and Path(poses_file).exists():
        gt = np.loadtxt(poses_file).reshape(-1, 3, 4).astype(np.float32)
    return KITTISequence(
        root=root, n_frames=n, timestamps=ts,
        fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
        baseline=float(baseline), gt_pose=gt,
    )
