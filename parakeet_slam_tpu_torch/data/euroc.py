"""EuRoC MAV dataset loader, MH01-05 for benchmark config 4 (a copy of
`parakeet_slam_tpu.data.euroc`, numpy only).

ASL format (projects.asl.ethz.ch/datasets):
  mav0/cam0/data.csv           "timestamp_ns, filename"
  mav0/cam0/data/*.png         grayscale images
  mav0/cam0/sensor.yaml        intrinsics + T_BS extrinsics
  mav0/state_groundtruth_estimate0/data.csv
        "ts, px, py, pz, qw, qx, qy, qz, ..." (NOTE: qw FIRST)

A multi-session run (MH01..MH05) runs the sequences one after another, each
from its own starting pose; the checkpoint round trip
(`SLAMSystem.save_checkpoint` / `load_checkpoint`) carries the filter, map
and graph across each session boundary. Images are decoded to grayscale
float32 [0, 1] by OpenCV, imported on first use.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# Standard EuRoC cam0 intrinsics (identical across MH sequences).
EUROC_INTRINSICS = (458.654, 457.296, 367.215, 248.375)


@dataclass
class EuRoCSequence:
    root: Path
    timestamps: np.ndarray      # [T] seconds
    image_files: list[str]
    gt_pose: np.ndarray         # [T, 7] (t, qxyzw), NaN when unmatched
    intrinsics: tuple

    def __len__(self):
        return len(self.image_files)

    def image(self, i: int) -> np.ndarray:
        import cv2

        p = self.root / "mav0" / "cam0" / "data" / self.image_files[i]
        img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(p)
        return img.astype(np.float32) / 255.0


def load_euroc(root: str, max_dt: float = 0.01) -> EuRoCSequence:
    root_p = Path(root)
    cam_csv = root_p / "mav0" / "cam0" / "data.csv"
    ts, files = [], []
    with open(cam_csv) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(int(row[0]) * 1e-9)
            files.append(row[1].strip())
    ts = np.array(ts)

    gt = np.full((len(files), 7), np.nan, np.float32)
    gt_csv = root_p / "mav0" / "state_groundtruth_estimate0" / "data.csv"
    if gt_csv.exists():
        g_ts, g_pose = [], []
        with open(gt_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                g_ts.append(int(row[0]) * 1e-9)
                px, py, pz = float(row[1]), float(row[2]), float(row[3])
                qw, qx, qy, qz = (
                    float(row[4]), float(row[5]), float(row[6]), float(row[7])
                )
                g_pose.append([px, py, pz, qx, qy, qz, qw])  # reorder to xyzw
        g_ts = np.array(g_ts)
        g_pose = np.array(g_pose, np.float32)
        idx = np.searchsorted(g_ts, ts)
        idx = np.clip(idx, 0, len(g_ts) - 1)
        prev = np.clip(idx - 1, 0, len(g_ts) - 1)
        pick = np.where(
            np.abs(g_ts[prev] - ts) < np.abs(g_ts[idx] - ts), prev, idx
        )
        ok = np.abs(g_ts[pick] - ts) < max_dt
        gt[ok] = g_pose[pick[ok]]
    return EuRoCSequence(
        root=root_p, timestamps=ts, image_files=files, gt_pose=gt,
        intrinsics=EUROC_INTRINSICS,
    )


def load_multi_session(roots: list[str]) -> list[EuRoCSequence]:
    """MH01-05 multi-session config: one sequence object per session."""
    return [load_euroc(r) for r in roots]
