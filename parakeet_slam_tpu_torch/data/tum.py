"""TUM RGB-D dataset loader (fr1/desk, benchmark config 2; a copy of
`parakeet_slam_tpu.data.tum`, numpy only).

Format (vision.in.tum.de/data/datasets/rgbd-dataset/file_formats):
  rgb.txt          lines "timestamp filename", '#' comments
  groundtruth.txt  lines "timestamp tx ty tz qx qy qz qw"
Association by nearest timestamp within a tolerance window, exactly like
the benchmark's associate.py convention. Images decoded to grayscale
float32 [0, 1] via OpenCV, imported on first use.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

TUM_INTRINSICS = {
    # fx, fy, cx, cy per freiburg sequence family
    "fr1": (517.3, 516.5, 318.6, 255.3),
    "fr2": (520.9, 521.0, 325.1, 249.7),
    "fr3": (535.4, 539.2, 320.1, 247.6),
}


def _read_list_file(path: Path) -> list[tuple[float, list[str]]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append((float(parts[0]), parts[1:]))
    return rows


def associate(
    a: list[tuple[float, list[str]]],
    b: list[tuple[float, list[str]]],
    max_dt: float = 0.02,
) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py semantics)."""
    pairs = []
    bi = 0
    used = set()
    for ia, (ta, _) in enumerate(a):
        # advance to closest b
        best, best_dt = -1, max_dt
        for ib in range(max(bi - 2, 0), len(b)):
            dt = abs(b[ib][0] - ta)
            if dt <= best_dt and ib not in used:
                best, best_dt = ib, dt
            if b[ib][0] > ta + max_dt:
                break
        if best >= 0:
            pairs.append((ia, best))
            used.add(best)
            bi = best
    return pairs


@dataclass
class TUMSequence:
    root: Path
    timestamps: np.ndarray        # [T]
    image_files: list[str]        # [T]
    gt_pose: np.ndarray           # [T, 7] (t, qxyzw); NaN rows if no gt
    intrinsics: tuple[float, float, float, float]

    def __len__(self):
        return len(self.image_files)

    def image(self, i: int) -> np.ndarray:
        import cv2

        img = cv2.imread(str(self.root / self.image_files[i]), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(self.root / self.image_files[i])
        return img.astype(np.float32) / 255.0


def load_tum(root: str, family: str = "fr1") -> TUMSequence:
    root_p = Path(root)
    rgb = _read_list_file(root_p / "rgb.txt")
    ts = np.array([t for t, _ in rgb])
    files = [p[0] for _, p in rgb]
    gt_path = root_p / "groundtruth.txt"
    gt = np.full((len(rgb), 7), np.nan, np.float32)
    if gt_path.exists():
        gt_rows = _read_list_file(gt_path)
        pairs = associate(rgb, gt_rows)
        for ia, ib in pairs:
            gt[ia] = np.array([float(x) for x in gt_rows[ib][1]], np.float32)
    return TUMSequence(
        root=root_p, timestamps=ts, image_files=files, gt_pose=gt,
        intrinsics=TUM_INTRINSICS[family],
    )
