"""Map / trajectory visualization to PNG (the rviz-marker analog,
SURVEY.md §1 L5 — offline files instead of live ROS topics). A copy of
`parakeet_slam_tpu/utils/viz.py` (numpy and OpenCV, no torch)."""

from __future__ import annotations

import numpy as np


def render_map_png(
    path: str,
    trajectory: np.ndarray,           # [T, >=2] positions
    landmarks: np.ndarray | None = None,   # [N, >=2]
    gt_trajectory: np.ndarray | None = None,
    size: int = 800,
    margin: float = 0.08,
):
    """Top-down (x, y) rendering via OpenCV drawing primitives."""
    import cv2

    pts = [np.asarray(trajectory)[:, :2]]
    if landmarks is not None and len(landmarks):
        pts.append(np.asarray(landmarks)[:, :2])
    if gt_trajectory is not None:
        pts.append(np.asarray(gt_trajectory)[:, :2])
    allp = np.concatenate(pts, axis=0)
    lo = allp.min(0)
    hi = allp.max(0)
    span = np.maximum(hi - lo, 1e-6)
    scale = size * (1 - 2 * margin) / span.max()

    def to_px(p):
        q = (p - lo) * scale + size * margin
        return np.stack([q[:, 0], size - q[:, 1]], axis=1).astype(np.int32)

    img = np.full((size, size, 3), 255, np.uint8)
    if landmarks is not None and len(landmarks):
        for x, y in to_px(np.asarray(landmarks)[:, :2]):
            cv2.circle(img, (int(x), int(y)), 2, (180, 180, 180), -1)
    if gt_trajectory is not None:
        px = to_px(np.asarray(gt_trajectory)[:, :2])
        cv2.polylines(img, [px], False, (0, 200, 0), 1)
    px = to_px(np.asarray(trajectory)[:, :2])
    cv2.polylines(img, [px], False, (255, 0, 0), 2)
    cv2.circle(img, tuple(px[0]), 5, (0, 0, 255), -1)
    cv2.imwrite(path, img)
    return path
