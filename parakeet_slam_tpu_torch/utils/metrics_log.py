"""Structured per-frame metrics logging (JSONL) and trajectory / map export
(a copy of `parakeet_slam_tpu.utils.metrics_log`, numpy only).

Per-frame records (N_eff, landmark count, match rate, keyframes) are
appended to a JSONL file; trajectories export in the TUM format and maps as
.npz for external viewers.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


class MetricsLogger:
    def __init__(self, path: str | None):
        self.path = Path(path) if path else None
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")

    @property
    def writing(self) -> bool:
        """Whether `log` writes anywhere (a file is open)."""
        return self._fh is not None

    def log(self, frame: int, **fields):
        if self._fh is None:
            return
        rec = {"frame": frame, "ts": time.time()}
        for k, v in fields.items():
            if hasattr(v, "item"):
                v = v.item()
            rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def flush(self):
        if self._fh:
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def export_trajectory(path: str, poses, timestamps=None):
    """Export a trajectory in TUM format (ts x y z qx qy qz qw) so standard
    external tools (evo, rviz bridges) can consume it."""
    poses = np.asarray(poses)
    T = poses.shape[0]
    if timestamps is None:
        timestamps = np.arange(T, dtype=np.float64)
    with open(path, "w") as f:
        for i in range(T):
            p = poses[i]
            if p.shape[-1] == 3:  # SE(2): lift
                x, y, th = p
                row = [x, y, 0.0, 0.0, 0.0, np.sin(th / 2), np.cos(th / 2)]
            else:
                row = list(p)
            f.write(f"{timestamps[i]:.6f} " + " ".join(f"{v:.6f}" for v in row) + "\n")


def export_map(path: str, means, valid):
    """Export landmark means (valid rows only) as .npz for visualization."""
    means = np.asarray(means)
    valid = np.asarray(valid)
    np.savez(path, landmarks=means[valid])
