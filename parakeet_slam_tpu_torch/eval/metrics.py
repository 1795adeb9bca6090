"""Trajectory evaluation: ATE / RPE (port of `parakeet_slam_tpu.eval.metrics`).

ATE RMSE follows the TUM benchmark convention: rigid (optionally Sim(3))
Umeyama alignment of estimated to ground-truth positions, then RMSE of the
residual translations.
"""

from __future__ import annotations

import torch

from parakeet_slam_tpu_torch.core.geometry import umeyama, wrap_angle


def ate_rmse(est_xy, gt_xy, with_scale: bool = False) -> torch.Tensor:
    """Absolute trajectory error RMSE after Umeyama alignment.

    est_xy, gt_xy: [T, D] positions (tensors or arrays). Returns a 0-dim tensor.
    """
    est_xy = torch.as_tensor(est_xy)
    gt_xy = torch.as_tensor(gt_xy, device=est_xy.device, dtype=est_xy.dtype)
    s, R, t = umeyama(est_xy, gt_xy, with_scale=with_scale)
    aligned = s * est_xy @ R.T + t
    err = aligned - gt_xy
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1)))


def rpe_rmse(est_pose, gt_pose, delta: int = 1) -> torch.Tensor:
    """Relative pose error (translation RMSE) over stride `delta` for SE(2)
    pose arrays [T, 3]."""
    est_pose = torch.as_tensor(est_pose)
    gt_pose = torch.as_tensor(gt_pose, device=est_pose.device, dtype=est_pose.dtype)

    def rel(p):
        a, b = p[:-delta], p[delta:]
        c, s = torch.cos(a[:, 2]), torch.sin(a[:, 2])
        dx = b[:, 0] - a[:, 0]
        dy = b[:, 1] - a[:, 1]
        return torch.stack(
            [c * dx + s * dy, -s * dx + c * dy, wrap_angle(b[:, 2] - a[:, 2])], dim=1
        )

    d = rel(est_pose) - rel(gt_pose)
    return torch.sqrt(torch.mean(d[:, 0] ** 2 + d[:, 1] ** 2))
