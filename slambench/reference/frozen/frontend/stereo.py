"""Stereo disparity for detected keypoints, the KITTI config 3 path (port of
`parakeet_slam_tpu.frontend.stereo`).

Per left-image keypoint, a SAD block match over `max_disp` horizontal
shifts of the right image on (2 patch + 1)^2 patches with clipped edges,
all shifts at once: one index computation for the [D, K, P, P] samples, a
sum and an argmin over D (the first shift on ties, as the reference's).
Sub-pixel refinement by a parabola through the SADs at best - 1, best and
best + 1. The reference's arithmetic is kept as it is: a negative
parabola denominator is raised to 1e-6 and the offset clipped to +-1.
Plain torch ops: the reference is plain XLA, no TPU kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def keypoint_disparity(left: torch.Tensor, right: torch.Tensor, xy: torch.Tensor,
                       valid: torch.Tensor, max_disp: int = 64, patch: int = 4):
    """(disparity [K] float32, dvalid [K] bool) of keypoints xy [K, 2] (x, y)
    in the left image, for grayscale left and right [H, W]. A keypoint is
    valid when `valid`, its best shift is inside (0, max_disp - 1), the
    right patch lies at most 2 pixels past the image's left edge, and its
    best SAD is under 0.35 of the left patch's energy; invalid keypoints get
    disparity 0."""
    H, W = left.shape
    dev = left.device
    r = torch.arange(-patch, patch + 1, device=dev)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    xi = torch.round(xy[:, 0]).to(torch.int64)
    yi = torch.round(xy[:, 1]).to(torch.int64)
    rows = torch.clamp(yi[:, None, None] + dy, 0, H - 1) * W  # [K, P, P]
    cols = xi[:, None, None] + dx
    left_patches = left.reshape(-1)[rows + torch.clamp(cols, 0, W - 1)]
    d = torch.arange(max_disp, device=dev)[:, None, None, None]
    right_patches = right.reshape(-1)[rows + torch.clamp(cols - d, 0, W - 1)]  # [D, K, P, P]
    sads = torch.sum(torch.abs(left_patches - right_patches), dim=(2, 3))  # [D, K]
    best = torch.argmin(sads, dim=0)
    best_sad = torch.amin(sads, dim=0)

    # sub-pixel parabola on (d - 1, d, d + 1)
    s0 = torch.gather(sads, 0, torch.clamp(best - 1, 0, max_disp - 1)[None])[0]
    s2 = torch.gather(sads, 0, torch.clamp(best + 1, 0, max_disp - 1)[None])[0]
    denom = s0 - 2 * best_sad + s2
    offset = torch.where(torch.abs(denom) > 1e-6,
                         0.5 * (s0 - s2) / torch.clamp(denom, min=1e-6),
                         torch.zeros_like(denom))
    disp = best.to(torch.float32) + torch.clamp(offset, -1.0, 1.0)

    # validity: in range, not at the search edge, a decent contrast ratio
    patch_energy = torch.sum(torch.abs(left_patches), dim=(1, 2)) + 1e-6
    ok = (valid & (best > 0) & (best < max_disp - 1) & (xi - best >= -2)
          & (best_sad / patch_energy < 0.35))
    return torch.where(ok, disp, torch.zeros_like(disp)), ok


def near_ties(left: np.ndarray, right: np.ndarray, xy: np.ndarray, max_disp: int = 64,
              patch: int = 4, gap: float = 1e-6) -> np.ndarray:
    """[K] bool: keypoints whose two smallest SADs, summed in float64 over
    the same clipped patches, lie within a relative `gap` of each other.
    Where sums run in another order (XLA, another device), such a keypoint
    may take the other shift; nothing else may."""
    H, W = left.shape
    r = np.arange(-patch, patch + 1)
    xi, yi = np.round(xy[:, 0]).astype(int), np.round(xy[:, 1]).astype(int)
    ys = np.clip(yi[:, None, None] + r[:, None], 0, H - 1)
    xs = xi[:, None, None] + r[None, :]
    lp = left.astype(np.float64)[ys, np.clip(xs, 0, W - 1)]
    d = np.arange(max_disp)[:, None, None, None]
    rp = right.astype(np.float64)[ys[None], np.clip(xs[None] - d, 0, W - 1)]
    sads = np.sort(np.abs(lp[None] - rp).sum(axis=(2, 3)), axis=0)
    return sads[1] - sads[0] <= gap * np.maximum(sads[0], 1e-30)
