"""Binary descriptors: BRIEF-256 / steered BRIEF, packed into 8 words
(port of `parakeet_slam_tpu.frontend.describe`).

256 intensity comparisons from a seeded Gaussian pattern on a box-smoothed
image, packed LSB-first into 8 words: the layout `kernels/match` consumes.
The words are int32 carrying the reference's uint32 bits. "Oriented" mode
rotates the pattern per keypoint by the intensity-centroid angle.

The box sum is taken in the reference's window order, so the smoothed image
equals the reference's and with it every comparison.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DESC_BITS = 256
DESC_WORDS = 8  # 256 / 32


def make_pattern(patch_half: int = 15, seed: int = 42) -> np.ndarray:
    """BRIEF sampling pattern [256, 4] = (ax, ay, bx, by), Gaussian, clipped."""
    rng = np.random.default_rng(seed)
    sigma = patch_half / 2.0
    pts = rng.normal(0.0, sigma, size=(DESC_BITS, 4))
    return np.clip(np.round(pts), -patch_half, patch_half).astype(np.float32)


_DEFAULT_PATTERN = make_pattern()


def smooth(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Box smoothing with edge padding (window mean)."""
    w = 2 * radius + 1
    H, W = img.shape
    padded = F.pad(img.to(torch.float32)[None, None], (radius,) * 4, mode="replicate")[0, 0]
    acc = padded[:H, :W]
    for k in range(1, w * w):  # row-major window order, as the reference sums
        dy, dx = divmod(k, w)
        acc = acc + padded[dy:dy + H, dx:dx + W]
    return acc / (w * w)


def _orientation(img: torch.Tensor, xy: torch.Tensor, patch_half: int) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint (ORB): atan2(m01, m10)."""
    H, W = img.shape
    r = patch_half
    ar = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    dy, dx = torch.meshgrid(ar, ar, indexing="ij")
    mask = (dx * dx + dy * dy) <= r * r
    ys = torch.clamp(xy[:, 1, None, None] + dy, 0, H - 1).to(torch.int64)
    xs = torch.clamp(xy[:, 0, None, None] + dx, 0, W - 1).to(torch.int64)
    patch = img.reshape(-1)[ys * W + xs] * mask
    m10 = torch.sum(patch * dx, dim=(1, 2))
    m01 = torch.sum(patch * dy, dim=(1, 2))
    return torch.atan2(m01, m10)


def describe(
    img: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    pattern: torch.Tensor | None = None,
    oriented: bool = False,
    patch_half: int = 15,
    wrap_x: bool = False,
) -> torch.Tensor:
    """BRIEF descriptors for keypoints: img [H, W], xy [K, 2] (x, y) float.
    Returns [K, 8] int32 words (invalid keypoints get zero descriptors)."""
    dev = img.device
    if pattern is None:
        pattern = torch.as_tensor(_DEFAULT_PATTERN, device=dev)
    H, W = img.shape
    flat = smooth(img).reshape(-1)
    K = xy.shape[0]
    if oriented:
        theta = _orientation(flat.reshape(H, W), xy, patch_half)
        c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
        ax = c * pattern[None, :, 0] - s * pattern[None, :, 1]
        ay = s * pattern[None, :, 0] + c * pattern[None, :, 1]
        bx = c * pattern[None, :, 2] - s * pattern[None, :, 3]
        by = s * pattern[None, :, 2] + c * pattern[None, :, 3]
    else:
        ax, ay, bx, by = (pattern[None, :, i].expand(K, DESC_BITS) for i in range(4))

    def sample(px, py):
        xs = torch.round(px).to(torch.int32)
        xs = torch.remainder(xs, W) if wrap_x else torch.clamp(xs, 0, W - 1)
        ys = torch.clamp(torch.round(py).to(torch.int32), 0, H - 1)
        return flat[(ys * W + xs).long()]

    ia = sample(xy[:, 0:1] + ax, xy[:, 1:2] + ay)
    ib = sample(xy[:, 0:1] + bx, xy[:, 1:2] + by)
    bits = (ia < ib).to(torch.int64).reshape(K, DESC_WORDS, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = torch.sum(bits << shifts, dim=-1)  # LSB-first, in [0, 2^32)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return torch.where(valid[:, None], words, torch.zeros_like(words))
