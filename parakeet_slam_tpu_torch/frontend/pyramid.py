"""Image pyramid for multi-scale detection (port of
`parakeet_slam_tpu.frontend.pyramid`).

2x decimation after a box blur (aliasing control); `detect_pyramid` runs
the detector per level and maps the keypoints back to level-0 coordinates
with a per-level tag, under one fixed total feature capacity.
"""

from __future__ import annotations

import torch

from parakeet_slam_tpu_torch.frontend.describe import smooth
from parakeet_slam_tpu_torch.frontend.detect import detect


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Blur + 2x2 average-pool decimation (an odd last row or column is
    dropped); the window summed in row-major order."""
    blurred = smooth(img, radius=1)
    H2, W2 = (blurred.shape[0] // 2) * 2, (blurred.shape[1] // 2) * 2
    b = blurred[:H2, :W2]
    return (b[0::2, 0::2] + b[0::2, 1::2] + b[1::2, 0::2] + b[1::2, 1::2]) / 4.0


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def detect_pyramid(img: torch.Tensor, levels: int = 3, max_features: int = 512,
                   detector: str = "fast", threshold: float = 0.08, nms_radius: int = 4,
                   wrap_x: bool = False):
    """Multi-scale detection: (xy [K, 2] in level-0 coordinates, score [K],
    level [K] int32, valid [K]) with K = max_features across the levels.
    Each level but the last gets max(8, its share of the pixels) of the
    features, the last what remains; level l suppresses non-maxima within
    max(1, nms_radius >> l)."""
    pyr = build_pyramid(img, levels)
    total_px = sum(p.numel() for p in pyr)
    xs, ss, ls, vs = [], [], [], []
    remaining = max_features
    for lvl, p in enumerate(pyr):
        if lvl == levels - 1:
            k = remaining
        else:
            k = min(max(8, int(max_features * p.numel() / total_px)), remaining)
        remaining -= k
        if k <= 0:
            continue
        xy, score, valid = detect(p, max_features=k, detector=detector, threshold=threshold,
                                  nms_radius=max(1, nms_radius >> lvl), wrap_x=wrap_x)
        xs.append(xy * float(2**lvl))
        ss.append(score)
        ls.append(torch.full((k,), lvl, dtype=torch.int32, device=img.device))
        vs.append(valid)
    return torch.cat(xs), torch.cat(ss), torch.cat(ls), torch.cat(vs)
