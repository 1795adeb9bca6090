"""Feature detection: FAST-16 corners or Harris, max-pool NMS and a
fixed-capacity top-k (port of `parakeet_slam_tpu.frontend.detect`).

Every stage is a whole-image tensor program: the FAST segment test reads 16
shifted views of the image, NMS is max-pool equality, and the keypoints are
the `max_features` best scores. `wrap_x=True` (panoramic frames) wraps the
azimuth axis so the ring and NMS windows see across the seam.

Floats are summed in the reference's order (sequentially over the ring and
over window offsets), so the score maps, and with them the keypoints, equal
the reference's. The top-k keeps the reference's tie order (equal scores:
lower flat index first) through a stable descending sort; `torch.topk`
does not promise that order on CUDA, and NMS keeps plateaus of equal
scores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# FAST-16 Bresenham circle offsets (radius 3), clockwise from 12 o'clock.
_FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shift2d(img: torch.Tensor, dy: int, dx: int, wrap_x: bool) -> torch.Tensor:
    """View of img shifted so out[y, x] = img[y+dy, x+dx] (zero/wrap pad)."""
    out = torch.roll(img, (-dy, -dx), dims=(0, 1))
    H, W = img.shape
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    if dy != 0:  # vertical never wraps
        ys = torch.arange(H, device=img.device)
        out = torch.where(((ys + dy >= 0) & (ys + dy < H))[:, None], out, zero)
    if dx != 0 and not wrap_x:
        xs = torch.arange(W, device=img.device)
        out = torch.where(((xs + dx >= 0) & (xs + dx < W))[None, :], out, zero)
    return out


def _has_run(mask: torch.Tensor, arc: int) -> torch.Tensor:
    """[16, H, W] bool -> [H, W]: any circular run of `arc` true ring values
    (window sums of the ring extended by arc-1, equal to arc)."""
    ext = torch.cat([mask, mask[: arc - 1]], dim=0).to(torch.int32)
    cs = torch.cumsum(ext, dim=0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs], dim=0)
    runs = cs[arc:arc + 16] - cs[:16]
    return (runs == arc).any(dim=0)


def fast_score(img: torch.Tensor, threshold: float, arc: int = 9, wrap_x: bool = False):
    """FAST-16 corner score map [H, W] (0 where not a corner): the sum of
    |ring - center| over ring pixels past the threshold, gated on an
    `arc`-long contiguous bright or dark run."""
    img = img.to(torch.float32)
    ring = torch.stack([_shift2d(img, dy, dx, wrap_x) for dy, dx in _FAST_RING], dim=0)
    diff = ring - img[None]
    bright = diff > threshold
    dark = diff < -threshold
    is_corner = _has_run(bright, arc) | _has_run(dark, arc)
    terms = torch.where(bright | dark, torch.abs(diff), torch.zeros_like(diff))
    strength = terms[0]
    for k in range(1, 16):  # the reference's order
        strength = strength + terms[k]
    score = torch.where(is_corner, strength, torch.zeros_like(strength))
    H, W = img.shape
    ys = torch.arange(H, device=img.device)
    score = torch.where(((ys >= 3) & (ys < H - 3))[:, None], score, torch.zeros_like(score))
    if not wrap_x:
        xs = torch.arange(W, device=img.device)
        score = torch.where(((xs >= 3) & (xs < W - 3))[None, :], score, torch.zeros_like(score))
    return score


def _window_sum(a: torch.Tensor, w: int) -> torch.Tensor:
    """'VALID' w x w window sums, taken in row-major window order."""
    H, W = a.shape[0] - w + 1, a.shape[1] - w + 1
    acc = a[:H, :W]
    for k in range(1, w * w):
        dy, dx = divmod(k, w)
        acc = acc + a[dy:dy + H, dx:dx + W]
    return acc


def harris_score(img: torch.Tensor, k: float = 0.04, window: int = 5, wrap_x: bool = False):
    """Harris corner response from a box-filtered structure tensor."""
    img = img.to(torch.float32)
    gx = 0.5 * (_shift2d(img, 0, 1, wrap_x) - _shift2d(img, 0, -1, wrap_x))
    gy = 0.5 * (_shift2d(img, 1, 0, wrap_x) - _shift2d(img, -1, 0, wrap_x))
    r = window // 2

    def box(a):
        a = F.pad(a, (0, 0, r, r))
        a = F.pad(a[None], (r, r), mode="circular")[0] if wrap_x else F.pad(a, (r, r))
        return _window_sum(a, window)

    ixx, iyy, ixy = box(gx * gx), box(gy * gy), box(gx * gy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def nms(score: torch.Tensor, radius: int, wrap_x: bool = False):
    """Keep only local maxima in a (2r+1)^2 window (max-pool equality)."""
    w = 2 * radius + 1
    s = score[None, None]
    if wrap_x:
        s = F.pad(s, (radius, radius, 0, 0), mode="circular")
        local_max = F.max_pool2d(s, w, stride=1, padding=(radius, 0))
    else:
        local_max = F.max_pool2d(s, w, stride=1, padding=radius)
    keep = (score == local_max[0, 0]) & (score > 0.0)
    return torch.where(keep, score, torch.zeros_like(score))


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, equal
    values lower index first (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def detect(
    img: torch.Tensor,
    max_features: int = 512,
    detector: str = "fast",
    threshold: float = 0.08,
    nms_radius: int = 4,
    wrap_x: bool = False,
    arc: int = 9,
):
    """Keypoints of a grayscale [H, W] image in [0, 1]: (xy [K, 2] float32
    (x=col, y=row), score [K], valid [K]) at static capacity K=max_features."""
    if detector == "fast":
        score = fast_score(img, threshold, arc=arc, wrap_x=wrap_x)
    elif detector == "harris":
        score = harris_score(img, wrap_x=wrap_x)
    else:
        raise ValueError(f"unknown detector {detector!r}")
    score = nms(score, nms_radius, wrap_x=wrap_x)
    W = score.shape[1]
    top, idx = top_k_stable(score.reshape(-1), max_features)
    ys = (idx // W).to(torch.float32)
    xs = (idx % W).to(torch.float32)
    return torch.stack([xs, ys], dim=-1), top, top > 0.0
