"""SE(2) geometry and trajectory alignment (the subset of
`parakeet_slam_tpu.core.geometry` that the 2-D filter path needs).

SE(2) poses are [x, y, theta] tensors with any leading batch dims.
"""

from __future__ import annotations

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]: the atan2(sin, cos) form of the reference."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two SE(2) poses a o b (apply b in a's frame). [..., 3]."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, th], dim=-1)


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst, both [N, D].

    Returns (s, R, t) with dst ~= s * R @ src + t (Umeyama 1991).
    """
    mu_s = src.mean(dim=0)
    mu_d = dst.mean(dim=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, S, Vt = torch.linalg.svd(cov)
    d = src.shape[-1]
    sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.ones(d, dtype=src.dtype, device=src.device)
    D[-1] = sign
    R = (U * D[None, :]) @ Vt
    if with_scale:
        var_s = torch.mean(torch.sum(xs * xs, dim=-1))
        s = torch.sum(S * D) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * R @ mu_s
    return s, R, t
