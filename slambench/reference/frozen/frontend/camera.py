"""Camera models: pinhole, stereo, equirectangular (port of
`parakeet_slam_tpu.frontend.camera`).

Batched project / unproject over any leading dims, shared by the frontend,
the loop-closure refinement and the pose-graph backend. Points are in the
CAMERA frame; world <-> camera transforms live in `core/geometry`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Pinhole:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def project(self, p: torch.Tensor) -> torch.Tensor:
        """[..., 3] camera-frame points -> [..., 2] pixels."""
        z = torch.clamp(p[..., 2], min=1e-3)
        u = self.fx * p[..., 0] / z + self.cx
        v = self.fy * p[..., 1] / z + self.cy
        return torch.stack([u, v], dim=-1)

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """[..., 2] pixels + [...] depths -> [..., 3] camera-frame points."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)

    def in_image(self, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        return (
            (uv[..., 0] >= margin) & (uv[..., 0] < self.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < self.height - margin)
        )

    def jac_project(self, p: torch.Tensor) -> torch.Tensor:
        """d project / d p_cam, [..., 2, 3]."""
        z = torch.clamp(p[..., 2], min=1e-3)
        zero = torch.zeros_like(z)
        row_u = torch.stack([self.fx / z, zero, -self.fx * p[..., 0] / (z * z)], dim=-1)
        row_v = torch.stack([zero, self.fy / z, -self.fy * p[..., 1] / (z * z)], dim=-1)
        return torch.stack([row_u, row_v], dim=-2)


@dataclass(frozen=True)
class Stereo:
    """Rectified stereo: z = (u_left, v, disparity)."""

    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    width: int
    height: int

    def project(self, p: torch.Tensor) -> torch.Tensor:
        z = torch.clamp(p[..., 2], min=1e-3)
        u = self.fx * p[..., 0] / z + self.cx
        v = self.fy * p[..., 1] / z + self.cy
        d = self.fx * self.baseline / z
        return torch.stack([u, v, d], dim=-1)

    def unproject(self, uvd: torch.Tensor) -> torch.Tensor:
        depth = self.fx * self.baseline / torch.clamp(uvd[..., 2], min=1e-3)
        x = (uvd[..., 0] - self.cx) / self.fx * depth
        y = (uvd[..., 1] - self.cy) / self.fy * depth
        return torch.stack([x, y, depth], dim=-1)

    def in_image(self, uvd: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        return (
            (uvd[..., 0] >= margin) & (uvd[..., 0] < self.width - margin)
            & (uvd[..., 1] >= margin) & (uvd[..., 1] < self.height - margin)
            & (uvd[..., 2] > 0)
        )

    def jac_project(self, p: torch.Tensor) -> torch.Tensor:
        """d project / d p_cam, [..., 3, 3]."""
        z = torch.clamp(p[..., 2], min=1e-3)
        iz = 1.0 / z
        iz2 = iz * iz
        zero = torch.zeros_like(z)
        row_u = torch.stack([self.fx * iz, zero, -self.fx * p[..., 0] * iz2], dim=-1)
        row_v = torch.stack([zero, self.fy * iz, -self.fy * p[..., 1] * iz2], dim=-1)
        row_d = torch.stack([zero, zero, -self.fx * self.baseline * iz2], dim=-1)
        return torch.stack([row_u, row_v, row_d], dim=-2)


@dataclass(frozen=True)
class Equirect:
    """Equirectangular panoramic camera; u wraps in azimuth."""

    width: int
    height: int

    def project(self, p: torch.Tensor) -> torch.Tensor:
        r = torch.linalg.vector_norm(p, dim=-1) + 1e-9
        az = torch.atan2(p[..., 1], p[..., 0])
        el = torch.asin(torch.clamp(p[..., 2] / r, -1.0, 1.0))
        u = (az + math.pi) / (2 * math.pi) * self.width
        v = (math.pi / 2 - el) / math.pi * self.height
        return torch.stack([u, v], dim=-1)

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        az = uv[..., 0] / self.width * 2 * math.pi - math.pi
        el = math.pi / 2 - uv[..., 1] / self.height * math.pi
        ray = torch.stack(
            [torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az), torch.sin(el)],
            dim=-1,
        )
        return ray * depth[..., None]

    def residual(self, uv_obs: torch.Tensor, uv_pred: torch.Tensor) -> torch.Tensor:
        """Pixel residual with azimuth wrap-around on u."""
        du = uv_obs[..., 0] - uv_pred[..., 0]
        du = du - self.width * torch.round(du / self.width)
        return torch.stack([du, uv_obs[..., 1] - uv_pred[..., 1]], dim=-1)

    def in_image(self, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        return (uv[..., 1] >= margin) & (uv[..., 1] < self.height - margin)

    def jac_project(self, p: torch.Tensor) -> torch.Tensor:
        """d project / d p_cam, [..., 2, 3] (the u-wrap is measure-zero)."""
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        rho2 = x * x + y * y + 1e-9
        r2 = rho2 + z * z
        rho = torch.sqrt(rho2)
        ku = self.width / (2.0 * math.pi)
        kv = self.height / math.pi
        zero = torch.zeros_like(x)
        row_u = torch.stack([-ku * y / rho2, ku * x / rho2, zero], dim=-1)
        s = kv / (r2 * rho)
        row_v = torch.stack([x * z * s, y * z * s, -rho2 * s], dim=-1)
        return torch.stack([row_u, row_v], dim=-2)


def from_config(fe_cfg):
    """Build the camera model named in a FrontendConfig."""
    H, W = fe_cfg.image_size
    if fe_cfg.camera == "pinhole":
        fx, fy, cx, cy = fe_cfg.intrinsics[:4]
        return Pinhole(fx, fy, cx, cy, W, H)
    if fe_cfg.camera == "stereo":
        fx, fy, cx, cy = fe_cfg.intrinsics[:4]
        return Stereo(fx, fy, cx, cy, fe_cfg.baseline, W, H)
    if fe_cfg.camera == "equirect":
        return Equirect(W, H)
    raise KeyError(f"unknown camera {fe_cfg.camera!r}")
