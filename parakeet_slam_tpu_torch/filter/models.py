"""Motion and measurement models of the 2-D filter path (port of the
`odometry_2d` and `range_bearing_2d` entries of
`parakeet_slam_tpu.filter.models`).

Unlike the JAX zoo, whose functions take one landmark and are vmapped, these
take tensors with any leading batch dims that broadcast against each other:
  h(pose [..., 3], lm [..., 2])        -> zhat [..., 2]
  jac(pose, lm)                        -> H [..., 2, 2]   d h / d lm
  residual(z, zhat)                    -> nu [..., 2]     bearing wrapped
  init(pose, z)                        -> (mean [..., 2], cov [..., 2, 2])
  in_fov(pose, lm)                     -> bool [...]
Random draws are explicit arguments: the caller draws them from its
`torch.Generator`, or a test hands in the numbers JAX drew.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.core.config import FilterConfig
from parakeet_slam_tpu_torch.core.geometry import wrap_angle


def sample_odometry_2d(pose, u, alphas, noise):
    """Odometry motion model: u = [dx, dy, dth] in the robot frame.

    Noise std scales with the motion magnitude, then the noisy increment is
    composed onto each particle pose. pose [..., 3], u [3], noise [..., 3]
    standard normals -> [..., 3].
    """
    trans = torch.linalg.vector_norm(u[:2])
    rot = u[2].abs()
    a1, a2, a3, a4 = alphas
    sig_trans = a1 * trans + a2 * rot + 1e-6
    sig_rot = a3 * rot + a4 * trans + 1e-6
    du = torch.stack(
        [
            u[0] + noise[..., 0] * sig_trans,
            u[1] + noise[..., 1] * sig_trans,
            u[2] + noise[..., 2] * sig_rot,
        ],
        dim=-1,
    )
    return geometry.se2_compose(pose, du)


MOTION_MODELS: dict[str, Callable] = {"odometry_2d": sample_odometry_2d}


def get_motion_model(name: str) -> Callable:
    if name in MOTION_MODELS:
        return MOTION_MODELS[name]
    raise NotImplementedError(
        f"motion model {name!r} is not ported yet (ROADMAP Queue 1, slice 2)"
    )


@dataclass(frozen=True)
class MeasurementModel:
    name: str
    obs_dim: int
    lm_dim: int
    h: Callable
    jac: Callable
    residual: Callable
    init: Callable
    in_fov: Callable


def _range_bearing_2d(cfg: FilterConfig) -> MeasurementModel:
    """z = [range, bearing] of a 2-D landmark from an SE(2) pose."""

    def h(pose, lm):
        d = lm - pose[..., :2]
        r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
        phi = wrap_angle(torch.atan2(d[..., 1], d[..., 0]) - pose[..., 2])
        return torch.stack([r, phi], dim=-1)

    def jac(pose, lm):
        d = lm - pose[..., :2]
        q = torch.sum(d * d, dim=-1) + 1e-12
        r = torch.sqrt(q)
        return torch.stack(
            [
                torch.stack([d[..., 0] / r, d[..., 1] / r], dim=-1),
                torch.stack([-d[..., 1] / q, d[..., 0] / q], dim=-1),
            ],
            dim=-2,
        )

    def residual(z, zhat):
        return torch.stack(
            [z[..., 0] - zhat[..., 0], wrap_angle(z[..., 1] - zhat[..., 1])], dim=-1
        )

    def init(pose, z):
        r, phi = z[..., 0], z[..., 1]
        ang = pose[..., 2] + phi
        mean = pose[..., :2] + r[..., None] * torch.stack(
            [torch.cos(ang), torch.sin(ang)], dim=-1
        )
        Hm = jac(pose, mean)
        det = Hm[..., 0, 0] * Hm[..., 1, 1] - Hm[..., 0, 1] * Hm[..., 1, 0]
        det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        Hinv = torch.stack(
            [
                torch.stack([Hm[..., 1, 1], -Hm[..., 0, 1]], dim=-1),
                torch.stack([-Hm[..., 1, 0], Hm[..., 0, 0]], dim=-1),
            ],
            dim=-2,
        ) / det_safe[..., None, None]
        R = torch.tensor(cfg.meas_noise[:2], dtype=mean.dtype, device=mean.device) ** 2
        cov = (Hinv * R) @ Hinv.transpose(-1, -2)  # Hinv diag(R) Hinv^T
        return mean, cfg.init_cov_inflation * cov

    def in_fov(pose, lm):
        zhat = h(pose, lm)
        return (zhat[..., 0] < cfg.max_range) & (zhat[..., 1].abs() < cfg.fov_half_angle)

    return MeasurementModel("range_bearing_2d", 2, 2, h, jac, residual, init, in_fov)


MEASUREMENT_MODELS: dict[str, Callable[[FilterConfig], MeasurementModel]] = {
    "range_bearing_2d": _range_bearing_2d,
}


def get_measurement_model(cfg: FilterConfig) -> MeasurementModel:
    name = cfg.measurement_model
    if name in MEASUREMENT_MODELS:
        return MEASUREMENT_MODELS[name](cfg)
    raise NotImplementedError(
        f"measurement model {name!r} is not ported yet (ROADMAP Queue 1, slice 2)"
    )
