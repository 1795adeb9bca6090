"""Motion and measurement models (port of `parakeet_slam_tpu.filter.models`:
odometry_2d, se3_odometry, range_bearing_2d, pinhole_3d, stereo_3d,
equirect_3d).

Unlike the JAX zoo, whose functions take one landmark and are vmapped, these
take tensors with any leading batch dims that broadcast against each other:
  h(pose [..., pd], lm [..., Dl])      -> zhat [..., Dz]
  jac(pose, lm)                        -> H [..., Dz, Dl]   d h / d lm
  residual(z, zhat)                    -> nu [..., Dz]      wrap-aware
  init(pose, z)                        -> (mean [..., Dl], cov [..., Dl, Dl])
  in_fov(pose, lm)                     -> bool [...]
  pose_jac(pose, lm)                   -> Hx [..., Dz, dt]  d h(pose (+) d) / d d at 0
`pose_jac` is the closed form of what the reference's FastSLAM 2.0 takes
from `jax.jacfwd` through the retraction (additive for SE(2), the right
perturbation pose o exp(d) for SE(3)), clamps included.
Random draws are explicit arguments: the caller draws them from its
`torch.Generator`, or a test hands in the numbers JAX drew.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu_torch.core.geometry import wrap_angle

# Minimum camera-frame depth of the projective models: keeps H ~ fx/z and
# det(Q) in float32 range for landmarks behind or beside the camera.
MIN_DEPTH = 0.1

# ---------------------------------------------------------------------------
# Motion models (sampled)
# ---------------------------------------------------------------------------


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


def sample_se3_odometry(pose, u, sigmas, noise):
    """SE(3) odometry: u = twist [6], sigmas = (sig_trans, sig_rot),
    noise [..., 6] standard normals. pose [..., 7] -> [..., 7]."""
    s_t, s_r = float(sigmas[0]), float(sigmas[1])
    scale = torch.tensor([s_t] * 3 + [s_r] * 3, dtype=pose.dtype, device=pose.device)
    return geometry.se3_compose(pose, geometry.se3_exp(u + noise * scale))


# name -> (sampler, dimension of its standard-normal draw)
MOTION_MODELS: dict[str, tuple[Callable, int]] = {
    "odometry_2d": (sample_odometry_2d, 3),
    "se3_odometry": (sample_se3_odometry, 6),
}


def get_motion_model(name: str) -> Callable:
    return _lookup(MOTION_MODELS, name, "motion model")[0]


def motion_noise_dim(name: str) -> int:
    return _lookup(MOTION_MODELS, name, "motion model")[1]


def _lookup(table, name, what):
    if name in table:
        return table[name]
    raise NotImplementedError(f"{what} {name!r} is not ported yet (ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# Gaussian motion models (mean + tangent covariance) for FastSLAM 2.0. Each
# returns the motion mean [P, pd] and the noise covariance [P, dt, dt] in the
# pose's tangent: additive [dx, dy, dth] for SE(2), the right-perturbation
# se(3) twist for SE(3) (pose' = pose o exp(delta)).
# ---------------------------------------------------------------------------


def se2_retract(pose, delta):
    """Additive SE(2) tangent retraction: pose [..., 3] (+) delta [..., 3]."""
    out = pose + delta
    return torch.cat([out[..., :2], wrap_angle(out[..., 2:3])], dim=-1)


def se3_retract(pose, delta):
    """Right-perturbation SE(3) retraction: pose [..., 7] o exp(delta [..., 6])."""
    return geometry.se3_compose(pose, geometry.se3_exp(delta))


def _odometry_2d_mean_cov(pose, u, alphas):
    trans = torch.linalg.vector_norm(u[:2])
    rot = u[2].abs()
    a1, a2, a3, a4 = alphas
    sig_trans = a1 * trans + a2 * rot + 1e-6
    sig_rot = a3 * rot + a4 * trans + 1e-6
    mean = geometry.se2_compose(pose, u)
    cov = torch.diag(torch.stack([sig_trans**2, sig_trans**2, sig_rot**2]).to(pose.dtype))
    return mean, cov.expand(*pose.shape[:-1], 3, 3)


def _se3_odometry_mean_cov(pose, u, sigmas):
    """Mean pose o exp(u) and J M J^T, J the right Jacobian of exp at u, as
    `torch.func.jacfwd` of log(mean^-1 o pose o exp(u + eps)) at eps = 0.
    Every particle's output depends on the shared eps alone, so one jacfwd
    over the 6-vector gives all P Jacobians [P, 6, 6]."""
    s_t, s_r = float(sigmas[0]), float(sigmas[1])
    mean = geometry.se3_compose(pose, geometry.se3_exp(u))

    def f(eps):
        # expanded to [P, 6]: forward-mode AD under torch.func has promoted
        # 0-dim (unbatched) float32 + Python-float tangents to float64
        xi = (u + eps).expand(*pose.shape[:-1], 6)
        p = geometry.se3_compose(pose, geometry.se3_exp(xi))
        return geometry.se3_log(geometry.se3_between(mean, p))

    J = torch.func.jacfwd(f)(torch.zeros(6, dtype=pose.dtype, device=pose.device))
    M = torch.tensor([s_t**2] * 3 + [s_r**2] * 3, dtype=pose.dtype, device=pose.device)
    eye = torch.eye(6, dtype=pose.dtype, device=pose.device)
    return mean, (J * M) @ J.transpose(-1, -2) + 1e-10 * eye


# name -> (mean_cov(pose [P, pd], u, noise) -> (mean [P, pd], cov [P, dt, dt]),
#          retract(pose, delta), tangent_dim)
MOTION_MEAN_COV: dict[str, tuple[Callable, Callable, int]] = {
    "odometry_2d": (_odometry_2d_mean_cov, se2_retract, 3),
    "se3_odometry": (_se3_odometry_mean_cov, se3_retract, 6),
}


def get_motion_mean_cov(name: str) -> tuple[Callable, Callable, int]:
    return _lookup(MOTION_MEAN_COV, name, "motion model")


# ---------------------------------------------------------------------------
# Measurement models
# ---------------------------------------------------------------------------


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
    pose_jac: Callable


def _se3_pose_jac(dh_dp):
    """Hx of a camera model from dh/dp_cam [..., Dz, 3]: at d = 0 the right
    perturbation moves the camera point by dp = -dv + p x dw."""

    def pose_jac(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        Hp = dh_dp(p)
        return torch.cat([-Hp, Hp @ geometry._so3_hat(p)], dim=-1)

    return pose_jac


def _range_bearing_2d(cfg: FilterConfig, fe: FrontendConfig) -> MeasurementModel:
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

    def pose_jac(pose, lm):  # d h / d pose = [-d h / d lm | (0, -1)]
        J = -jac(pose, lm)
        col = torch.zeros_like(J[..., :1])
        col[..., 1, 0] = -1.0
        return torch.cat([J, col], dim=-1)

    return MeasurementModel("range_bearing_2d", 2, 2, h, jac, residual, init, in_fov, pose_jac)


def _row_stack(rows):
    """[[a, b, c], ...] of equal-shape tensors -> [..., len(rows), 3]."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _ray_cov(cfg, ray_w, sig_t):
    """init_infl * (sig_r^2 ray ray^T + sig_t^2 (I - ray ray^T))."""
    along = ray_w[..., :, None] * ray_w[..., None, :]
    eye = torch.eye(3, dtype=ray_w.dtype, device=ray_w.device)
    cov = cfg.init_range_sigma**2 * along + sig_t**2 * (eye - along)
    return cfg.init_cov_inflation * cov


def _pinhole_3d(cfg: FilterConfig, fe: FrontendConfig) -> MeasurementModel:
    """z = [u, v] pixel projection of a 3-D landmark from an SE(3) pose
    (camera in world, [t, q]). Monocular init puts the landmark at the prior
    range along the viewing ray (depth is unobservable)."""
    fx, fy, cx, cy = fe.intrinsics[:4]

    def h(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        z = torch.clamp(p[..., 2], min=MIN_DEPTH)
        return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1)

    def jac(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        z = torch.clamp(p[..., 2], min=MIN_DEPTH)
        zero = torch.zeros_like(z)
        duv_dp = _row_stack([
            [fx / z, zero, -fx * p[..., 0] / (z * z)],
            [zero, fy / z, -fy * p[..., 1] / (z * z)],
        ])
        R_wc = geometry.quat_to_matrix(pose[..., 3:])  # dp_cam / dlm = R_wc^T
        return duv_dp @ R_wc.transpose(-1, -2)

    def residual(z, zhat):
        return z - zhat

    def init(pose, z):
        u, v = z[..., 0], z[..., 1]
        ray_c = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
        ray_c = ray_c / torch.linalg.vector_norm(ray_c, dim=-1, keepdim=True)
        r0 = cfg.init_range_prior
        mean = geometry.se3_apply(pose, r0 * ray_c)
        ray_w = (geometry.quat_to_matrix(pose[..., 3:]) @ ray_c[..., None])[..., 0]
        return mean, _ray_cov(cfg, ray_w, r0 * cfg.meas_noise[0] / fx)

    def in_fov(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        uv = h(pose, lm)
        H, W = fe.image_size
        return (
            (p[..., 2] > 0.05) & (p[..., 2] < cfg.max_range)
            & (uv[..., 0] >= 0) & (uv[..., 0] < W) & (uv[..., 1] >= 0) & (uv[..., 1] < H)
        )

    def dh_dp(p):
        z = torch.clamp(p[..., 2], min=MIN_DEPTH)
        live = (p[..., 2] > MIN_DEPTH).to(p.dtype)  # the clamp's derivative
        zero = torch.zeros_like(z)
        return _row_stack([
            [fx / z, zero, -fx * p[..., 0] / (z * z) * live],
            [zero, fy / z, -fy * p[..., 1] / (z * z) * live],
        ])

    return MeasurementModel("pinhole_3d", 2, 3, h, jac, residual, init, in_fov,
                            _se3_pose_jac(dh_dp))


def _stereo_3d(cfg: FilterConfig, fe: FrontendConfig) -> MeasurementModel:
    """z = [u_left, v, disparity], disparity = fx * b / depth. Depth is
    observable, so init is a triangulation."""
    fx, fy, cx, cy = fe.intrinsics[:4]
    b = fe.baseline

    def h(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        z = torch.clamp(p[..., 2], min=MIN_DEPTH)
        return torch.stack(
            [fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy, fx * b / z], dim=-1
        )

    def jac(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        z = torch.clamp(p[..., 2], min=MIN_DEPTH)
        zero = torch.zeros_like(z)
        dz_dp = _row_stack([
            [fx / z, zero, -fx * p[..., 0] / (z * z)],
            [zero, fy / z, -fy * p[..., 1] / (z * z)],
            [zero, zero, -fx * b / (z * z)],
        ])
        R_wc = geometry.quat_to_matrix(pose[..., 3:])
        return dz_dp @ R_wc.transpose(-1, -2)

    def residual(z, zhat):
        return z - zhat

    def init(pose, z):
        u, v, d = z[..., 0], z[..., 1], z[..., 2]
        depth = fx * b / torch.clamp(d, min=1e-3)
        p_c = torch.stack([(u - cx) / fx * depth, (v - cy) / fy * depth, depth], dim=-1)
        mean = geometry.se3_apply(pose, p_c)
        Hm = jac(pose, mean)
        Hinv = torch.linalg.inv(Hm + 1e-9 * torch.eye(3, dtype=Hm.dtype, device=Hm.device))
        R = torch.tensor(cfg.meas_noise[:3], dtype=mean.dtype, device=mean.device) ** 2
        return mean, cfg.init_cov_inflation * ((Hinv * R) @ Hinv.transpose(-1, -2))

    def in_fov(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        uvd = h(pose, lm)
        H, W = fe.image_size
        return (
            (p[..., 2] > 0.05) & (p[..., 2] < cfg.max_range)
            & (uvd[..., 0] >= 0) & (uvd[..., 0] < W) & (uvd[..., 1] >= 0) & (uvd[..., 1] < H)
        )

    def dh_dp(p):
        z = torch.clamp(p[..., 2], min=MIN_DEPTH)
        live = (p[..., 2] > MIN_DEPTH).to(p.dtype)
        zero = torch.zeros_like(z)
        return _row_stack([
            [fx / z, zero, -fx * p[..., 0] / (z * z) * live],
            [zero, fy / z, -fy * p[..., 1] / (z * z) * live],
            [zero, zero, -fx * b / (z * z) * live],
        ])

    return MeasurementModel("stereo_3d", 3, 3, h, jac, residual, init, in_fov,
                            _se3_pose_jac(dh_dp))


def _equirect_3d(cfg: FilterConfig, fe: FrontendConfig) -> MeasurementModel:
    """Equirectangular panoramic camera: z = [u, v], with the azimuth
    wrap-around on u."""
    H_img, W_img = fe.image_size

    def h(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        r = torch.linalg.vector_norm(p, dim=-1) + 1e-9
        az = torch.atan2(p[..., 1], p[..., 0])
        el = torch.asin(torch.clamp(p[..., 2] / r, -1.0, 1.0))
        u = (az + math.pi) / (2 * math.pi) * W_img
        v = (math.pi / 2 - el) / math.pi * H_img
        return torch.stack([u, v], dim=-1)

    def jac(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        rho2 = x * x + y * y + 1e-9
        r2 = rho2 + z * z
        rho = torch.sqrt(rho2)
        ku = W_img / (2 * math.pi)
        kv = H_img / math.pi
        du_dp = ku * torch.stack([-y / rho2, x / rho2, torch.zeros_like(x)], dim=-1)
        dv_dp = -kv * torch.stack([-x * z, -y * z, rho2], dim=-1) / (r2 * rho)[..., None]
        R_wc = geometry.quat_to_matrix(pose[..., 3:])
        return torch.stack([du_dp, dv_dp], dim=-2) @ R_wc.transpose(-1, -2)

    def residual(z, zhat):
        du = z[..., 0] - zhat[..., 0]
        du = du - W_img * torch.round(du / W_img)  # to (-W/2, W/2], half to even
        return torch.stack([du, z[..., 1] - zhat[..., 1]], dim=-1)

    def init(pose, z):
        u, v = z[..., 0], z[..., 1]
        az = u / W_img * 2 * math.pi - math.pi
        el = math.pi / 2 - v / H_img * math.pi
        ray_c = torch.stack(
            [torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az), torch.sin(el)],
            dim=-1,
        )
        r0 = cfg.init_range_prior
        mean = geometry.se3_apply(pose, r0 * ray_c)
        ray_w = (geometry.quat_to_matrix(pose[..., 3:]) @ ray_c[..., None])[..., 0]
        return mean, _ray_cov(cfg, ray_w, r0 * (2 * math.pi / W_img) * cfg.meas_noise[0])

    def in_fov(pose, lm):
        p = geometry.se3_apply_inverse(pose, lm)
        return torch.linalg.vector_norm(p, dim=-1) < cfg.max_range

    def dh_dp(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        n = torch.linalg.vector_norm(p, dim=-1)
        r = n + 1e-9
        s = z / r
        live = ((s > -1.0) & (s < 1.0)).to(p.dtype)  # the clamp's derivative
        # d asin(z / r) / dp, r = |p| + 1e-9
        k = live / (r * r * torch.sqrt(1.0 - s * s))
        de = [-z * x / n * k, -z * y / n * k, (r - z * z / n) * k]
        rho2 = x * x + y * y
        ku, kv = W_img / (2 * math.pi), H_img / math.pi
        return _row_stack([
            [-ku * y / rho2, ku * x / rho2, torch.zeros_like(x)],
            [-kv * de[0], -kv * de[1], -kv * de[2]],
        ])

    return MeasurementModel("equirect_3d", 2, 3, h, jac, residual, init, in_fov,
                            _se3_pose_jac(dh_dp))


MEASUREMENT_MODELS: dict[str, Callable[[FilterConfig, FrontendConfig], MeasurementModel]] = {
    "range_bearing_2d": _range_bearing_2d,
    "pinhole_3d": _pinhole_3d,
    "stereo_3d": _stereo_3d,
    "equirect_3d": _equirect_3d,
}
VISION_MODELS = ("pinhole_3d", "stereo_3d", "equirect_3d")


def get_measurement_model(
    cfg: FilterConfig, fe: FrontendConfig | None = None
) -> MeasurementModel:
    factory = _lookup(MEASUREMENT_MODELS, cfg.measurement_model, "measurement model")
    return factory(cfg, fe or FrontendConfig())
