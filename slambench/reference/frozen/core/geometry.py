"""SE(2)/SE(3) geometry, Lie maps and trajectory alignment (port of
`parakeet_slam_tpu.core.geometry`).

Every function takes tensors with any leading batch dims. Conventions as in
the JAX package:
- SE(2) poses are [x, y, theta];
- SE(3) poses are [tx, ty, tz, qx, qy, qz, qw] (Hamilton, unit quaternion);
- SE(3) twists are [v(3), omega(3)].
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


def se2_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map R^3 -> SE(2), xi = [vx, vy, omega] [..., 3]; the
    series 1 - w^2/6 and w/2 below |w| < 1e-6, as the reference."""
    v, w = xi[..., :2], xi[..., 2]
    small = w.abs() < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(w_safe) / w_safe)
    b = torch.where(small, w / 2.0, (1.0 - torch.cos(w_safe)) / w_safe)
    x = a * v[..., 0] - b * v[..., 1]
    y = b * v[..., 0] + a * v[..., 1]
    return torch.stack([x, y, wrap_angle(w)], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (Hamilton, [x, y, z, w])
# ---------------------------------------------------------------------------


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    # a negation, not a product with a tensor built from a list: on CUDA that
    # tensor is a synchronous host-to-device copy on every call
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors [..., 3] by unit quaternions [..., 4]."""
    u, w = q[..., :3], q[..., 3:4]
    u, v = torch.broadcast_tensors(u, v)
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (branch-free:
    the four Shepperd candidates, the largest pivot picked by argmax)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cw = torch.stack([m21 - m12, m02 - m20, m10 - m01, qw2], dim=-1)
    cx = torch.stack([qx2, m10 + m01, m02 + m20, m21 - m12], dim=-1)
    cy = torch.stack([m10 + m01, qy2, m21 + m12, m02 - m20], dim=-1)
    cz = torch.stack([m02 + m20, m21 + m12, qz2, m10 - m01], dim=-1)
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # [..., 4 candidates, 4]
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3) / SE(3)
# ---------------------------------------------------------------------------


def _safe_norm(w: torch.Tensor) -> torch.Tensor:
    """norm(w) with a finite derivative at w = 0."""
    return torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)


def so3_exp_quat(w: torch.Tensor) -> torch.Tensor:
    """so(3) tangent [..., 3] -> unit quaternion."""
    theta = _safe_norm(w)[..., None]
    small = theta < 1e-8
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    half = theta / 2.0
    k = torch.where(small, 0.5 - theta * theta / 48.0, torch.sin(half) / theta_safe)
    return torch.cat([k * w, torch.cos(half)], dim=-1)


def so3_log_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> so(3) tangent [..., 3]."""
    qn = torch.where(q[..., 3:4] < 0, -q, q)  # shortest arc
    u, w = qn[..., :3], qn[..., 3]
    norm_u = _safe_norm(u)
    theta = 2.0 * torch.atan2(norm_u, w)
    small = norm_u < 1e-8
    scale = torch.where(
        small,
        2.0 / torch.clamp(w, min=1e-8),
        theta / torch.where(small, torch.ones_like(norm_u), norm_u),
    )
    return scale[..., None] * u


def hat3(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> skew-symmetric [..., 3, 3]."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            zeros, -w[..., 2], w[..., 1],
            w[..., 2], zeros, -w[..., 0],
            -w[..., 1], w[..., 0], zeros,
        ],
        dim=-1,
    ).reshape(*w.shape[:-1], 3, 3)


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _se3_V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3), V(w) such that t = V @ v for exp."""
    theta = _safe_norm(w)
    small = theta < 1e-6
    th = torch.where(small, torch.ones_like(theta), theta)
    t2, th2 = theta * theta, th * th
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / th2)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (1.0 - A) / th2)
    W = hat3(w)
    return _eye3_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _se3_V_inv(w: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(w)
    small = theta < 1e-6
    th = torch.where(small, torch.ones_like(theta), theta)
    half = th / 2.0
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta * theta / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / (th * th),
    )
    W = hat3(w)
    return _eye3_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [..., 6] (v, w) -> pose [..., 7] (t, quat)."""
    v, w = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(w)
    t = (_se3_V(w) @ v[..., None])[..., 0]
    return torch.cat([t, q], dim=-1)


def se3_log(p: torch.Tensor) -> torch.Tensor:
    """Pose [..., 7] -> twist [..., 6]."""
    t, q = p[..., :3], p[..., 3:]
    w = so3_log_quat(q)
    v = (_se3_V_inv(w) @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a o b for poses [..., 7]."""
    ta, qa = a[..., :3], a[..., 3:]
    tb, qb = b[..., :3], b[..., 3:]
    t = ta + quat_rotate(qa, tb)
    q = quat_normalize(quat_multiply(qa, qb))
    return torch.cat([t, q], dim=-1)


def se3_inverse(a: torch.Tensor) -> torch.Tensor:
    t, q = a[..., :3], a[..., 3:]
    qi = quat_conjugate(q)
    return torch.cat([-quat_rotate(qi, t), qi], dim=-1)


def se3_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return se3_compose(se3_inverse(a), b)


def se3_apply(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """World-from-local point transform, pts [..., 3]."""
    return pose[..., :3] + quat_rotate(pose[..., 3:], pts)


def se3_apply_inverse(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(pose[..., 3:]), pts - pose[..., :3])


def se2_to_se3(p: torch.Tensor) -> torch.Tensor:
    """Lift planar poses [..., 3] to SE(3) [..., 7] (z=0, yaw-only)."""
    half = p[..., 2] / 2.0
    zeros = torch.zeros_like(half)
    q = torch.stack([zeros, zeros, torch.sin(half), torch.cos(half)], dim=-1)
    t = torch.stack([p[..., 0], p[..., 1], zeros], dim=-1)
    return torch.cat([t, q], dim=-1)


# ---------------------------------------------------------------------------
# Trajectory alignment
# ---------------------------------------------------------------------------


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
