"""Closed-form small-matrix linear algebra, batched over leading dims
(port of `parakeet_slam_tpu.core.linalg`, same eps clamps)."""

from __future__ import annotations

import math

import torch


def det2(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 2, 2]."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def inv2(m: torch.Tensor, eps: float = 1e-12):
    """Inverse + determinant of [..., 2, 2]. Returns (inv, det)."""
    d = det2(m)
    d_safe = torch.where(d.abs() < eps, torch.full_like(d, eps), d)
    inv = torch.stack(
        [m[..., 1, 1], -m[..., 0, 1], -m[..., 1, 0], m[..., 0, 0]], dim=-1
    ).reshape(*m.shape[:-2], 2, 2) / d_safe[..., None, None]
    return inv, d


def det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3]."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def inv3(m: torch.Tensor, eps: float = 1e-12):
    """Inverse + determinant of [..., 3, 3] via cofactors. Returns (inv, det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    II = a * e - b * d
    det = a * A + b * B + c * C
    det_safe = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    inv = torch.stack([A, D, G, B, E, H, C, F, II], dim=-1).reshape(
        *m.shape[:-2], 3, 3
    ) / det_safe[..., None, None]
    return inv, det


def inv_psd(m: torch.Tensor, eps: float = 1e-12):
    """Closed-form inverse + det for [..., D, D] with D in {1, 2, 3}."""
    D = m.shape[-1]
    if D == 1:
        d = m[..., 0, 0]
        d_safe = torch.where(d.abs() < eps, torch.full_like(d, eps), d)
        return (1.0 / d_safe)[..., None, None], d
    if D == 2:
        return inv2(m, eps)
    if D == 3:
        return inv3(m, eps)
    raise ValueError(f"inv_psd supports D <= 3, got {D}")


def mahalanobis_and_logdet(q: torch.Tensor, nu: torch.Tensor, eps: float = 1e-12):
    """(nu^T Q^-1 nu clamped >= 0, log|Q|, Q^-1) for small PSD Q.

    The clamp keeps an indefinite (fp-drifted) Q from turning a negative
    "distance" into a huge positive log-likelihood that wins association.
    """
    inv, det = inv_psd(q, eps)
    maha = torch.einsum("...i,...ij,...j->...", nu, inv, nu)
    maha = torch.clamp(maha, min=0.0)
    logdet = torch.log(torch.clamp(det, min=eps))
    return maha, logdet, inv


def gaussian_loglik(q: torch.Tensor, nu: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """log N(nu; 0, Q) for small Q. [..., D, D], [..., D] -> [...]."""
    D = q.shape[-1]
    maha, logdet, _ = mahalanobis_and_logdet(q, nu, eps)
    return -0.5 * (maha + logdet + D * math.log(2.0 * math.pi))
