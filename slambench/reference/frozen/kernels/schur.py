"""Schur-complement block op: y = C^-1 u for N symmetric 3x3 landmark blocks
(port of `parakeet_slam_tpu/kernels/schur.py`).

The bundle-adjustment solver (`backend/ba.py`) runs an implicit-matvec PCG,
so its hot per-point op is the inverse-apply of every landmark block, once
per bucket and matvec. The inverse is the closed-form cofactor inverse of
the upper triangle, applied in one pass; C^-1 itself is never written. Where
|det| < eps the determinant is replaced by eps (the sign is dropped, as in
the reference).

`apply_cinv` launches the hand-written kernel `csrc/schur.cu` on CUDA
tensors; `apply_cinv_reference` is its plain twin, operation for operation;
`cinv_apply` is what the solver calls: the tensors' device alone picks the
kernel (CUDA) or the twin (CPU). No gradient: the solver is
Levenberg-Marquardt with closed-form Jacobians and never differentiates
through this op.
"""

from __future__ import annotations

import torch

from slambench.reference.frozen.kernels import _build


def apply_cinv_reference(C: torch.Tensor, u: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """y = C^-1 u for symmetric C [N, 3, 3] and u [N, 3]: the plain twin."""
    xx, xy, xz = C[:, 0, 0], C[:, 0, 1], C[:, 0, 2]
    yy, yz, zz = C[:, 1, 1], C[:, 1, 2], C[:, 2, 2]
    u0, u1, u2 = u[:, 0], u[:, 1], u[:, 2]
    A = yy * zz - yz * yz
    B = -(xy * zz - yz * xz)
    Cc = xy * yz - yy * xz
    E = xx * zz - xz * xz
    F = -(xx * yz - xy * xz)
    II = xx * yy - xy * xy
    det = xx * A + xy * B + xz * Cc
    det = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    y0 = (A * u0 + B * u1 + Cc * u2) / det
    y1 = (B * u0 + E * u1 + F * u2) / det
    y2 = (Cc * u0 + F * u1 + II * u2) / det
    return torch.stack([y0, y1, y2], dim=-1)


def _check_shapes(C, u):
    N = C.shape[0]
    if C.shape != (N, 3, 3) or u.shape != (N, 3):
        raise ValueError(f"apply_cinv: C {tuple(C.shape)} and u {tuple(u.shape)}, "
                         "expected [N, 3, 3] and [N, 3]")
    return N


def apply_cinv(C: torch.Tensor, u: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """y = C^-1 u on the card: float32 CUDA tensors C [N, 3, 3] (any
    strides; the upper triangle is read) and u [N, 3]. Returns a new
    contiguous [N, 3] tensor. Launches on the current stream."""
    N = _check_shapes(C, u)
    if C.device.type != "cuda" or u.device != C.device:
        raise ValueError(f"apply_cinv: needs CUDA tensors on one card, got {C.device}, {u.device}")
    if C.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"apply_cinv: needs float32, got {C.dtype}, {u.dtype}")
    y = torch.empty(N, 3, dtype=torch.float32, device=C.device)
    if N == 0:
        return y
    err = _build.library().apply_cinv_launch(
        C.data_ptr(), u.data_ptr(), y.data_ptr(), N, *C.stride(), *u.stride(), float(eps),
        _build.stream_ptr(C),
    )
    _build.check(err, "apply_cinv")
    apply_cinv.launches += 1
    return y


apply_cinv.launches = 0


def cinv_apply(C: torch.Tensor, u: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The solver's dispatch for y = C^-1 u: the kernel for CUDA tensors (or
    an error), the twin for CPU tensors."""
    if True:  # frozen reference: the plain twin on every device
        _check_shapes(C, u)
        return apply_cinv_reference(C, u, eps)
    return apply_cinv(C, u, eps)
