"""The rotation of closed-form 3-D/3-D registration: for cross-covariances
M [..., 3, 3] the proper rotation R maximizing tr(R^T M), i.e. the
Kabsch/Umeyama R = U diag(1, 1, sign(det U det V^T)) V^T of M = U S V^T.

`backend/graph.py::estimate_relative_pose_3d3d` (Horn's closed form, the
pose of a closure candidate's landmark matches) takes its rotation from
here. The reference computes it with `jnp.linalg.svd` and `det` inside its
jitted closure verification; on CUDA `torch.linalg.svd` and `det` check
convergence and pivots on the host, which no CUDA graph can hold. So
`rotation_fit` launches the hand-written kernel `csrc/horn.cu` (Horn's
quaternion form, a float64 Jacobi eigen-solve a matrix, nothing read back)
on CUDA tensors, and on CPU tensors runs `rotation_fit_reference`, the
SVD/det code, as its plain twin. The two agree where the optimum is
unique; where it is not (M of rank <= 1) each returns one of the optimal
rotations, both proper.
"""

from __future__ import annotations

import torch

from parakeet_slam_tpu_torch.kernels import _build


def rotation_fit_reference(cov: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3] from cov [..., 3, 3] through the SVD: the plain twin."""
    U, _, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.cat([torch.ones_like(U[..., 0, :2]), d[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vt


def rotation_fit(cov: torch.Tensor, sweeps: torch.Tensor | None = None) -> torch.Tensor:
    """R [..., 3, 3] from cov [..., 3, 3]: the kernel for a float32 CUDA
    tensor (launched on the current stream; a new contiguous tensor), the
    twin for a CPU tensor. `sweeps`, an int32 CUDA tensor of cov's batch
    size, receives each matrix's number of Jacobi sweeps (the kernel's
    work)."""
    if cov.shape[-2:] != (3, 3):
        raise ValueError(f"rotation_fit: cov {tuple(cov.shape)}, expected [..., 3, 3]")
    if cov.device.type == "cpu":
        return rotation_fit_reference(cov)
    if cov.device.type != "cuda" or cov.dtype != torch.float32:
        raise ValueError(f"rotation_fit: needs a float32 CUDA or a CPU tensor, got "
                         f"{cov.dtype} on {cov.device}")
    flat = cov.reshape(-1, 3, 3)
    B = flat.shape[0]
    if sweeps is not None and (sweeps.shape != (B,) or sweeps.dtype != torch.int32
                               or sweeps.device != cov.device or not sweeps.is_contiguous()):
        raise ValueError(f"rotation_fit: sweeps must be a contiguous int32 [{B}] on {cov.device}")
    R = torch.empty(B, 3, 3, dtype=torch.float32, device=cov.device)
    if B == 0:
        return R.reshape(cov.shape)
    err = _build.library().rotation_fit_launch(
        flat.data_ptr(), R.data_ptr(), 0 if sweeps is None else sweeps.data_ptr(), B,
        *flat.stride(), _build.stream_ptr(cov))
    _build.check(err, "rotation_fit")
    rotation_fit.launches += 1
    return R.reshape(cov.shape)


rotation_fit.launches = 0
