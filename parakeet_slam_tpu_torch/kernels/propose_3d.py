"""Fused FastSLAM 2.0 proposal for the SE(3) vision models (stereo_3d,
pinhole_3d): the refinement of every particle's pose Gaussian by the
frame's matched observations, in observation order.

`propose_3d` takes the motion model's mean pose [P, 7] and tangent
covariance [P, 6, 6], the frame's hoisted association (`score_3d`'s best
lane and its log-likelihood [P, Z]) and the pre-frame map, and returns the
refined pose, its covariance and the log-weights. On CUDA tensors it
launches the hand-written kernel of `csrc/propose_3d.cu` (a thread walks
one particle's Z observations); on CPU tensors it runs the plain twin
`propose_3d_reference`, which is `refine` (the loop that FastSLAM 2.0 runs
in every configuration the kernel does not take: sequential association,
the 2-D models, equirect_3d) with the association read from the scores.

The kernel computes what the loop computes on the card, bit for bit, so it
follows the order in which torch's CUDA kernels round (`csrc/propose_3d.cu`
lists the rules). `eval/propose_check.py` holds each rule against the
loop's own intermediates and the kernel against the loop, on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from parakeet_slam_tpu_torch.core import linalg
from parakeet_slam_tpu_torch.kernels import _build

# model -> (kernel id, Dz)
MODELS = {"pinhole_3d": (0, 2), "stereo_3d": (1, 3)}


def refine(measurement, retract, pose, P_cov, log_w, lm_mean, lm_cov, lm_count, any_valid,
           z, valid, R, associate, *, log_p0, unmatched_w, weight_min_count):
    """The proposal's refinement: for each observation i in order,
    `associate(pose, i)` gives (best lane [P] int64, its log-likelihood
    [P]); where it matches a landmark the pose Gaussian (`pose` [P, pd],
    `P_cov` [P, dt, dt]) takes the EKF update, and the log-weight the
    observation's likelihood. Returns (pose, P_cov, log_w)."""
    P, dt = pose.shape[0], P_cov.shape[-1]
    dev, dtype = pose.device, pose.dtype
    rows = torch.arange(P, device=dev)
    eye_t = torch.eye(dt, dtype=dtype, device=dev)
    for i in range(z.shape[0]):
        best, best_ll = associate(pose, i)
        v = valid[i]
        matched = v & any_valid & (best_ll >= log_p0)
        mu, cv = lm_mean[rows, best], lm_cov[rows, best]
        if weight_min_count > 0:
            matched = matched & (lm_count[rows, best] >= weight_min_count)

        zhat = measurement.h(pose, mu)
        Hm = measurement.jac(pose, mu)
        Hx = measurement.pose_jac(pose, mu)
        nu = measurement.residual(z[i], zhat)
        Q = Hm @ cv @ Hm.transpose(-1, -2) + R
        S = Hx @ P_cov @ Hx.transpose(-1, -2) + Q
        Sinv, _ = linalg.inv_psd(S)
        K = P_cov @ Hx.transpose(-1, -2) @ Sinv
        delta = (K @ nu[..., None])[..., 0]
        # Joseph form: PSD by construction, where (I - KH) P can go
        # indefinite in float32 and NaN the sampling Cholesky.
        IKH = eye_t - K @ Hx
        P_new = IKH @ P_cov @ IKH.transpose(-1, -2) + K @ Q @ K.transpose(-1, -2)
        P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
        # One degenerate landmark must not poison the particle: skip the
        # observation when the step or the likelihood is not finite.
        ll_s = linalg.gaussian_loglik(S, nu)
        ok = (
            torch.isfinite(delta).all(dim=-1)
            & torch.isfinite(P_new).all(dim=-1).all(dim=-1)
            & torch.isfinite(ll_s)
            & (torch.linalg.vector_norm(delta, dim=-1) < 1.0)
        )
        matched = matched & ok
        pose = torch.where(matched[:, None], retract(pose, delta), pose)
        P_cov = torch.where(matched[:, None, None], P_new, P_cov)
        log_w = log_w + torch.where(
            matched, ll_s,
            torch.where(v, torch.full_like(ll_s, unmatched_w), torch.zeros_like(ll_s)),
        )
    return pose, P_cov, log_w


@functools.cache
def _r_matrix(r_var: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """diag(r_var) on `device`: one host-to-device copy at its first use, as
    `FastSLAM._r_matrix` holds R, so that a captured step reads no host data."""
    return torch.diag(torch.tensor(r_var, dtype=dtype, device=device))


def propose_3d_reference(pose, P_cov, log_w, best, best_ll, lm_mean, lm_cov, lm_count,
                         any_valid, z, valid, *, measurement, retract, r_var, log_p0,
                         unmatched_w, weight_min_count):
    """Plain PyTorch twin of the kernel: `refine` with the association read
    from the hoisted scores (`best` [P, Z], `best_ll` [P, Z])."""
    R = _r_matrix(tuple(r_var), pose.dtype, pose.device)
    return refine(measurement, retract, pose, P_cov, log_w, lm_mean, lm_cov, lm_count,
                  any_valid, z, valid, R, lambda _, i: (best[:, i].long(), best_ll[:, i]),
                  log_p0=log_p0, unmatched_w=unmatched_w, weight_min_count=weight_min_count)


def constants(model, camera, r_var, log_p0, unmatched_w):
    """The kernel's float32 constants as torch casts the loop's Python
    numbers: fx, fy, cx, cy, fx * b (a double product, then float32),
    R's diagonal, log_p0, the unmatched weight and D * log(2 pi) (a double
    product, then float32)."""
    f = lambda x: float(np.float32(x))  # noqa: E731
    fx, fy, cx, cy, b = (float(x) for x in camera)
    Dz = MODELS[model][1]
    r = [f(x) for x in r_var] + [0.0] * (3 - Dz)
    return _build.float_array([f(fx), f(fy), f(cx), f(cy), f(fx * b), *r, f(log_p0),
                               f(unmatched_w), f(Dz * math.log(2.0 * math.pi))])


_ORDERS: dict = {}


def orders(P: int, Dz: int, device) -> torch.Tensor:
    """The orders word [1] int32 on `device`: for each product of the loop
    with a vector side (K nu, the retraction's V v, the einsum's two), the
    order in which cuBLAS adds its terms at this batch count, two bits a
    product (the kernel's `kOrder*`; bit 16 where no order matched). Made once per
    (device, P, Dz) from torch's own products on random operands of the
    loop's shapes and strides, entirely on the device: nothing is read
    back, so a CUDA graph captured later replays the kernel with it."""
    key = (torch.device(device), int(P), int(Dz))
    if key not in _ORDERS:
        g = torch.Generator(device=device).manual_seed(0)
        r = lambda *shape: torch.randn(*shape, generator=g, device=device)  # noqa: E731
        K, nu, V, d6, S = r(P, 6, Dz), r(P, Dz), r(P, 3, 3), r(P, 6), r(P, Dz, Dz)
        knu = K @ nu[..., None]  # refine's K @ nu[..., None]
        vv = V @ d6[:, :3][..., None]  # geometry.se3_exp's V(w) @ v[..., None]
        e = torch.einsum("...i,...ij,...j->...", nu, S, nu)  # linalg.mahalanobis_and_logdet
        miss = torch.zeros(1, dtype=torch.int32, device=device)
        word = torch.zeros(1, dtype=torch.int32, device=device)
        err = _build.library().propose_3d_orders_launch(
            K.data_ptr(), nu.data_ptr(), V.data_ptr(), d6.data_ptr(), S.data_ptr(),
            knu.data_ptr(), vv.data_ptr(), e.data_ptr(), miss.data_ptr(), word.data_ptr(), P, Dz,
            _build.stream_ptr(word))
        _build.check(err, "propose_3d orders")
        _ORDERS[key] = word
    return _ORDERS[key]


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"propose_3d: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def propose_3d(pose, P_cov, log_w, best, best_ll, lm_mean, lm_cov, lm_count, any_valid, z,
               valid, *, measurement, retract, camera, r_var, log_p0, unmatched_w,
               weight_min_count):
    """The frame's proposal refinement: (pose [P, 7], P_cov [P, 6, 6],
    log_w [P]), new tensors. `camera` is (fx, fy, cx, cy, baseline) of the
    measurement model, `r_var` the diagonal of R; `best` int32 or int64."""
    if measurement.name not in MODELS:
        raise ValueError(f"propose_3d: model {measurement.name!r} not in {sorted(MODELS)}")
    Dz = MODELS[measurement.name][1]
    if len(r_var) != Dz or len(camera) != 5:
        raise ValueError(f"propose_3d: r_var needs {Dz} entries and camera 5, "
                         f"got {len(r_var)} and {len(camera)}")
    dev = pose.device
    P, L = lm_count.shape
    Z = z.shape[0]
    f32 = torch.float32
    if best.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"propose_3d: best must be int32 or int64, got {best.dtype}")
    _check("best", best, (P, Z), best.dtype, dev)
    for name, t, shape, dtype in (
        ("pose", pose, (P, 7), f32), ("P_cov", P_cov, (P, 6, 6), f32),
        ("log_w", log_w, (P,), f32), ("best_ll", best_ll, (P, Z), f32),
        ("lm_mean", lm_mean, (P, L, 3), f32), ("lm_cov", lm_cov, (P, L, 3, 3), f32),
        ("lm_count", lm_count, (P, L), torch.int32), ("any_valid", any_valid, (P,), torch.bool),
        ("z", z, (Z, Dz), f32), ("valid", valid, (Z,), torch.bool),
    ):
        _check(name, t, shape, dtype, dev)
    kw = dict(log_p0=log_p0, unmatched_w=unmatched_w, weight_min_count=weight_min_count)
    if dev.type == "cpu":
        return propose_3d_reference(pose, P_cov, log_w, best, best_ll, lm_mean, lm_cov,
                                    lm_count, any_valid, z, valid, measurement=measurement,
                                    retract=retract, r_var=r_var, **kw)
    if dev.type != "cuda":
        raise ValueError(f"propose_3d: unsupported device {dev}")
    ins = [t.contiguous() for t in (pose, P_cov, log_w, best.to(torch.int32), best_ll, lm_mean,
                                    lm_cov, lm_count, any_valid, z, valid)]
    pose_out = torch.empty_like(ins[0])
    cov_out = torch.empty_like(ins[1])
    logw_out = torch.empty_like(ins[2])
    word = orders(P, Dz, dev)
    err = _build.library().propose_3d_launch(
        *(t.data_ptr() for t in ins), pose_out.data_ptr(), cov_out.data_ptr(),
        logw_out.data_ptr(), word.data_ptr(), P, L, Z, MODELS[measurement.name][0],
        int(weight_min_count), constants(measurement.name, camera, r_var, log_p0, unmatched_w),
        _build.stream_ptr(pose))
    _build.check(err, "propose_3d")
    propose_3d.launches += 1
    return pose_out, cov_out, logw_out


propose_3d.launches = 0
