"""Fused FastSLAM 1.0 measurement update, 2-D range-bearing model.

`measurement_update_2d` runs a whole frame of the update: association
against the pre-frame map, free-slot allocation, per-lane sequential EKF
updates, the weight increment and the cull. On CUDA tensors it launches the
hand-written kernel `csrc/ekf_update_2d.cu`, which updates the state
tensors IN PLACE; on CPU tensors it runs the plain twin
`measurement_update_2d_reference`. Port of
`parakeet_slam_tpu/kernels/ekf_update.py::measurement_update_2d`.

The twin is the torch port of the reference's XLA branch
(`FastSLAM.measurement_core` with use_pallas=False): `_associate_frame`,
then `_apply_observation` once per observation in order, then the cull.
Its 2x2 algebra is written out element by element in the kernel's
operation order (no batched matmul, no einsum, no reductions over 2
elements), so on the card the kernel and the twin round identically. Only
the log-weight sum over observations is taken in another order.

Semantics (v2 of the reference): every observation scores against the
PRE-FRAME map; the best lane is the first among equal maxima; new
landmarks take the first min(Z, 64) free lanes in observation order;
observations that share a lane update it in observation order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slambench.reference.frozen.kernels import _build

_NEG_INF = -1e30
_BIG_LANE = 2**30
MAX_OBS = 64
MAX_SIG = 4
MAX_L = 1 << 18  # the cull's lane bitmap lives in shared memory
# D * log(2 pi) for D=2, rounded as the reference's float32 graph rounds it.
LOG_2PI_2D = 2.0 * float(np.log(np.float32(2.0 * math.pi)))


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _pair_geometry(px, py, pth, mx, my, s11, s12, s21, s22, r11, r22):
    """Per-lane predicted range/bearing and inverse innovation covariance:
    (r, phi, Q^-1 (i11, i12, i21, i22), det Q, H (h11, h12, h21, h22))."""
    dx = mx - px
    dy = my - py
    q = dx * dx + dy * dy + 1e-12
    r = torch.sqrt(q)
    phi = _wrap(torch.atan2(dy, dx) - pth)
    h11, h12, h21, h22 = dx / r, dy / r, -dy / q, dx / q
    a11 = h11 * s11 + h12 * s21
    a12 = h11 * s12 + h12 * s22
    a21 = h21 * s11 + h22 * s21
    a22 = h21 * s12 + h22 * s22
    q11 = a11 * h11 + a12 * h12 + r11
    q12 = a11 * h21 + a12 * h22
    q21 = a21 * h11 + a22 * h12
    q22 = a21 * h21 + a22 * h22 + r22
    det = q11 * q22 - q12 * q21
    ds = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv = (q22 / ds, -q12 / ds, -q21 / ds, q11 / ds)
    return r, phi, inv, det, (h11, h12, h21, h22)


def _lane_geometry(pose, lm_mean, lm_cov, r_var):
    """Every lane's (r, phi, Q^-1, log det Q) [P, L] against its particle's pose."""
    px, py, pth = pose[:, 0:1], pose[:, 1:2], pose[:, 2:3]
    r, phi, inv, det, _ = _pair_geometry(
        px, py, pth, lm_mean[..., 0], lm_mean[..., 1],
        lm_cov[..., 0, 0], lm_cov[..., 0, 1], lm_cov[..., 1, 0], lm_cov[..., 1, 1],
        *r_var,
    )
    return r, phi, inv, torch.log(torch.clamp(det, min=1e-12))  # keeps NaN, as the kernel does


def _pair_scores(geom, lm_sig, lm_valid, zi, sigi, S, sig_var):
    """Log-likelihood [P, L] of one observation (zi [2], sigi [S]) against
    every lane; invalid lanes and non-finite scores are -1e30."""
    r, phi, (i11, i12, i21, i22), logdet = geom
    nu1 = zi[0] - r
    nu2 = _wrap(zi[1] - phi)
    t1 = nu1 * i11 + nu2 * i21
    t2 = nu1 * i12 + nu2 * i22
    maha = torch.clamp(t1 * nu1 + t2 * nu2, min=0.0)
    ll = -0.5 * (maha + logdet + LOG_2PI_2D)
    if S > 0:
        d2 = torch.zeros_like(ll)
        for s in range(S):
            d = lm_sig[..., s] - sigi[s]
            d2 = d2 + d * d
        ll = ll - (0.5 * d2) / sig_var
    return torch.where(lm_valid & torch.isfinite(ll), ll, _NEG_INF)


def _score_frame(pose, lm_mean, lm_cov, lm_sig, lm_valid, z, sig, S, r_var, sig_var):
    """Best lane and its log-likelihood [P, Z] for every observation against
    the pre-frame map (geometry once per lane, then one pass per obs)."""
    geom = _lane_geometry(pose, lm_mean, lm_cov, r_var)
    best, best_ll = [], []
    for i in range(z.shape[0]):
        ll = _pair_scores(geom, lm_sig, lm_valid, z[i], sig[i], S, sig_var)
        b = torch.argmax(ll, dim=1)  # first index among equal maxima
        best.append(b)
        best_ll.append(torch.gather(ll, 1, b[:, None])[:, 0])
    return torch.stack(best, 1), torch.stack(best_ll, 1)


def _associate(lm_valid, best, best_ll, valid, log_p0):
    """Targets [P, Z] (lane or -1), is_new, do_upd, do_alloc."""
    P, L = lm_valid.shape
    Z = best.shape[1]
    any_cand = lm_valid.any(dim=1, keepdim=True)
    is_new = (best_ll < log_p0) | ~any_cand
    do_new = is_new & valid[None, :]
    n_fs = min(Z, MAX_OBS)
    lanes = torch.arange(L, dtype=torch.int64, device=lm_valid.device)[None, :]
    free_sorted = torch.sort(
        torch.where(lm_valid, torch.full_like(lanes, _BIG_LANE), lanes), dim=1
    ).values[:, :n_fs]
    if free_sorted.shape[1] < n_fs:  # fewer lanes than slots
        pad = torch.full((P, n_fs - free_sorted.shape[1]), _BIG_LANE,
                         dtype=torch.int64, device=lm_valid.device)
        free_sorted = torch.cat([free_sorted, pad], dim=1)
    new_i = do_new.to(torch.int64)
    arank = torch.cumsum(new_i, dim=1) - new_i
    slot = torch.gather(free_sorted, 1, torch.clamp(arank, 0, n_fs - 1))
    has_free = (slot < L) & (arank < n_fs)
    do_alloc = do_new & has_free
    do_upd = ~is_new & valid[None, :]
    target = torch.where(do_upd, best, torch.where(do_alloc, slot, torch.full_like(slot, -1)))
    return target, is_new, do_upd, do_alloc


def _apply_observation(i, target, is_new, pose, z, sig, S, r_var, init_infl,
                       lm_mean, lm_cov, lm_sig, lm_valid, lm_count, matched):
    """Observation i applied at its target lane of every particle, in place:
    the EKF update at a matched lane, the inverse-model initialisation at an
    allocated one. It reads and writes that lane alone, so any order that
    keeps each lane's observations in observation order gives the same state
    (the kernel applies one lane per thread)."""
    r11, r22 = r_var
    rows = torch.arange(pose.shape[0], device=pose.device)
    px, py, pth = pose[:, 0], pose[:, 1], pose[:, 2]
    t = target[:, i]
    act = t >= 0
    upd = act & ~is_new[:, i]
    alloc = act & is_new[:, i]
    tc = torch.clamp(t, min=0)
    mx, my = lm_mean[rows, tc, 0], lm_mean[rows, tc, 1]
    s11, s12 = lm_cov[rows, tc, 0, 0], lm_cov[rows, tc, 0, 1]
    s21, s22 = lm_cov[rows, tc, 1, 0], lm_cov[rows, tc, 1, 1]
    zr, zphi = z[i, 0], z[i, 1]

    # EKF update at a matched lane
    r, phi, (i11, i12, i21, i22), _, (h11, h12, h21, h22) = _pair_geometry(
        px, py, pth, mx, my, s11, s12, s21, s22, r11, r22
    )
    nu1 = zr - r
    nu2 = _wrap(zphi - phi)
    b11, b12 = s11 * h11 + s12 * h12, s11 * h21 + s12 * h22
    b21, b22 = s21 * h11 + s22 * h12, s21 * h21 + s22 * h22
    k11, k12 = b11 * i11 + b12 * i21, b11 * i12 + b12 * i22
    k21, k22 = b21 * i11 + b22 * i21, b21 * i12 + b22 * i22
    mx_u = mx + (k11 * nu1 + k12 * nu2)
    my_u = my + (k21 * nu1 + k22 * nu2)
    e11, e12 = 1.0 - (k11 * h11 + k12 * h21), -(k11 * h12 + k12 * h22)
    e21, e22 = -(k21 * h11 + k22 * h21), 1.0 - (k21 * h12 + k22 * h22)
    c11, c12 = e11 * s11 + e12 * s21, e11 * s12 + e12 * s22
    c21, c22 = e21 * s11 + e22 * s21, e21 * s12 + e22 * s22
    cov_u = (0.5 * (c11 + c11), 0.5 * (c12 + c21), 0.5 * (c21 + c12), 0.5 * (c22 + c22))

    # allocation at a free lane: the range-bearing inverse model
    ang = pth + zphi
    ca, sa = torch.cos(ang), torch.sin(ang)
    nx, ny = px + zr * ca, py + zr * sa
    _, _, _, _, (g11, g12, g21, g22) = _pair_geometry(
        px, py, pth, nx, ny, s11, s12, s21, s22, r11, r22
    )
    hdet = g11 * g22 - g12 * g21
    hds = torch.where(hdet.abs() < 1e-12, torch.full_like(hdet, 1e-12), hdet)
    j11, j12, j21, j22 = g22 / hds, -g12 / hds, -g21 / hds, g11 / hds
    cov_n = (
        init_infl * ((j11 * r11) * j11 + (j12 * r22) * j12),
        init_infl * ((j11 * r11) * j21 + (j12 * r22) * j22),
        init_infl * ((j21 * r11) * j11 + (j22 * r22) * j12),
        init_infl * ((j21 * r11) * j21 + (j22 * r22) * j22),
    )

    pick = lambda u, n, old: torch.where(upd, u, torch.where(alloc, n, old))  # noqa: E731
    lm_mean[rows, tc, 0] = pick(mx_u, nx, mx)
    lm_mean[rows, tc, 1] = pick(my_u, ny, my)
    for (a, b), cu, cn, old in zip(
        ((0, 0), (0, 1), (1, 0), (1, 1)), cov_u, cov_n, (s11, s12, s21, s22)
    ):
        lm_cov[rows, tc, a, b] = pick(cu, cn, old)
    cnt = lm_count[rows, tc]
    cnt_u = cnt + 2
    lm_count[rows, tc] = pick(cnt_u, torch.ones_like(cnt), cnt)
    cf = torch.clamp(cnt_u.to(torch.float32), min=1.0)
    for s in range(S):
        so = lm_sig[rows, tc, s]
        lm_sig[rows, tc, s] = pick(so + (sig[i, s] - so) / cf, sig[i, s].expand_as(so), so)
    lm_valid[rows, tc] = lm_valid[rows, tc] | alloc
    matched[rows, tc] = matched[rows, tc] | act


def measurement_update_2d_reference(
    pose, log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, z, sig, valid,
    *, sig_dim, r_var, sig_var, log_p0, init_infl, max_range, fov_half, cull,
    cull_unseen=False, update_weights=True,
):
    """Plain PyTorch twin of the kernel. Returns NEW tensors
    (log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, n_match [P] float32,
    target [P, Z] int32); the inputs are left unchanged."""
    S = sig_dim
    P, L = lm_valid.shape
    Z = z.shape[0]
    best, best_ll = _score_frame(
        pose, lm_mean, lm_cov, lm_sig, lm_valid, z, sig, S, r_var, sig_var
    )
    target, is_new, do_upd, do_alloc = _associate(lm_valid, best, best_ll, valid, log_p0)
    n_match = (do_upd | do_alloc).to(torch.float32).sum(dim=1)
    if update_weights:
        dw = torch.where(is_new, torch.full_like(best_ll, log_p0), best_ll)
        log_w = log_w + torch.sum(torch.where(valid[None, :], dw, torch.zeros_like(dw)), dim=1)
    else:
        log_w = log_w.clone()

    lm_mean, lm_cov, lm_sig = lm_mean.clone(), lm_cov.clone(), lm_sig.clone()
    lm_valid, lm_count = lm_valid.clone(), lm_count.clone()
    matched = torch.zeros_like(lm_valid)
    for i in range(Z):
        _apply_observation(i, target, is_new, pose, z, sig, S, r_var, init_infl,
                           lm_mean, lm_cov, lm_sig, lm_valid, lm_count, matched)

    if cull:
        if cull_unseen:
            dec = lm_valid & ~matched
        else:
            dx = lm_mean[..., 0] - pose[:, 0:1]
            dy = lm_mean[..., 1] - pose[:, 1:2]
            r = torch.sqrt(dx * dx + dy * dy + 1e-12)
            phi = _wrap(torch.atan2(dy, dx) - pose[:, 2:3])
            in_fov = (r < max_range) & (phi.abs() < fov_half)
            dec = lm_valid & in_fov & ~matched
        lm_count = lm_count - dec.to(torch.int32)
        lm_valid = lm_valid & (lm_count >= 0)
    return log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, n_match, target.to(torch.int32)


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"measurement_update_2d: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"measurement_update_2d: {name} must be contiguous")


def measurement_update_2d(
    pose, log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, z, sig, valid,
    *, sig_dim, r_var, sig_var, log_p0, init_infl, max_range, fov_half, cull,
    cull_unseen=False, update_weights=True,
):
    """One frame of the fused update. Returns
    (log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, n_match, target).
    On CUDA the first six are the input tensors, updated in place."""
    kw = dict(
        sig_dim=sig_dim, r_var=r_var, sig_var=sig_var, log_p0=log_p0,
        init_infl=init_infl, max_range=max_range, fov_half=fov_half, cull=cull,
        cull_unseen=cull_unseen, update_weights=update_weights,
    )
    dev = pose.device
    if True:  # frozen reference: the plain twin on every device
        return measurement_update_2d_reference(
            pose, log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, z, sig, valid, **kw
        )
    if dev.type != "cuda":
        raise ValueError(f"measurement_update_2d: unsupported device {dev}")
    P, L = lm_valid.shape
    Z, S = z.shape[0], sig_dim
    if not (1 <= Z <= MAX_OBS and 0 <= S <= MAX_SIG and 1 <= L <= MAX_L):
        raise ValueError(f"measurement_update_2d: needs 1 <= Z <= {MAX_OBS}, "
                         f"0 <= S <= {MAX_SIG}, 1 <= L <= {MAX_L}")
    f32 = torch.float32
    sig = sig[:, :S].contiguous()
    for name, t, shape, dtype in (
        ("pose", pose, (P, 3), f32), ("log_w", log_w, (P,), f32),
        ("lm_mean", lm_mean, (P, L, 2), f32), ("lm_cov", lm_cov, (P, L, 2, 2), f32),
        ("lm_sig", lm_sig, (P, L, S), f32), ("lm_valid", lm_valid, (P, L), torch.bool),
        ("lm_count", lm_count, (P, L), torch.int32), ("z", z, (Z, 2), f32),
        ("sig", sig, (Z, S), f32), ("valid", valid, (Z,), torch.bool),
    ):
        _check(name, t, shape, dtype, dev)
    n_match = torch.empty(P, dtype=f32, device=dev)
    target = torch.empty(P, Z, dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.ekf_update_2d_launch(
        pose.data_ptr(), log_w.data_ptr(), lm_mean.data_ptr(), lm_cov.data_ptr(),
        lm_sig.data_ptr(), lm_valid.data_ptr(), lm_count.data_ptr(), z.data_ptr(),
        sig.data_ptr(), valid.data_ptr(), n_match.data_ptr(), target.data_ptr(),
        P, L, Z, S, r_var[0], r_var[1], sig_var, log_p0, LOG_2PI_2D, init_infl,
        max_range, fov_half, int(update_weights), int(cull), int(cull_unseen),
        _build.stream_ptr(pose),
    )
    _build.check(err, "ekf_update_2d")
    measurement_update_2d.launches += 1
    return log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, n_match, target


measurement_update_2d.launches = 0


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """The bearing wrap atan2(sin a, cos a), elementwise, float32. On a CUDA
    tensor it runs the kernels' own device function (`csrc/ekf_update_2d.cu`
    wrap_angle), so that it can be held against this twin bit for bit; on a
    CPU tensor it runs the twin."""
    if True:  # frozen reference: the plain twin on every device
        return _wrap(a)
    if a.device.type != "cuda" or a.dtype != torch.float32:
        raise ValueError(f"wrap_angle: needs float32 on cuda, got {a.dtype} on {a.device}")
    a = a.contiguous()
    out = torch.empty_like(a)
    err = _build.library().wrap_angle_launch(a.data_ptr(), out.data_ptr(), a.numel(),
                                             _build.stream_ptr(a))
    _build.check(err, "wrap_angle")
    return out
