"""Fused FastSLAM measurement update and association scores for the 3-D
vision models (pinhole_3d, stereo_3d, equirect_3d).

`score_3d` finds, for every (particle, observation), the best landmark lane
and its log-likelihood against the current map. `measurement_update_3d`
runs a whole frame: the same score pass (or external scores from
`score_3d`), free-slot allocation, association, the weight increment,
per-lane sequential EKF updates with anchor freeze, the per-model landmark
init, the cull and the latest-wins descriptor refresh. On CUDA tensors both
launch the hand-written kernels of `csrc/ekf_update_3d.cu` (the update
writes its state tensors IN PLACE); on CPU tensors they run the plain twins
`score_3d_reference` and `measurement_update_3d_reference`. Ports of
`parakeet_slam_tpu/kernels/ekf_update_3d.py::score_3d` and
`::measurement_update_3d`.

The twins are the torch port of the reference's XLA branch
(`FastSLAM.measurement_core` with use_pallas=False): `_score_frame`,
`_associate_frame`, `_apply_observation` once per observation in order,
then the cull. Their 3x3 algebra is written out element by element in the
kernel's operation order, every division by a constant is a product with
its float32 reciprocal in both, and a constant divided by a tensor is a
true division in both (`_rdiv`), so that on the card the kernel and the
twin round identically. Only the log-weight sum over observations is taken
in another order.

Semantics, as in the XLA path: every observation scores against the
PRE-FRAME map (geometry + `-desc_weight * popcount(xor)` of the packed
descriptors); invalid lanes and non-finite scores count -1e30; the best
lane is the smallest among equal maxima; an observation is new when its
best score is below log_p0 or its particle has no valid lane at all; new
landmarks take the first min(Z, 64) free lanes in observation order;
observations that share a lane update it in observation order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.kernels import _build
from parakeet_slam_tpu_torch.kernels.ekf_update import _associate

_NEG_INF = -1e30
MIN_DEPTH = 0.1  # filter/models.py MIN_DEPTH
MAX_Z = 256
MAX_W = 8
MAX_L = 1 << 18  # the cull's matched-lane bitmap lives in shared memory
MODELS = {"pinhole_3d": (0, 2), "stereo_3d": (1, 3), "equirect_3d": (2, 2)}

_f32 = np.float32
PI = float(_f32(math.pi))
HALF_PI = float(_f32(math.pi / 2))
TWO_PI = float(_f32(2 * math.pi))
INV_PI = float(_f32(1 / math.pi))
INV_2PI = float(_f32(1 / (2 * math.pi)))


def camera_rows(pose: torch.Tensor) -> torch.Tensor:
    """Pose [P, 7] (t, q) -> camera rows [P, 12]: R_cw row-major, then t."""
    R_cw = geometry.quat_to_matrix(pose[:, 3:]).transpose(-1, -2)
    return torch.cat([R_cw.reshape(-1, 9), pose[:, :3]], dim=1).contiguous()


class Consts:
    """The float32 constants of one call, shared by the kernel and the twin."""

    NAMES = (
        "fx", "fy", "cx", "cy", "inv_fx", "inv_fy", "fxb", "img_w", "img_h",
        "inv_img_w", "inv_img_h", "ku", "kv", "r0", "r1", "r2", "desc_weight",
        "log_p0", "log2pi_d", "init_infl", "range_prior", "sr2", "st2", "max_range",
        "pi", "half_pi", "two_pi", "inv_pi", "inv_2pi",
    )

    def __init__(self, model, par, r_var, desc_weight=0.0, log_p0=0.0, init_infl=1.0,
                 init_range_prior=5.0, init_range_sigma=2.5, max_range=10.0):
        if model not in MODELS:
            raise ValueError(f"unknown 3-D model {model!r}")
        par = dict(par)
        self.model_id, self.Dz = MODELS[model]
        if len(r_var) != self.Dz:
            raise ValueError(f"{model}: r_var needs {self.Dz} entries, got {len(r_var)}")
        fx, fy = par["fx"], par["fy"]
        W, H = par["img_w"], par["img_h"]
        rv = list(r_var) + [0.0] * (3 - len(r_var))
        # tangential std of the ray prior (pinhole / equirect init)
        sig_t = init_range_prior * math.sqrt(r_var[0]) * (
            1.0 / fx if model == "pinhole_3d" else 2.0 * math.pi / W
        )
        vals = dict(
            fx=fx, fy=fy, cx=par["cx"], cy=par["cy"], inv_fx=1.0 / fx, inv_fy=1.0 / fy,
            fxb=fx * par["baseline"], img_w=W, img_h=H, inv_img_w=1.0 / W,
            inv_img_h=1.0 / H, ku=W / (2 * math.pi), kv=H / math.pi,
            r0=rv[0], r1=rv[1], r2=rv[2], desc_weight=desc_weight, log_p0=log_p0,
            log2pi_d=float(_f32(self.Dz) * _f32(np.log(_f32(2 * math.pi)))),
            init_infl=init_infl, range_prior=init_range_prior,
            sr2=init_range_sigma**2, st2=sig_t**2, max_range=max_range,
            pi=PI, half_pi=HALF_PI, two_pi=TWO_PI, inv_pi=INV_PI, inv_2pi=INV_2PI,
        )
        for k in self.NAMES:
            setattr(self, k, float(_f32(vals[k])))
        self.r_var = (self.r0, self.r1, self.r2)[: self.Dz]

    def array(self):
        return _build.float_array([getattr(self, k) for k in self.NAMES])


# ---------------------------------------------------------------------------
# Shared element-by-element algebra (the kernel follows these lines)
# ---------------------------------------------------------------------------


def _dot3(a0, b0, a1, b1, a2, b2):
    return (a0 * b0 + a1 * b1) + a2 * b2


def _rdiv(a: float, x):
    """a / x as a true division (Python's `a / tensor` is reciprocal(x) * a)."""
    return torch.full_like(x, a) / x


def _rotate_to_world(R, a):
    """R_cw^T a."""
    return [_dot3(R[0][k], a[0], R[1][k], a[1], R[2][k], a[2]) for k in range(3)]


def _cam_point(R, t, m):
    """p = R_cw (m - t); R nested [3][3], t and m lists of 3."""
    d = [m[0] - t[0], m[1] - t[1], m[2] - t[2]]
    return [_dot3(R[i][0], d[0], R[i][1], d[1], R[i][2], d[2]) for i in range(3)]


def _world_point(R, t, a):
    """t + R_cw^T a (camera frame -> world)."""
    r = _rotate_to_world(R, a)
    return [t[k] + r[k] for k in range(3)]


def _zhat_jac(c, R, p):
    """(zhat list[Dz], H nested [Dz][3]) at camera point p; H = d zhat / d m."""
    if c.model_id < 2:  # pinhole / stereo
        z = torch.clamp(p[2], min=MIN_DEPTH)
        zz = z * z
        zhat = [(c.fx * p[0]) / z + c.cx, (c.fy * p[1]) / z + c.cy]
        a, b = _rdiv(c.fx, z), (-c.fx * p[0]) / zz
        H = [[a * R[0][j] + b * R[2][j] for j in range(3)]]
        a, b = _rdiv(c.fy, z), (-c.fy * p[1]) / zz
        H.append([a * R[1][j] + b * R[2][j] for j in range(3)])
        if c.model_id == 1:
            zhat.append(_rdiv(c.fxb, z))
            b = _rdiv(-c.fxb, zz)
            H.append([b * R[2][j] for j in range(3)])
        return zhat, H
    x, y, z = p
    xx_yy = x * x + y * y
    r = torch.sqrt(xx_yy + z * z) + 1e-9
    az = torch.atan2(y, x)
    el = torch.asin(torch.clamp(z / r, -1.0, 1.0))
    zhat = [((az + c.pi) * c.inv_2pi) * c.img_w, ((c.half_pi - el) * c.inv_pi) * c.img_h]
    rho2 = xx_yy + 1e-9
    rho = torch.sqrt(rho2)
    den = (rho2 + z * z) * rho
    du = [c.ku * (-y / rho2), c.ku * (x / rho2)]
    dv = [(-c.kv * (-x * z)) / den, (-c.kv * (-y * z)) / den, (-c.kv * rho2) / den]
    H = [
        [du[0] * R[0][j] + du[1] * R[1][j] for j in range(3)],
        [_dot3(dv[0], R[0][j], dv[1], R[1][j], dv[2], R[2][j]) for j in range(3)],
    ]
    return zhat, H


def _inverse(Q, Dz):
    """(inverse nested [Dz][Dz], det) with the reference's |det| < 1e-12 clamp."""
    if Dz == 2:
        det = Q[0][0] * Q[1][1] - Q[0][1] * Q[1][0]
        ds = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        return [[Q[1][1] / ds, -Q[0][1] / ds], [-Q[1][0] / ds, Q[0][0] / ds]], det
    (a, b, c), (d, e, f), (g, h, i) = Q
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    Hc = -(a * f - c * d)
    II = a * e - b * d
    det = (a * A + b * B) + c * C
    ds = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    return [[A / ds, D / ds, G / ds], [B / ds, E / ds, Hc / ds], [C / ds, F / ds, II / ds]], det


def _innovation_cov(H, S, r_var):
    """(A = H S, Q = A H^T + diag(r_var))."""
    Dz = len(H)
    A = [[_dot3(H[i][0], S[0][j], H[i][1], S[1][j], H[i][2], S[2][j]) for j in range(3)]
         for i in range(Dz)]
    Q = [[_dot3(A[i][0], H[j][0], A[i][1], H[j][1], A[i][2], H[j][2]) for j in range(Dz)]
         for i in range(Dz)]
    for k in range(Dz):
        Q[k][k] = Q[k][k] + r_var[k]
    return A, Q


def _residual(c, zobs, zhat):
    nu = [zobs[k] - zhat[k] for k in range(len(zhat))]
    if c.model_id == 2:  # wrap u to (-W/2, W/2]; round half to even
        nu[0] = nu[0] - c.img_w * torch.round(nu[0] * c.inv_img_w)
    return nu


def _maha(nu, inv):
    D = len(nu)
    tj = []
    for j in range(D):
        acc = nu[0] * inv[0][j]
        for i in range(1, D):
            acc = acc + nu[i] * inv[i][j]
        tj.append(acc)
    acc = tj[0] * nu[0]
    for j in range(1, D):
        acc = acc + tj[j] * nu[j]
    return torch.clamp(acc, min=0.0)


def _planes(lm_mean, lm_cov, idx=None):
    """Mean list[3] and covariance nested [3][3] of every lane, or of lane
    idx [P] of every particle."""
    if idx is not None:
        rows = torch.arange(lm_mean.shape[0], device=lm_mean.device)
        lm_mean, lm_cov = lm_mean[rows, idx], lm_cov[rows, idx]
    return ([lm_mean[..., k] for k in range(3)],
            [[lm_cov[..., a, b] for b in range(3)] for a in range(3)])


def _cam(cam, lanes: bool):
    """R nested [3][3] and t list[3] from camera rows, shaped to broadcast
    against [P, L] planes (lanes) or [P] vectors."""
    col = (lambda k: cam[:, k:k + 1]) if lanes else (lambda k: cam[:, k])
    return [[col(3 * i + j) for j in range(3)] for i in range(3)], [col(9 + k) for k in range(3)]


def _popcount32(x):
    """Bit count of int32 words (as int64), exact for negative words."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _lane_geometry(c, cam, lm_mean, lm_cov, r_var):
    """Every lane's (zhat list[Dz], Q^-1 nested [Dz][Dz], log det Q) [P, L]."""
    R, t = _cam(cam, lanes=True)
    m, S = _planes(lm_mean, lm_cov)
    zhat, H = _zhat_jac(c, R, _cam_point(R, t, m))
    _, Q = _innovation_cov(H, S, r_var)
    inv, det = _inverse(Q, c.Dz)
    return zhat, inv, torch.log(torch.clamp(det, min=1e-12))  # keeps NaN, as the kernel does


def _pair_scores(c, geom, lm_desc, lm_valid, zi, desci, W):
    """Score [P, L] of one observation (zi [Dz], desci [W]) against every
    lane; invalid lanes and non-finite scores are -1e30."""
    zhat, inv, logdet = geom
    nu = _residual(c, [zi[k] for k in range(c.Dz)], zhat)
    ll = -0.5 * ((_maha(nu, inv) + logdet) + c.log2pi_d)
    if W > 0:
        ham = torch.zeros(lm_valid.shape, dtype=torch.int64, device=lm_valid.device)
        for w in range(W):
            ham = ham + _popcount32(torch.bitwise_xor(lm_desc[..., w], desci[w]))
        ll = ll - c.desc_weight * ham.to(torch.float32)
    return torch.where(lm_valid & torch.isfinite(ll), ll, _NEG_INF)


def _score_frame(c, cam, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, W, r_var):
    """(best lane [P, Z] int64, best ll [P, Z]) against the pre-frame map:
    the lane geometry once, then one pass per observation."""
    geom = _lane_geometry(c, cam, lm_mean, lm_cov, r_var)
    best, best_ll = [], []
    for i in range(z.shape[0]):
        ll = _pair_scores(c, geom, lm_desc, lm_valid, z[i], desc[i], W)
        b = torch.argmax(ll, dim=1)  # first index among equal maxima
        best.append(b)
        best_ll.append(torch.gather(ll, 1, b[:, None])[:, 0])
    return torch.stack(best, 1), torch.stack(best_ll, 1)


def _init_landmark(c, R, t, zobs):
    """New-landmark (mean list[3], cov nested [3][3]) at observation zobs
    from camera (R, t) [P]."""
    if c.model_id == 1:  # stereo: triangulate, cov = infl * Hinv R Hinv^T
        depth = _rdiv(c.fxb, torch.clamp(zobs[2], min=1e-3))
        pc = [((zobs[0] - c.cx) * c.inv_fx) * depth, ((zobs[1] - c.cy) * c.inv_fy) * depth, depth]
        mean = _world_point(R, t, pc)
        _, H = _zhat_jac(c, R, _cam_point(R, t, mean))
        for k in range(3):
            H[k][k] = H[k][k] + 1e-9
        Hi, _ = _inverse(H, 3)
        rv = (c.r0, c.r1, c.r2)
        cov = [[c.init_infl * _dot3(Hi[i][0] * rv[0], Hi[j][0], Hi[i][1] * rv[1], Hi[j][1],
                                    Hi[i][2] * rv[2], Hi[j][2]) for j in range(3)]
               for i in range(3)]
        return mean, cov
    if c.model_id == 0:  # pinhole: the ray through the pixel
        rx = (zobs[0] - c.cx) * c.inv_fx
        ry = (zobs[1] - c.cy) * c.inv_fy
        n = torch.sqrt((rx * rx + ry * ry) + 1.0)
        ray = [rx / n, ry / n, _rdiv(1.0, n)]
    else:  # equirect
        az = ((zobs[0] * c.inv_img_w) * c.two_pi) - c.pi
        el = c.half_pi - (zobs[1] * c.inv_img_h) * c.pi
        ce = torch.cos(el)
        ray = [ce * torch.cos(az), ce * torch.sin(az), torch.sin(el)]
    mean = _world_point(R, t, [c.range_prior * ray[k] for k in range(3)])
    ray_w = _rotate_to_world(R, ray)
    cov = []
    for i in range(3):
        row = []
        for j in range(3):
            along = ray_w[i] * ray_w[j]
            rest = (1.0 - along) if i == j else (0.0 - along)
            row.append(c.init_infl * (c.sr2 * along + c.st2 * rest))
        cov.append(row)
    return mean, cov


def _in_fov(c, R, t, m):
    p = _cam_point(R, t, m)
    if c.model_id == 2:
        return torch.sqrt((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]) < c.max_range
    zhat, _ = _zhat_jac(c, R, p)
    return ((p[2] > 0.05) & (p[2] < c.max_range) & (zhat[0] >= 0.0) & (zhat[0] < c.img_w)
            & (zhat[1] >= 0.0) & (zhat[1] < c.img_h))


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def score_3d_reference(pose, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, *,
                       model, desc_words, par, r_var, desc_weight):
    """Plain twin of `score_3d`: (best ll [P, Z] float32, lane [P, Z] int32)."""
    c = Consts(model, par, r_var, desc_weight)
    best, best_ll = _score_frame(c, camera_rows(pose), lm_mean, lm_cov, lm_desc, lm_valid,
                                 z, desc, desc_words, c.r_var)
    return best_ll, best.to(torch.int32)


def measurement_update_3d_reference(
    pose, log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count, z, desc, valid,
    ext_ll=None, ext_ix=None, *, model, desc_words, par, r_var, desc_weight, log_p0,
    init_infl, init_range_prior, init_range_sigma, max_range, cull, cull_unseen=False,
    update_weights=True, freeze=0,
):
    """Plain twin of the kernel. Returns NEW tensors (log_w, lm_mean, lm_cov,
    lm_desc, lm_valid, lm_count, n_match [P] float32, target [P, Z] int32);
    the inputs are left unchanged."""
    c = Consts(model, par, r_var, desc_weight, log_p0, init_infl, init_range_prior,
               init_range_sigma, max_range)
    W = desc_words
    P, L = lm_valid.shape
    Z = z.shape[0]
    cam = camera_rows(pose)
    if ext_ll is None:
        best, best_ll = _score_frame(c, cam, lm_mean, lm_cov, lm_desc, lm_valid, z, desc,
                                     W, c.r_var)
    else:
        best, best_ll = ext_ix.long(), ext_ll
    target, is_new, do_upd, do_alloc = _associate(lm_valid, best, best_ll, valid, c.log_p0)
    n_match = (do_upd | do_alloc).to(torch.float32).sum(dim=1)
    if update_weights:
        dw = torch.where(is_new, torch.full_like(best_ll, c.log_p0), best_ll)
        log_w = log_w + torch.sum(torch.where(valid[None, :], dw, torch.zeros_like(dw)), dim=1)
    else:
        log_w = log_w.clone()

    lm_mean, lm_cov, lm_desc = lm_mean.clone(), lm_cov.clone(), lm_desc.clone()
    lm_valid, lm_count = lm_valid.clone(), lm_count.clone()
    matched = torch.zeros_like(lm_valid)
    rows = torch.arange(P, device=pose.device)
    R, t = _cam(cam, lanes=False)
    for i in range(Z):
        tgt = target[:, i]
        act = tgt >= 0
        upd = act & ~is_new[:, i]
        alloc = act & is_new[:, i]
        tc = torch.clamp(tgt, min=0)
        m, S = _planes(lm_mean, lm_cov, tc)
        zobs = [z[i, k] for k in range(c.Dz)]
        cnt = lm_count[rows, tc]

        # EKF update at a matched lane
        zhat, H = _zhat_jac(c, R, _cam_point(R, t, m))
        nu = _residual(c, zobs, zhat)
        _, Q = _innovation_cov(H, S, c.r_var)
        Qi, _ = _inverse(Q, c.Dz)
        D = c.Dz
        SHt = [[_dot3(S[k][0], H[a][0], S[k][1], H[a][1], S[k][2], H[a][2]) for a in range(D)]
               for k in range(3)]
        K = [[_sum([SHt[k][b] * Qi[b][a] for b in range(D)]) for a in range(D)]
             for k in range(3)]
        m_u = [m[k] + _sum([K[k][a] * nu[a] for a in range(D)]) for k in range(3)]
        IKH = [[(1.0 if a == b else 0.0) - _sum([K[a][e] * H[e][b] for e in range(D)])
                for b in range(3)] for a in range(3)]
        Sn = [[_dot3(IKH[a][0], S[0][b], IKH[a][1], S[1][b], IKH[a][2], S[2][b])
               for b in range(3)] for a in range(3)]
        c_u = [[0.5 * (Sn[a][b] + Sn[b][a]) for b in range(3)] for a in range(3)]

        # allocation at a free lane
        m_n, c_n = _init_landmark(c, R, t, zobs)

        move = upd & (cnt < freeze) if freeze > 0 else upd  # anchor freeze
        pick = lambda u, n, old: torch.where(move, u, torch.where(alloc, n, old))  # noqa: E731
        for k in range(3):
            lm_mean[rows, tc, k] = pick(m_u[k], m_n[k], m[k])
        for a in range(3):
            for b in range(3):
                lm_cov[rows, tc, a, b] = pick(c_u[a][b], c_n[a][b], S[a][b])
        lm_count[rows, tc] = torch.where(upd, cnt + 2, torch.where(alloc, torch.ones_like(cnt), cnt))
        for w in range(W):  # latest-wins descriptor
            lm_desc[rows, tc, w] = torch.where(act, desc[i, w], lm_desc[rows, tc, w])
        lm_valid[rows, tc] = lm_valid[rows, tc] | alloc
        matched[rows, tc] = matched[rows, tc] | act

    if cull:
        if cull_unseen:
            dec = lm_valid & ~matched
        else:
            Rl, tl = _cam(cam, lanes=True)
            mm, _ = _planes(lm_mean, lm_cov)
            dec = lm_valid & _in_fov(c, Rl, tl, mm) & ~matched
        lm_count = lm_count - dec.to(torch.int32)
        lm_valid = lm_valid & (lm_count >= 0)
    return log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count, n_match, target.to(torch.int32)


def _sum(terms):
    acc = terms[0]
    for x in terms[1:]:
        acc = acc + x
    return acc


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(what, name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{what}: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _check_map(what, pose, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, model, W):
    dev = pose.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    P, L = lm_valid.shape
    Z = z.shape[0]
    Dz = MODELS[model][1]
    if not (1 <= Z <= MAX_Z and 0 <= W <= MAX_W and 1 <= L <= MAX_L):
        raise ValueError(f"{what}: needs 1 <= Z <= {MAX_Z}, 0 <= W <= {MAX_W}, L <= {MAX_L}")
    f32 = torch.float32
    for name, t, shape, dtype in (
        ("pose", pose, (P, 7), f32), ("lm_mean", lm_mean, (P, L, 3), f32),
        ("lm_cov", lm_cov, (P, L, 3, 3), f32), ("lm_desc", lm_desc, (P, L, W), torch.int32),
        ("lm_valid", lm_valid, (P, L), torch.bool), ("z", z, (Z, Dz), f32),
        ("desc", desc, (Z, W), torch.int32),
    ):
        _check(what, name, t, shape, dtype, dev)
    return P, L, Z


def score_3d(pose, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, *,
             model, desc_words, par, r_var, desc_weight):
    """Association scores only: per (particle, observation) the best lane's
    log-likelihood and the lane, (ll [P, Z] float32, lane [P, Z] int32),
    against the current map at the given poses. Equal, bit for bit, to the
    fused update's own score pass."""
    kw = dict(model=model, desc_words=desc_words, par=par, r_var=r_var,
              desc_weight=desc_weight)
    if pose.device.type == "cpu":
        return score_3d_reference(pose, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, **kw)
    W = desc_words
    desc = desc[:, :W].contiguous()
    P, L, Z = _check_map("score_3d", pose, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, model, W)
    c = Consts(model, par, r_var, desc_weight)
    cam = camera_rows(pose)
    ll = torch.empty(P, Z, dtype=torch.float32, device=pose.device)
    ix = torch.empty(P, Z, dtype=torch.int32, device=pose.device)
    err = _build.library().score_3d_launch(
        cam.data_ptr(), lm_mean.data_ptr(), lm_cov.data_ptr(), lm_desc.data_ptr(),
        lm_valid.data_ptr(), z.data_ptr(), desc.data_ptr(), ll.data_ptr(), ix.data_ptr(),
        P, L, Z, W, c.model_id, c.array(), _build.stream_ptr(pose),
    )
    _build.check(err, "score_3d")
    score_3d.launches += 1
    return ll, ix


score_3d.launches = 0


def measurement_update_3d(
    pose, log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count, z, desc, valid,
    ext_ll=None, ext_ix=None, *, model, desc_words, par, r_var, desc_weight, log_p0,
    init_infl, init_range_prior, init_range_sigma, max_range, cull, cull_unseen=False,
    update_weights=True, freeze=0,
):
    """One frame of the fused 3-D update. Returns (log_w, lm_mean, lm_cov,
    lm_desc, lm_valid, lm_count, n_match, target). On CUDA the first six are
    the input tensors, updated in place. `ext_ll`/`ext_ix` ([P, Z], from
    `score_3d`) replace the kernel's own score pass."""
    kw = dict(
        model=model, desc_words=desc_words, par=par, r_var=r_var, desc_weight=desc_weight,
        log_p0=log_p0, init_infl=init_infl, init_range_prior=init_range_prior,
        init_range_sigma=init_range_sigma, max_range=max_range, cull=cull,
        cull_unseen=cull_unseen, update_weights=update_weights, freeze=freeze,
    )
    if pose.device.type == "cpu":
        return measurement_update_3d_reference(
            pose, log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count, z, desc, valid,
            ext_ll, ext_ix, **kw,
        )
    W = desc_words
    desc = desc[:, :W].contiguous()
    what = "measurement_update_3d"
    P, L, Z = _check_map(what, pose, lm_mean, lm_cov, lm_desc, lm_valid, z, desc, model, W)
    dev = pose.device
    _check(what, "log_w", log_w, (P,), torch.float32, dev)
    _check(what, "lm_count", lm_count, (P, L), torch.int32, dev)
    _check(what, "valid", valid, (Z,), torch.bool, dev)
    if (ext_ll is None) != (ext_ix is None):
        raise ValueError(f"{what}: pass both ext_ll and ext_ix, or neither")
    if ext_ll is not None:
        ext_ix = ext_ix.to(torch.int32).contiguous()
        _check(what, "ext_ll", ext_ll, (P, Z), torch.float32, dev)
        _check(what, "ext_ix", ext_ix, (P, Z), torch.int32, dev)
    c = Consts(model, par, r_var, desc_weight, log_p0, init_infl, init_range_prior,
               init_range_sigma, max_range)
    cam = camera_rows(pose)
    n_match = torch.empty(P, dtype=torch.float32, device=dev)
    target = torch.empty(P, Z, dtype=torch.int32, device=dev)
    ext = ext_ll is not None
    err = _build.library().ekf_update_3d_launch(
        cam.data_ptr(), log_w.data_ptr(), lm_mean.data_ptr(), lm_cov.data_ptr(),
        lm_desc.data_ptr(), lm_valid.data_ptr(), lm_count.data_ptr(), z.data_ptr(),
        desc.data_ptr(), valid.data_ptr(), ext_ll.data_ptr() if ext else None,
        ext_ix.data_ptr() if ext else None, n_match.data_ptr(), target.data_ptr(),
        P, L, Z, W, c.model_id, int(freeze), int(update_weights), int(cull),
        int(cull_unseen), c.array(), _build.stream_ptr(pose),
    )
    _build.check(err, what)
    measurement_update_3d.launches += 1
    return log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count, n_match, target


measurement_update_3d.launches = 0
