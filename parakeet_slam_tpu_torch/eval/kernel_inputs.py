"""Seeded inputs for holding the update kernel against its twin (and, in the
tests, against the JAX package): a pre-filled particle state and one frame
of observations, as numpy arrays.

The particles sit near one pose and share one landmark world, each with its
own jitter, so that observations made from the first particle's pose
associate in every particle. Half the observations re-observe mapped
landmarks, the rest are new; with `collide`, pairs of observations repeat a
landmark so that two updates land on one lane in one frame. `fill` chooses
the map: "holes" (about half the lanes valid, scattered), "full" (no free
lane) or "empty".
"""

from __future__ import annotations

import numpy as np


def prefilled_frame(P, L, Z, S, seed, fill="holes", collide=True, n_invalid=1):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    base = np.array([0.5, -0.3, 0.2])
    pose = base + rng.normal(scale=[0.05, 0.05, 0.02], size=(P, 3))

    # the landmark world: ranges 1..8 m (some beyond max_range), all bearings
    r = rng.uniform(1.0, 8.0, L)
    phi = rng.uniform(-np.pi, np.pi, L)
    world = base[:2] + r[:, None] * np.stack([np.cos(base[2] + phi), np.sin(base[2] + phi)], 1)
    world_sig = rng.uniform(0.0, 1.0, (L, S))
    lm_mean = world[None] + rng.normal(scale=0.03, size=(P, L, 2))
    A = rng.normal(scale=0.1, size=(P, L, 2, 2))
    lm_cov = A @ np.swapaxes(A, -1, -2) + 0.005 * np.eye(2)
    lm_sig = world_sig[None] + rng.normal(scale=0.05, size=(P, L, S))
    if fill == "full":
        lm_valid = np.ones((P, L), bool)
    elif fill == "empty":
        lm_valid = np.zeros((P, L), bool)
    else:
        lm_valid = rng.random((P, L)) < 0.5
    lm_count = np.where(lm_valid, rng.integers(0, 4, (P, L)), 0)

    # observations from particle 0's pose: re-observations of mapped
    # landmarks in view, then new landmarks between them
    seen = np.flatnonzero(lm_valid[0] & (r < 6.0))
    n_old = min(len(seen), Z // 2)
    picks = rng.choice(seen, n_old, replace=False) if n_old else np.zeros(0, int)
    pts = list(world[picks])
    sigs = list(world_sig[picks])
    while len(pts) < Z:
        rr, pp = rng.uniform(1.0, 5.0), rng.uniform(-2.3, 2.3)
        pts.append(base[:2] + rr * np.array([np.cos(base[2] + pp), np.sin(base[2] + pp)]))
        sigs.append(rng.uniform(0.0, 1.0, S))
    pts, sigs = np.array(pts[:Z]), np.array(sigs[:Z]).reshape(Z, S)
    if collide and Z >= 4:
        pts[1], sigs[1] = pts[0], sigs[0]             # two re-observations of one lane
        pts[Z - 1], sigs[Z - 1] = pts[Z - 2], sigs[Z - 2]
    d = pts - pose[0, :2]
    z = np.stack(
        [np.hypot(d[:, 0], d[:, 1]), np.arctan2(d[:, 1], d[:, 0]) - pose[0, 2]], 1
    )
    z[:, 1] = np.arctan2(np.sin(z[:, 1]), np.cos(z[:, 1]))
    z = z + rng.normal(scale=[0.02, 0.005], size=(Z, 2))
    sig = sigs + rng.normal(scale=0.05, size=(Z, S))
    valid = np.arange(Z) < Z - n_invalid
    return dict(
        pose=pose.astype(f32), log_w=rng.normal(size=P).astype(f32),
        lm_mean=lm_mean.astype(f32), lm_cov=lm_cov.astype(f32),
        lm_sig=lm_sig.astype(f32), lm_valid=lm_valid,
        lm_count=lm_count.astype(np.int32), z=z.astype(f32), sig=sig.astype(f32),
        valid=valid,
    )


# ---------------------------------------------------------------------------
# 3-D vision frames
# ---------------------------------------------------------------------------

# (fx, fy, cx, cy, baseline, img_w, img_h) per model: a small pinhole camera
# (the reference's kernel tests), KITTI's stereo rig, a 2048x1024 panorama.
CAMERAS = {
    "pinhole_3d": (96.0, 96.0, 80.0, 48.0, 0.3, 160.0, 96.0),
    "stereo_3d": (718.856, 718.856, 607.1928, 185.2157, 0.5372, 1241.0, 376.0),
    "equirect_3d": (500.0, 500.0, 1024.0, 512.0, 0.3, 2048.0, 1024.0),
}
PAR_KEYS = ("fx", "fy", "cx", "cy", "baseline", "img_w", "img_h")


def camera_par(model):
    """The camera of `model` as the kernels' (name, value) pairs."""
    return tuple(zip(PAR_KEYS, CAMERAS[model]))


def quat_rotate_np(q, v):
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4] (x, y, z, w)."""
    u, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def project_np(model, pose, pts, par):
    """Camera-frame points and measurements [N, Dz] of world points [N, 3]
    seen from one SE(3) pose [7] (the reference's models, in numpy)."""
    fx, fy, cx, cy, b, W, H = (dict(par)[k] for k in PAR_KEYS)
    qc = pose[3:] * np.array([-1.0, -1.0, -1.0, 1.0])
    p = quat_rotate_np(qc, pts - pose[:3])
    if model == "equirect_3d":
        r = np.linalg.norm(p, axis=1) + 1e-9
        u = (np.arctan2(p[:, 1], p[:, 0]) + np.pi) / (2 * np.pi) * W
        v = (np.pi / 2 - np.arcsin(np.clip(p[:, 2] / r, -1, 1))) / np.pi * H
        return p, np.stack([u, v], 1)
    z = np.maximum(p[:, 2], 0.1)
    cols = [fx * p[:, 0] / z + cx, fy * p[:, 1] / z + cy]
    if model == "stereo_3d":
        cols.append(fx * b / z)
    return p, np.stack(cols, 1)


def _random_quats(rng, n, angle):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = 0.5 * angle * rng.normal(size=(n, 1))
    return np.concatenate([np.sin(half) * axis, np.cos(half)], 1)


def _sample_world(model, rng, n, par):
    """n landmarks in view of the identity pose (10% outside the image)."""
    fx, fy, cx, cy, _, W, H = (dict(par)[k] for k in PAR_KEYS)
    if model == "equirect_3d":
        d = rng.normal(size=(n, 3))
        return d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(2.0, 40.0, (n, 1))
    u = rng.uniform(-0.05 * W, 1.05 * W, n)
    v = rng.uniform(-0.05 * H, 1.05 * H, n)
    depth = rng.uniform(3.0, 30.0, n)
    return np.stack([(u - cx) / fx * depth, (v - cy) / fy * depth, depth], 1)


def flip_bits(rng, desc, n_bits):
    """desc [N, W] uint32 with n_bits random bits flipped in each row."""
    out = desc.copy()
    for _ in range(n_bits):
        w = rng.integers(0, desc.shape[1], len(desc))
        out[np.arange(len(desc)), w] ^= (np.uint32(1) << rng.integers(0, 32, len(desc)).astype(np.uint32))
    return out


def prefilled_frame_3d(P, L, Z, model, seed, fill="holes"):
    """A pre-filled 3-D vision frame as numpy arrays (8 descriptor words,
    uint32).

    The particles sit within 1 mm and 1 mrad of the identity pose, each with
    its own jitter, and share one landmark world in view of the camera. About half
    the observations re-observe landmarks that particle 0 has mapped (their
    projection with pixel noise, their descriptor with two bits flipped); the
    rest are new (a fresh random descriptor); two pairs of observations
    repeat a landmark, so that two updates land on one lane in one frame;
    the last observation is invalid. `fill`: "holes" (about half the lanes
    valid), "full" or "empty".
    """
    W, scatter = 8, 1e-3
    rng = np.random.default_rng(seed)
    f32 = np.float32
    par = camera_par(model)
    pose = np.zeros((P, 7))
    pose[:, :3] = rng.uniform(-scatter, scatter, (P, 3))
    pose[:, 3:] = _random_quats(rng, P, scatter)
    world = _sample_world(model, rng, L, par)
    world_desc = rng.integers(0, 2**32, (L, W), dtype=np.uint32)
    lm_mean = world[None] + rng.normal(scale=0.02, size=(P, L, 3))
    A = rng.normal(scale=0.1, size=(P, L, 3, 3))
    lm_cov = A @ np.swapaxes(A, -1, -2) + 0.01 * np.eye(3)
    lm_desc = np.broadcast_to(world_desc, (P, L, W)).copy()
    if fill == "full":
        lm_valid = np.ones((P, L), bool)
    elif fill == "empty":
        lm_valid = np.zeros((P, L), bool)
    else:
        lm_valid = rng.random((P, L)) < 0.5
    lm_count = np.where(lm_valid, rng.integers(0, 9, (P, L)), 0)
    _, zw = project_np(model, pose[0], world, par)
    inside = (zw[:, 0] >= 0) & (zw[:, 0] < CAMERAS[model][5]) & (zw[:, 1] >= 0) & (
        zw[:, 1] < CAMERAS[model][6])
    seen = np.flatnonzero(lm_valid[0] & inside)
    n_old = min(len(seen), Z // 2)
    picks = rng.choice(seen, n_old, replace=False)
    fresh = _sample_world(model, rng, Z - n_old, par)
    _, z_new = project_np(model, pose[0], fresh, par)
    z = np.concatenate([zw[picks], z_new])
    desc = np.concatenate([flip_bits(rng, world_desc[picks], 2),
                           rng.integers(0, 2**32, (Z - n_old, W), dtype=np.uint32)])
    if Z >= 4:
        z[1], desc[1] = z[0], desc[0]          # two re-observations of one lane
        z[Z - 1], desc[Z - 1] = z[Z - 2], desc[Z - 2]
    z = z + rng.normal(scale=0.5, size=z.shape)
    valid = np.arange(Z) < Z - 1
    return dict(
        pose=pose.astype(f32), log_w=rng.normal(size=P).astype(f32),
        lm_mean=lm_mean.astype(f32), lm_cov=lm_cov.astype(f32), lm_desc=lm_desc,
        lm_valid=lm_valid, lm_count=lm_count.astype(np.int32), z=z.astype(f32),
        desc=desc, valid=valid,
    )


def bench_frame_3d(P, L, Z, model, seed=0, W=8):
    """The reference's kernel-bench frame (eval/bench_kernels.py, bench_ekf3d
    and bench_fs_step), drawn with numpy: poses near the origin facing +z,
    every lane valid with a random mean (10 m scale), covariance 0.1 I and a
    random descriptor; observations spread over the whole image."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    Dz = 3 if model == "stereo_3d" else 2
    pose = np.zeros((P, 7), f32)
    pose[:, :3] = 0.01 * rng.normal(size=(P, 3))
    pose[:, 6] = 1.0
    hi = np.array([CAMERAS[model][5], CAMERAS[model][6], 40.0])[:Dz]
    lo = np.array([0.0, 0.0, 2.0])[:Dz]
    return dict(
        pose=pose, log_w=np.zeros(P, f32),
        lm_mean=(10.0 * rng.normal(size=(P, L, 3))).astype(f32),
        lm_cov=np.broadcast_to(0.1 * np.eye(3, dtype=f32), (P, L, 3, 3)).copy(),
        lm_desc=rng.integers(0, 2**32, (P, L, W), dtype=np.uint32),
        lm_valid=np.ones((P, L), bool), lm_count=np.ones((P, L), np.int32),
        z=(lo + rng.random((Z, Dz)) * (hi - lo)).astype(f32),
        desc=rng.integers(0, 2**32, (Z, W), dtype=np.uint32), valid=np.ones(Z, bool),
    )


# The 3-D update's timed shapes (P particles, L lanes, Z observations) and
# the options of every frame update: the same for `chip_smoke.py`, which
# holds the kernels against their twins, and `eval/ab_kernels.py`, which
# times trees against each other.
BENCH_3D = (1024, 8192, 32)       # the reference's kernel bench
KITTI_3D = (2048, 10240, 128)     # configs/kitti_00.yaml: FastSLAM 2.0, stereo_3d
PANORAMIC_3D = (1024, 8192, 128)  # configs/panoramic.yaml: FastSLAM 1.0, equirect_3d
CONFIG2_3D = (512, 1024, 64)      # configs/tum_fr1_desk.yaml: FastSLAM 2.0, pinhole_3d
CONFIG4_3D = (512, 4096, 64)      # configs/euroc_mh.yaml: FastSLAM 2.0, pinhole_3d
# (what, model, shape, fed score_3d's scores): scoring the frame itself as
# FastSLAM 1.0 does, and fed scores as FastSLAM 2.0 does (configs 2, 3, 4)
UPDATE_3D_CASES = (
    ("kitti", "stereo_3d", KITTI_3D, False),
    ("bench", "equirect_3d", BENCH_3D, False),
    ("panoramic", "equirect_3d", PANORAMIC_3D, False),
    ("kitti", "stereo_3d", KITTI_3D, True),
    ("config2", "pinhole_3d", CONFIG2_3D, True),
    ("config4", "pinhole_3d", CONFIG4_3D, True),
)
NOISE_3D = {"pinhole_3d": (2.0, 2.0), "stereo_3d": (1.5, 1.5, 1.0), "equirect_3d": (3.0, 3.0)}
SCORE_3D_KEYS = ("model", "desc_words", "par", "r_var", "desc_weight")


def update_3d_kwargs(model, **flags):
    """Keyword arguments of `measurement_update_3d` for `model` (8
    descriptor words), `flags` overriding the defaults; `score_3d` takes
    the `SCORE_3D_KEYS` of them."""
    kw = dict(model=model, desc_words=8, par=camera_par(model),
              r_var=tuple(v * v for v in NOISE_3D[model]), desc_weight=0.5, log_p0=-30.0,
              init_infl=1.0, init_range_prior=8.0, init_range_sigma=3.0, max_range=35.0,
              cull=True)
    kw.update(flags)
    return kw


# The matcher's timed shapes: the reference's bench (N queries x M rows, 8
# words) and the loop-closure match of one keyframe against the stacked
# store (`system._dispatch_loop_closure`): (what, F descriptors a keyframe,
# store capacity, keyframes written, eligible).
HAMMING_BENCH = (1024, 131072)
CLOSURE_SHAPES = (("config2", 256, 64, 40, 33), ("panoramic", 512, 2048, 1100, 1025))


def descriptors(rng, shape, pool=0):
    """Random packed descriptors (int32 words); with `pool`, rows drawn from
    that many distinct rows, so exact duplicates and ties occur."""
    if pool:
        base = rng.integers(-2**31, 2**31, (pool, shape[-1]), dtype=np.int64)
        return base[rng.integers(0, pool, shape[:-1])].astype(np.int32)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def hamming_bench(seed=9):
    """(queries [N, 8], database [M, 8], validity [M] with 1 in 5 rows
    invalid) at `HAMMING_BENCH`."""
    rng = np.random.default_rng(seed)
    N, M = HAMMING_BENCH
    qd, db = descriptors(rng, (N, 8)), descriptors(rng, (M, 8))
    return qd, db, rng.random(M) >= 0.2


def closure_match(F, cap, written, eligible, seed, pool=200):
    """One keyframe and the store it is matched against, as the system
    builds them: (q [F, 8], q_valid [F], store [cap, F, 8], store_valid
    [cap, F]). The first `written` keyframes hold descriptors drawn from a
    pool of `pool` rows (ties occur), 1 in 10 invalid; the rest are zero;
    `store_valid` is masked to the first `eligible`, as the forward match
    takes it. The reverse match takes the store as the queries and
    `q_valid`."""
    rng = np.random.default_rng(seed)
    q, qv = descriptors(rng, (F, 8), pool), rng.random(F) >= 0.1
    store = np.zeros((cap, F, 8), np.int32)
    store[:written] = descriptors(rng, (written, F, 8), pool)
    sv = np.zeros((cap, F), bool)
    sv[:written] = rng.random((written, F)) >= 0.1
    sv &= (np.arange(cap) < eligible)[:, None]
    return q, qv, store, sv


def drive_observations(world, t, Z, W, seed, pixel_noise=(0.75, 0.75, 0.5), max_depth=60.0):
    """One frame of stereo observations [Z, 3] of a drive world at its
    ground-truth pose t: the Z nearest landmarks in view, projected through
    the stereo_3d model with pixel noise. Each landmark carries a fixed
    W-word descriptor, observed with three bits flipped. Returns (z float32,
    desc uint32 [Z, W], valid [Z]); rows past the visible count are invalid.
    """
    rng = np.random.default_rng(seed * 100003 + t)
    table = np.random.default_rng(world.seed + 1000).integers(
        0, 2**32, (len(world.landmarks), W), dtype=np.uint32)
    fx, fy, cx, cy = world.intrinsics
    H, W_img = world.image_size
    par = tuple(zip(PAR_KEYS, (fx, fy, cx, cy, world.baseline, float(W_img), float(H))))
    p, zw = project_np("stereo_3d", world.gt_pose[t].astype(np.float64), world.landmarks, par)
    vis = np.flatnonzero((p[:, 2] > 1.0) & (p[:, 2] < max_depth) & (zw[:, 0] >= 0)
                         & (zw[:, 0] < W_img) & (zw[:, 1] >= 0) & (zw[:, 1] < H))
    pick = vis[np.argsort(p[vis, 2], kind="stable")][:Z]
    n = len(pick)
    z = np.zeros((Z, 3), np.float32)
    desc = np.zeros((Z, W), np.uint32)
    z[:n] = zw[pick] + rng.normal(size=(n, 3)) * np.asarray(pixel_noise)
    desc[:n] = flip_bits(rng, table[pick], 3)
    return z, desc, np.arange(Z) < n


def panoramic_observations(world, t, Z, W, seed, pixel_noise=(0.75, 0.75), min_range=1.0):
    """One frame of equirect observations [Z, 2] of a panoramic world at its
    ground-truth pose t (as `drive_observations` does for the drive world):
    the Z nearest landmarks beyond `min_range` (an equirect camera sees every
    direction), projected through the equirect_3d model of the world's image
    size with pixel noise. Each landmark carries a fixed W-word descriptor,
    observed with three bits flipped. Returns (z float32, desc uint32
    [Z, W], valid [Z]); rows past the visible count are invalid."""
    rng = np.random.default_rng(seed * 100003 + t)
    table = np.random.default_rng(world.seed + 1000).integers(
        0, 2**32, (len(world.landmarks), W), dtype=np.uint32)
    H, W_img = world.image_size
    par = tuple(zip(PAR_KEYS, (1.0, 1.0, 0.0, 0.0, 0.0, float(W_img), float(H))))
    p, zw = project_np("equirect_3d", world.gt_pose[t].astype(np.float64), world.landmarks, par)
    dist = np.linalg.norm(p, axis=1)
    vis = np.flatnonzero(dist > min_range)
    pick = vis[np.argsort(dist[vis], kind="stable")][:Z]
    n = len(pick)
    z = np.zeros((Z, 2), np.float32)
    desc = np.zeros((Z, W), np.uint32)
    z[:n] = zw[pick] + rng.normal(size=(n, 2)) * np.asarray(pixel_noise)
    z[:n, 0] = np.mod(z[:n, 0], W_img)  # the azimuth wraps round the image
    desc[:n] = flip_bits(rng, table[pick], 3)
    return z, desc, np.arange(Z) < n


def schur_blocks(N, seed=0):
    """The reference's Schur kernel-bench operands (eval/bench_kernels.py,
    bench_schur), drawn with numpy: N symmetric positive definite blocks
    C = A A^T + 0.5 I [N, 3, 3] and vectors u [N, 3], float32."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(N, 3, 3)).astype(np.float32)
    C = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(3, dtype=np.float32)
    return C.astype(np.float32), rng.normal(size=(N, 3)).astype(np.float32)


# The bundle-adjustment bench's pinhole camera: fx, fy, cx, cy, width, height.
BA_BENCH_CAMERA = (458.0, 457.0, 367.0, 248.0, 752, 480)


def ba_bench_problem(C=64, Pts=50000, obs_per_cam=2000, seed=0, noise_px=0.5):
    """The reference's bundle-adjustment bench problem (eval/bench_kernels.py,
    bench_ba), drawn with numpy: C cameras along x from 0 to 5 m facing +z,
    Pts points uniform in +-10 m around (0, 0, 15), `obs_per_cam` random
    points per camera, their pinhole projections with `noise_px` of pixel
    noise. Returns the BAProblem fields cam_pose, points, obs_cam, obs_pt and
    obs_uv as arrays (every mask defaults to valid, camera 0 fixed)."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = BA_BENCH_CAMERA[:4]
    pts = rng.uniform(-10.0, 10.0, (Pts, 3)) + np.array([0.0, 0.0, 15.0])
    poses = np.zeros((C, 7))
    poses[:, 6] = 1.0
    poses[:, 0] = np.linspace(0.0, 5.0, C)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), obs_per_cam)
    obs_pt = rng.integers(0, Pts, C * obs_per_cam).astype(np.int32)
    q = pts[obs_pt] - poses[obs_cam, :3]                  # identity rotations
    z = np.maximum(q[:, 2], 1e-3)
    uv = np.stack([fx * q[:, 0] / z + cx, fy * q[:, 1] / z + cy], axis=1)
    uv = uv + noise_px * rng.normal(size=uv.shape)
    f32 = np.float32
    return dict(cam_pose=poses.astype(f32), points=pts.astype(f32), obs_cam=obs_cam,
                obs_pt=obs_pt, obs_uv=uv.astype(f32))


# The well-posed bundle-adjustment problem's pinhole camera.
RING_BA_CAMERA = (500.0, 500.0, 320.0, 240.0, 640, 480)


def _quat_of_matrix(R):
    """Unit quaternion (x, y, z, w) of a rotation matrix [3, 3], float64."""
    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * np.sqrt(1.0 + tr)
        q = [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, s / 4]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = [0.0, 0.0, 0.0, (R[k, j] - R[j, k]) / s]
        q[i], q[j], q[k] = s / 4, (R[j, i] + R[i, j]) / s, (R[k, i] + R[i, k]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def _quat_mul(a, b):
    (ax, ay, az, aw), (bx, by, bz, bw) = a, b
    return np.array([aw * bx + ax * bw + ay * bz - az * by, aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw, aw * bw - ax * bx - ay * by - az * bz])


def ring_ba_problem(C=32, Pts=4000, seed=11, noise_px=0.5):
    """A well-posed bundle-adjustment problem in the layout of the reference's
    backend test problem (`_make_ba_problem` of its BA tests), drawn with
    numpy: C cameras on a circle of radius 4 m at height 0.5 m looking at
    the origin, Pts points uniform in +-1.5 m, each observed by every camera
    that has it more than 0.5 m in front and inside the 640x480 image, with
    `noise_px` of pixel noise. Every point is seen by many cameras. The first
    two cameras are fixed at the truth (the monocular gauge, scale included),
    the others start 0.1 m and 0.03 rad off, the points 0.1 m off. Returns
    (the BAProblem fields as arrays with `cam_fixed`, the true poses [C, 7])."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, W, H = RING_BA_CAMERA
    th = np.linspace(0.0, 2 * np.pi, C, endpoint=False)
    gt = np.zeros((C, 7))
    Rs = []
    for c, t in enumerate(th):
        pos = np.array([4.0 * np.cos(t), 4.0 * np.sin(t), 0.5])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)  # columns: camera axes
        Rs.append(R)
        gt[c, :3], gt[c, 3:] = pos, _quat_of_matrix(R)
    pts = rng.uniform(-1.5, 1.5, (Pts, 3))
    obs_cam, obs_pt, obs_uv = [], [], []
    for c in range(C):
        q = (pts - gt[c, :3]) @ Rs[c]  # camera-frame points
        z = np.maximum(q[:, 2], 1e-6)
        uv = np.stack([fx * q[:, 0] / z + cx, fy * q[:, 1] / z + cy], axis=1)
        vis = np.where((q[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
                       & (uv[:, 1] < H))[0]
        obs_cam.append(np.full(len(vis), c))
        obs_pt.append(vis)
        obs_uv.append(uv[vis])
    obs_uv = np.concatenate(obs_uv)
    obs_uv = obs_uv + noise_px * rng.normal(size=obs_uv.shape)
    init = gt.copy()
    for c in range(2, C):
        w = 0.03 * rng.normal(size=3)
        a = np.linalg.norm(w)
        dq = np.concatenate([np.sin(a / 2) * w / a, [np.cos(a / 2)]])
        init[c, :3] += 0.1 * rng.normal(size=3)
        init[c, 3:] = _quat_mul(gt[c, 3:], dq)
    cam_fixed = np.zeros(C, bool)
    cam_fixed[:2] = True
    f32 = np.float32
    points = pts + 0.1 * rng.normal(size=pts.shape)
    return dict(cam_pose=init.astype(f32), points=points.astype(f32),
                obs_cam=np.concatenate(obs_cam).astype(np.int32),
                obs_pt=np.concatenate(obs_pt).astype(np.int32), obs_uv=obs_uv.astype(f32),
                cam_fixed=cam_fixed), gt.astype(f32)
