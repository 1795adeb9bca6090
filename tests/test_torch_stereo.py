"""The port's stereo system (benchmark config 3's frontend) against the JAX
package on the same numpy inputs: `keypoint_disparity`, the image pyramid,
`SLAMSystem.process_stereo_frame` under JAX's own draws, the KITTI writer and
loader, the ground-truth conversion, and `cli synth --kind kitti` + `cli run`
on a KITTI directory.

Tolerances: disparity within 1e-5 where the best shift is the same; the SAD
sums run in another order than XLA's, so a keypoint whose two smallest SADs
lie within a relative gap of 1e-6 may take the other shift, and such
near-ties are counted and printed (none is expected on these inputs). The
pyramid's 2x2 average within 1e-6; keypoints, levels and masks equal.

Two stereo runs under JAX's own per-frame draws. Config 3's path (FastSLAM
2.0, stereo_3d, the KITTI preset shrunk) on the shrunk drive world for 10
frames against the JAX system's fused route (use_pallas=True, the Pallas
kernels in interpret mode), which is the route the port's kernels and twins
follow: estimates within 1e-4, landmark counts and keyframe frames equal.
The reference's own stereo fixture (tests/test_system_stereo.py: FastSLAM
1.0 on the pinhole panoramic world) against the JAX system's XLA route:
estimates within 1e-3 and landmark counts equal over the first 2 frames, and
the reference's bounds on all 10. From frame 2 no two routes agree, and a
witness test shows why: on lanes behind the camera (depth clamped to 0.1 m)
det Q cancels in float32 and flips sign where float64 keeps it positive, in
JAX's XLA route and in the port alike but on different lanes; a flipped lane
scores +7.66 against a new landmark's -14 (-27.6 in float64) and absorbs the
observation. The float32 routes (XLA, the port) then stall at 26 landmarks a
particle, while the Pallas kernel and the port's update in float64 grow the
map."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parakeet_slam_tpu import cli as j_cli
from parakeet_slam_tpu.core import config as jcm
from parakeet_slam_tpu.data import synth_vision as j_sv
from parakeet_slam_tpu.data.kitti import load_kitti as j_load_kitti
from parakeet_slam_tpu.data.panoramic import make_panoramic_world as j_make_panoramic_world
from parakeet_slam_tpu.frontend import pyramid as j_pyramid
from parakeet_slam_tpu.frontend.stereo import keypoint_disparity as j_keypoint_disparity
from parakeet_slam_tpu.system import SLAMSystem as JSystem
from parakeet_slam_tpu_torch import cli, system
from parakeet_slam_tpu_torch.core import config as pcm
from parakeet_slam_tpu_torch.data import synth_vision as p_sv
from parakeet_slam_tpu_torch.data.kitti import _parse_calib, load_kitti
from parakeet_slam_tpu_torch.frontend import pyramid
from parakeet_slam_tpu_torch.frontend.stereo import keypoint_disparity, near_ties

TIE_GAP = 1e-6
STEREO_FRAMES = 10


def _small_drive(n_steps):
    """tests/test_synth_vision.py's shrunk drive world (96 x 320)."""
    s = 320 / 1241
    return p_sv.make_drive_world(
        num_landmarks=800, num_steps=n_steps, image_size=(96, 320),
        intrinsics=(718.856 * s, 718.856 * s, 607.19 * s, 185.22 * s),
        baseline=0.5372, seed=21,
    )


def _check_disparity(left, right, xy, valid, max_disp=64, patch=4):
    """The port's disparity and mask against JAX's; returns (keypoints
    valid, near-ties excused)."""
    j_d, j_ok = (np.asarray(a) for a in j_keypoint_disparity(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(xy), jnp.asarray(valid),
        max_disp=max_disp, patch=patch))
    p_d, p_ok = (a.numpy() for a in keypoint_disparity(
        torch.as_tensor(left), torch.as_tensor(right), torch.as_tensor(xy),
        torch.as_tensor(valid), max_disp=max_disp, patch=patch))
    same = (p_ok == j_ok) & (np.abs(p_d - j_d) <= 1e-5)
    ties = near_ties(left, right, xy, max_disp, patch, gap=TIE_GAP)
    assert (same | ties).all(), f"keypoints {np.where(~same)[0]} differ and are no near-ties"
    excused = int((~same).sum())
    print(f"disparity: {int(j_ok.sum())} of {len(xy)} valid, {int(ties.sum())} near-ties, "
          f"{excused} excused")
    return int(j_ok.sum()), excused


@pytest.mark.parametrize("seed,max_disp", [(0, 64), (1, 16), (2, 32)])
def test_disparity_matches_jax_on_random_images(seed, max_disp):
    rng = np.random.default_rng(seed)
    H, W, K = 48, 160, 64
    left = rng.uniform(0, 1, (H, W)).astype(np.float32)
    shift = rng.integers(0, max_disp, H)
    right = np.stack([np.roll(left[y], -shift[y]) for y in range(H)])
    right = (right + 0.02 * rng.normal(size=(H, W))).astype(np.float32)
    # keypoints everywhere, the image edges included, some off-integer
    xy = np.stack([rng.integers(-2, W + 2, K), rng.integers(-1, H + 1, K)], 1).astype(np.float32)
    xy[::5] += 0.5
    valid = rng.random(K) > 0.1
    n_valid, _ = _check_disparity(left, right, xy, valid, max_disp=max_disp)
    assert n_valid > 0


def test_disparity_matches_jax_on_a_drive_world_pair():
    world = _small_drive(3)
    from parakeet_slam_tpu_torch.frontend.detect import detect

    for t in range(3):
        left, right = world.render_stereo(t)
        xy, _, valid = detect(torch.as_tensor(left), max_features=96, threshold=0.08)
        n_valid, _ = _check_disparity(left, right, xy.numpy(), valid.numpy())
        assert n_valid > 0


def test_disparity_recovers_a_shift():
    """tests/test_utils.py's shifted-image case, on the port."""
    rng = np.random.default_rng(1)
    left = rng.uniform(0, 1, (48, 128)).astype(np.float32)
    right = np.roll(left, -7, axis=1)
    xy = torch.tensor([[60.0, 20.0], [80.0, 30.0], [100.0, 10.0]])
    disp, ok = keypoint_disparity(torch.as_tensor(left), torch.as_tensor(right), xy,
                                  torch.ones(3, dtype=torch.bool), max_disp=32)
    assert ok.all()
    np.testing.assert_allclose(disp.numpy(), 7.0, atol=0.5)


@pytest.mark.parametrize("shape", [(64, 96), (47, 81)])
def test_downsample2_matches_jax(shape):
    img = np.random.default_rng(shape[1]).uniform(0, 1, shape).astype(np.float32)
    got = pyramid.downsample2(torch.as_tensor(img)).numpy()
    want = np.asarray(j_pyramid.downsample2(jnp.asarray(img)))
    assert got.shape == want.shape == (shape[0] // 2, shape[1] // 2)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("levels,max_features,nms", [(3, 96, 4), (2, 64, 2), (4, 40, 8)])
def test_detect_pyramid_matches_jax(levels, max_features, nms):
    world = _small_drive(1)
    img = world.render(0)
    kw = dict(levels=levels, max_features=max_features, threshold=0.08, nms_radius=nms)
    p_xy, p_s, p_l, p_v = pyramid.detect_pyramid(torch.as_tensor(img), **kw)
    j_xy, j_s, j_l, j_v = (np.asarray(a) for a in j_pyramid.detect_pyramid(jnp.asarray(img), **kw))
    assert p_xy.shape == (max_features, 2) and p_l.dtype == torch.int32
    np.testing.assert_array_equal(p_v.numpy(), j_v)
    np.testing.assert_array_equal(p_l.numpy(), j_l)
    np.testing.assert_array_equal(p_xy.numpy()[j_v], j_xy[j_v])
    np.testing.assert_allclose(p_s.numpy(), j_s, atol=1e-6)
    assert int(j_v.sum()) > 0


def test_pyramid_frontend_runs():
    """frontend.pyramid_levels > 1 routes the system's detection through
    detect_pyramid, as the reference's does."""
    from tests.test_torch_system import _pano_cfg

    world = j_make_panoramic_world(num_landmarks=120, num_steps=2, image_size=(128, 256),
                                   seed=11)
    img = world.render(0)
    p_sys = system.SLAMSystem(_pano_cfg(pcm, pyramid_levels=2), device="cpu")
    j_sys = JSystem(_pano_cfg(jcm, pyramid_levels=2))
    p_xy, p_desc, p_valid = p_sys._frontend(torch.as_tensor(img))
    j_xy, j_desc, j_valid = (np.asarray(a) for a in j_sys._frontend(jnp.asarray(img)))
    np.testing.assert_array_equal(p_valid.numpy(), j_valid)
    np.testing.assert_array_equal(p_xy.numpy(), j_xy)
    np.testing.assert_array_equal(p_desc.numpy().view(np.uint32), j_desc)
    assert int(p_valid.sum()) >= 10
    assert torch.isfinite(p_sys.process_frame(img, world.odom[0])).all()


# -- the stereo system --------------------------------------------------------


def _stereo_cfg(cm, H=96, W=160, baseline=0.3):
    """tests/test_system_stereo.py's configuration, from either package."""
    fx = 0.6 * W
    return cm.SLAMConfig(
        filter=cm.FilterConfig(
            num_particles=16, max_landmarks=128, max_observations=16,
            lm_dim=3, obs_dim=3, pose_dim=7, sig_dim=0, desc_words=8,
            measurement_model="stereo_3d", motion_model="se3_odometry",
            motion_noise=(0.02, 0.01), meas_noise=(2.0, 2.0, 1.5),
            new_landmark_loglik=-14.0, max_range=45.0,
        ),
        frontend=cm.FrontendConfig(
            detector="fast", max_features=48, fast_threshold=0.12,
            camera="stereo", baseline=baseline,
            intrinsics=(fx, fx, W / 2, H / 2), image_size=(H, W),
        ),
        backend=cm.BackendConfig(max_keyframes=16, keyframe_translation=1.0),
    )


def _system_draws(seed, T, P, dim):
    """SLAMSystem's per-frame draws: k_step, key = split(key); then the
    filter step's k_motion, k_resample = split(k_step)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T):
        k_step, key = jax.random.split(key)
        k1, k2 = jax.random.split(k_step)
        out.append((np.asarray(jax.random.normal(k1, (P, dim))),
                    float(jax.random.uniform(k2, (), minval=0.0, maxval=1.0 / P))))
    return out


def _run_both(world, j_sys, p_sys, frames, P, stereo_args=()):
    """Both systems over `frames` stereo frames, the port under JAX's own
    draws: (JAX estimates, port estimates, JAX and port landmark counts
    [frames, P])."""
    draws = _system_draws(0, frames, P, p_sys.slam.noise_dim)
    j_est, p_est, j_lm, p_lm = [], [], [], []
    for t, (noise, u0) in enumerate(draws):
        left, right = world.render_stereo(t, *stereo_args)
        j_est.append(np.asarray(j_sys.process_stereo_frame(left, right, world.odom[t])))
        p_est.append(p_sys.process_stereo_frame(left, right, world.odom[t], motion_noise=noise,
                                                resample_u0=u0).numpy())
        j_lm.append(np.asarray(j_sys.state.lm_valid).sum(axis=1))
        p_lm.append(p_sys.state.lm_valid.sum(dim=1).numpy())
    for s in (j_sys, p_sys):
        s.flush_flags()
    return np.stack(j_est), np.stack(p_est), np.stack(j_lm), np.stack(p_lm)


def _kitti_small(cm, **filter_kw):
    """configs/kitti_00.yaml (FastSLAM 2.0, stereo_3d) at P=16, L=256, Z=32,
    64 features on the shrunk drive world's 96 x 320 images."""
    import dataclasses

    c = cm.load_config("configs/kitti_00.yaml")
    s = 320 / 1241
    return dataclasses.replace(
        c,
        filter=dataclasses.replace(c.filter, num_particles=16, max_landmarks=256,
                                   max_observations=32, **filter_kw),
        frontend=dataclasses.replace(c.frontend, max_features=64, image_size=(96, 320),
                                     intrinsics=(718.856 * s, 718.856 * s, 607.19 * s,
                                                 185.22 * s)),
    )


def test_kitti_config_stereo_frames_match_jax_fused_route():
    world = _small_drive(STEREO_FRAMES)
    j_sys = JSystem(_kitti_small(jcm, use_pallas=True))
    p_sys = system.SLAMSystem(_kitti_small(pcm), device="cpu")
    assert p_sys.cfg.filter.algorithm == "fastslam2"
    j_est, p_est, j_lm, p_lm = _run_both(world, j_sys, p_sys, STEREO_FRAMES, 16)
    np.testing.assert_allclose(p_est, j_est, atol=1e-4)
    np.testing.assert_array_equal(p_lm, j_lm)
    assert [k.frame for k in p_sys.keyframes] == [k.frame for k in j_sys.keyframes]
    assert p_lm[-1].mean() > 20


def _fixture_world():
    return j_make_panoramic_world(num_landmarks=80, num_steps=STEREO_FRAMES,
                                  image_size=(96, 160), camera="pinhole", radius=6.0, seed=13)


def _float64_update(*args, **kw):
    """The port's update twin run in float64 and returned in float32: the
    witness that tells the fixture's float32 rounding from a port fault."""
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d

    wide = [x.double() if torch.is_tensor(x) and x.is_floating_point() else x for x in args]
    out = ekf_update_3d.measurement_update_3d_reference(*wide, **kw)
    return tuple(x.float() if torch.is_tensor(x) and x.dtype == torch.float64 else x
                 for x in out)


def test_stereo_fixture_matches_jax_then_keeps_its_bounds(monkeypatch):
    """The fixture through four routes under JAX's draws: JAX's XLA route,
    JAX's Pallas kernel (interpret mode), the port, and the port with its
    update in float64. The port holds XLA for 2 frames and the reference's
    bounds for 10; from frame 2 every route parts (the cause: the next
    test), and the per-frame landmark counts are printed."""
    import dataclasses

    from parakeet_slam_tpu_torch.filter import fastslam as p_fastslam

    world = _fixture_world()
    j_cfg = _stereo_cfg(jcm)
    j_sys = JSystem(j_cfg)
    j_pal = JSystem(dataclasses.replace(j_cfg, filter=dataclasses.replace(j_cfg.filter,
                                                                          use_pallas=True)))
    p_sys = system.SLAMSystem(_stereo_cfg(pcm), device="cpu")
    p_f64 = system.SLAMSystem(_stereo_cfg(pcm), device="cpu")
    j_est, p_est, j_lm, p_lm = _run_both(world, j_sys, p_sys, STEREO_FRAMES, 16, (0.3,))
    pal_lm, f64_lm = [], []
    monkeypatch.setattr(p_fastslam.ekf_update_3d, "measurement_update_3d", _float64_update)
    for t, (noise, u0) in enumerate(_system_draws(0, STEREO_FRAMES, 16, p_f64.slam.noise_dim)):
        left, right = world.render_stereo(t, 0.3)
        j_pal.process_stereo_frame(left, right, world.odom[t])
        p_f64.process_stereo_frame(left, right, world.odom[t], motion_noise=noise,
                                   resample_u0=u0)
        pal_lm.append(np.asarray(j_pal.state.lm_valid).sum(axis=1))
        f64_lm.append(p_f64.state.lm_valid.sum(dim=1).numpy())
    for name, lm in (("JAX XLA", j_lm), ("JAX Pallas", pal_lm), ("port", p_lm),
                     ("port, float64 update", f64_lm)):
        print(f"stereo fixture landmarks a particle, {name}: "
              f"{[float(np.mean(n)) for n in lm]}")
    print(f"stereo fixture max |port - JAX XLA| a frame: "
          f"{np.abs(p_est - j_est).max(axis=1).tolist()}")
    np.testing.assert_allclose(p_est[:2], j_est[:2], atol=1e-3)
    np.testing.assert_array_equal(p_lm[:2], j_lm[:2])
    np.testing.assert_array_equal(f64_lm[:2], j_lm[:2])
    # the reference's bounds (tests/test_system_stereo.py), on the port's run
    assert np.isfinite(p_est).all()
    assert float(p_sys.state.lm_valid.sum(dim=1).float().mean()) >= 3
    from parakeet_slam_tpu_torch.core import geometry

    end = geometry.se3_compose(torch.as_tensor(world.gt_pose[0]), torch.as_tensor(p_est[-1]))
    assert np.linalg.norm(end[:3].numpy() - world.gt_pose[-1, :3]) < 2.0


def test_stereo_fixture_parts_where_float32_flips_det_q(monkeypatch):
    """Why the routes part at frame 2: on the map of frames 0-1 most lanes lie
    behind the camera, whose depth is clamped to 0.1 m, so their innovation
    covariance Q reaches ~1e14 and its cofactor determinant cancels. In
    float32 it flips sign on some of them where float64 keeps it positive, in
    the port's twin and in JAX's XLA route alike, on different lanes (the
    sums run in another order); such a lane scores log det = log 1e-12 with
    its Mahalanobis distance clamped to 0, above the new-landmark threshold,
    and absorbs the observation. No lane in front of the camera flips."""
    from parakeet_slam_tpu.core import linalg as j_linalg
    from parakeet_slam_tpu_torch.filter import fastslam as p_fastslam
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d as k3

    world = _fixture_world()
    p_sys = system.SLAMSystem(_stereo_cfg(pcm), device="cpu")
    calls = []
    update = k3.measurement_update_3d

    def record(*args, **kw):
        calls.append((args, kw))
        return update(*args, **kw)

    monkeypatch.setattr(p_fastslam.ekf_update_3d, "measurement_update_3d", record)
    for t, (noise, u0) in enumerate(_system_draws(0, 3, 16, p_sys.slam.noise_dim)):
        left, right = world.render_stereo(t, 0.3)
        p_sys.process_stereo_frame(left, right, world.odom[t], motion_noise=noise,
                                   resample_u0=u0)
    (pose, _, lm_mean, lm_cov, lm_desc, lm_valid, _, z, desc, valid), kw = (
        calls[2][0][:10], calls[2][1])
    c = k3.Consts(kw["model"], kw["par"], kw["r_var"], kw["desc_weight"])

    def det_q(dtype):
        cam = k3.camera_rows(pose.to(dtype))
        R, t = k3._cam(cam, lanes=True)
        m, S = k3._planes(lm_mean.to(dtype), lm_cov.to(dtype))
        p = k3._cam_point(R, t, m)
        _, H = k3._zhat_jac(c, R, p)
        _, Q = k3._innovation_cov(H, S, c.r_var)
        return k3._inverse(Q, 3)[1].numpy(), p[2].numpy()

    det32, _ = det_q(torch.float32)
    det64, depth = det_q(torch.float64)
    # JAX's XLA route on the same float32 state: Q = H S H^T + R, inv3's det
    j_sys = JSystem(_stereo_cfg(jcm))

    def j_det(pose_p, m, S):
        return j_linalg.inv3(j_sys.slam._per_pair_stats(pose_p, m, S, jnp.asarray(z[0]))[1])[1]

    lanes = jax.vmap(j_det, in_axes=(None, 0, 0))
    det_j = np.stack([np.asarray(lanes(jnp.asarray(pose[i]), jnp.asarray(lm_mean[i]),
                                       jnp.asarray(lm_cov[i])))
                      for i in range(pose.shape[0])])
    v = lm_valid.numpy()
    behind = v & (depth < 0)
    flip_port = v & (det64 > 0) & (det32 <= 0)
    flip_jax = v & (det64 > 0) & (det_j <= 0)
    # a flipped lane outscores a new landmark in float32, and not in float64
    first = int(np.flatnonzero(valid.numpy())[0])

    def scores(dtype):
        geom = k3._lane_geometry(c, k3.camera_rows(pose.to(dtype)), lm_mean.to(dtype),
                                 lm_cov.to(dtype), c.r_var)
        return k3._pair_scores(c, geom, lm_desc, lm_valid, z[first].to(dtype), desc[first],
                               kw["desc_words"]).numpy()

    ll32, ll64 = scores(torch.float32)[flip_port], scores(torch.float64)[flip_port]
    print(f"frame 2: {int(v.sum())} valid lanes, {int(behind.sum())} behind the camera; "
          f"float64 det Q > 0 but float32 <= 0 on {int(flip_port.sum())} (port), "
          f"{int(flip_jax.sum())} (JAX XLA), {int((flip_port & flip_jax).sum())} (both); "
          f"float64 det Q <= 0 on {int((v & (det64 <= 0)).sum())}; float64 det Q of the "
          f"port's flipped lanes {det64[flip_port].min():.4g} to {det64[flip_port].max():.4g}; "
          f"their score of observation {first}: float32 {ll32.min():.3f} to {ll32.max():.3f}, "
          f"float64 {ll64.min():.3f} to {ll64.max():.3f} (new landmark {kw['log_p0']})")
    assert flip_port.any() and flip_jax.any()
    assert not (flip_port & ~behind).any() and not (flip_jax & ~behind).any()
    assert (ll32 > kw["log_p0"]).all() and (ll64 < kw["log_p0"]).all()


def test_stereo_frame_needs_obs_dim_3():
    from tests.test_torch_system import _pano_cfg

    p_sys = system.SLAMSystem(_pano_cfg(pcm), device="cpu")
    img = np.zeros((128, 256), np.float32)
    with pytest.raises(ValueError, match="obs_dim=3"):
        p_sys.process_stereo_frame(img, img, np.zeros(6, np.float32))


# -- KITTI on disk --------------------------------------------------------------


def test_kitti_writer_loads_back_in_both_loaders(tmp_path):
    world = _small_drive(4)
    seq_dir = p_sv.write_kitti_format(world, str(tmp_path / "port"), sequence="00")
    j_seq_dir = j_sv.write_kitti_format(j_sv.make_drive_world(
        num_landmarks=800, num_steps=4, image_size=(96, 320),
        intrinsics=tuple(world.intrinsics), baseline=0.5372, seed=21), str(tmp_path / "jax"))
    p_seq, j_seq, j_seq_jw = load_kitti(seq_dir), j_load_kitti(seq_dir), load_kitti(j_seq_dir)
    assert len(p_seq) == len(j_seq) == len(j_seq_jw) == 4
    for f in ("n_frames", "fx", "fy", "cx", "cy", "baseline"):
        assert getattr(p_seq, f) == getattr(j_seq, f) == getattr(j_seq_jw, f), f
    np.testing.assert_array_equal(p_seq.timestamps, j_seq.timestamps)
    np.testing.assert_array_equal(p_seq.gt_pose, j_seq.gt_pose)
    np.testing.assert_allclose(p_seq.gt_pose, j_seq_jw.gt_pose, atol=1e-6)
    np.testing.assert_allclose(p_seq.gt_positions(), world.gt_pose[:, :3], atol=1e-5)
    for i in range(4):
        for right in (False, True):
            np.testing.assert_array_equal(p_seq.image(i, right), j_seq.image(i, right))
            np.testing.assert_array_equal(p_seq.image(i, right), j_seq_jw.image(i, right))
    for name in ("P0", "P1", "P2", "P3"):
        np.testing.assert_array_equal(_parse_calib(p_seq.root / "calib.txt")[name],
                                      _parse_calib(j_seq_jw.root / "calib.txt")[name])
    assert abs(p_seq.baseline - 0.5372) < 1e-6


def test_kitti_fixture(tmp_path):
    """tests/test_utils.py's hand-written KITTI directory."""
    import cv2

    root = tmp_path / "sequences" / "00"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir(parents=True)
    img = np.zeros((20, 40), np.uint8)
    for i in range(2):
        cv2.imwrite(str(root / "image_0" / f"{i:06d}.png"), img)
        cv2.imwrite(str(root / "image_1" / f"{i:06d}.png"), img)
    (root / "calib.txt").write_text("P0: 700.0 0 600.0 0 0 700.0 180.0 0 0 0 1 0\n"
                                    "P1: 700.0 0 600.0 -376.0 0 700.0 180.0 0 0 0 1 0\n")
    (tmp_path / "poses").mkdir()
    (tmp_path / "poses" / "00.txt").write_text("1 0 0 0 0 1 0 0 0 0 1 0\n"
                                               "1 0 0 1.5 0 1 0 0 0 0 1 0\n")
    seq = load_kitti(str(root))
    assert len(seq) == 2
    assert abs(seq.baseline - 376.0 / 700.0) < 1e-6
    np.testing.assert_allclose(seq.gt_positions()[1], [1.5, 0, 0])
    np.testing.assert_allclose(seq.timestamps, [0.0, 0.1])
    with pytest.raises(FileNotFoundError):
        seq.image(2)


def test_kitti_gt_to_quat_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(12, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    from parakeet_slam_tpu_torch.core import geometry

    R = geometry.quat_to_matrix(torch.as_tensor(q, dtype=torch.float32)).numpy()
    gt34 = np.concatenate([R, rng.normal(size=(12, 3, 1)).astype(np.float32)], axis=2)
    np.testing.assert_allclose(cli._kitti_gt_to_quat(gt34), j_cli._kitti_gt_to_quat(gt34),
                               atol=1e-6)


def test_cli_synth_and_run_kitti(tmp_path, capsys):
    """`synth --kind kitti` on an 8-frame shrunk world, then `run` on its
    sequence directory, stereo on the CPU (the same trajectory file and ATE
    line as the reference's command)."""
    out = tmp_path / "kitti"
    cli.main(["synth", "--kind", "kitti", "--out", str(out), "--steps", "8",
              "--landmarks", "3000"])
    assert "wrote kitti dataset: 8 frames, 3000 landmarks" in capsys.readouterr().out
    seq = load_kitti(str(out / "sequences" / "00"))
    assert len(seq) == 8 and seq.image(0).shape == (376, 1241)
    traj = tmp_path / "est.txt"
    cli.main(["run", "--config", "configs/kitti_00.yaml", "--device", "cpu",
              "--set", f"data.path={out / 'sequences' / '00'}", "filter.num_particles=16",
              "filter.max_landmarks=256", "filter.max_observations=32",
              "frontend.max_features=64", "--out", str(traj)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("frames=8 keyframes=") and "sim3=False" in line, line
    ate = float(line.split("ate_rmse=")[1].split()[0])
    assert np.isfinite(ate) and ate < 1.0, line
    rows = np.loadtxt(traj)
    assert rows.shape == (8, 8) and np.isfinite(rows).all()
