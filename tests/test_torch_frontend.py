"""The port's vision frontend and synthetic image worlds against the JAX
package: the camera models, FAST/Harris detection with max-pool NMS and the
top-k keypoint order, BRIEF description (plain and oriented), the BRIEF
pattern, and the desk, drive and panoramic renders, plus the TUM writer
and loader.

Tolerances: keypoint coordinates, order and validity equal; descriptor
words equal, except that a bit may differ where the two smoothed samples
it compares are within 1e-6 of each other (float summation order; the test
checks that no such bit differs on these inputs); score maps and smoothed
images within 1e-6; camera maps within 1e-4 relative; renders within 1e-5
(float32 geometry in another order moves blob centres by ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FrontendConfig
from parakeet_slam_tpu.data import panoramic as j_pano
from parakeet_slam_tpu.data import synth_vision as j_sv
from parakeet_slam_tpu.frontend import camera as j_cam
from parakeet_slam_tpu.frontend import describe as j_desc
from parakeet_slam_tpu.frontend import detect as j_det
from parakeet_slam_tpu_torch.data import panoramic as t_pano
from parakeet_slam_tpu_torch.data import synth_vision as t_sv
from parakeet_slam_tpu_torch.frontend import camera as t_cam
from parakeet_slam_tpu_torch.frontend import describe as t_desc
from parakeet_slam_tpu_torch.frontend import detect as t_det


def _square_grid(H=96, W=96, sq=10, pitch=24):
    img = np.zeros((H, W), np.float32)
    for y0 in range(12, H - sq, pitch):
        for x0 in range(12, W - sq, pitch):
            img[y0:y0 + sq, x0:x0 + sq] = 1.0
    return img


def _small_desk(n_steps=4):
    s = 160 / 640
    kw = dict(num_landmarks=200, num_steps=n_steps, image_size=(120, 160),
              intrinsics=(517.3 * s, 516.5 * s, 318.6 * s, 255.3 * s), seed=20)
    return t_sv.make_desk_world(**kw), j_sv.make_desk_world(**kw)


def _small_pano(n_steps=3):
    kw = dict(num_landmarks=120, num_steps=n_steps, image_size=(64, 128), seed=11)
    return t_pano.make_panoramic_world(**kw), j_pano.make_panoramic_world(**kw)


@pytest.fixture(scope="module")
def images():
    desk, _ = _small_desk()
    pano, _ = _small_pano()
    seam = np.zeros((64, 64), np.float32)
    seam[20:36, :8] = 1.0  # a bright square across the x = 0 / 63 seam
    seam[20:36, 56:] = 1.0
    return {
        "grid": (_square_grid(), False),
        "desk": (desk.render(1), False),
        "pano": (pano.render(0), True),
        "seam": (seam, True),
    }


# -- cameras ----------------------------------------------------------------


def _cams():
    return [
        (t_cam.Pinhole(500.0, 490.0, 320.0, 240.0, 640, 480),
         j_cam.Pinhole(500.0, 490.0, 320.0, 240.0, 640, 480)),
        (t_cam.Stereo(700.0, 700.0, 600.0, 180.0, 0.54, 1241, 376),
         j_cam.Stereo(700.0, 700.0, 600.0, 180.0, 0.54, 1241, 376)),
        (t_cam.Equirect(256, 128), j_cam.Equirect(256, 128)),
    ]


@pytest.mark.parametrize("i", [0, 1, 2], ids=["pinhole", "stereo", "equirect"])
def test_camera_models_match_jax(i):
    tc, jc = _cams()[i]
    rng = np.random.default_rng(i)
    p = np.concatenate([rng.uniform(-3, 3, (50, 2)), rng.uniform(0.5, 20, (50, 1))], 1)
    p = p.astype(np.float32)
    close = dict(rtol=1e-4, atol=1e-4)
    uv = tc.project(torch.as_tensor(p))
    np.testing.assert_allclose(uv.numpy(), np.asarray(jc.project(jnp.asarray(p))), **close)
    np.testing.assert_allclose(tc.jac_project(torch.as_tensor(p)).numpy(),
                               np.asarray(jc.jac_project(jnp.asarray(p))), **close)
    np.testing.assert_array_equal(tc.in_image(uv, 2.0).numpy(),
                                  np.asarray(jc.in_image(jnp.asarray(uv.numpy()), 2.0)))
    if isinstance(tc, t_cam.Stereo):
        back = tc.unproject(uv)
        ref = jc.unproject(jnp.asarray(uv.numpy()))
    else:
        depth = np.linalg.norm(p, axis=1) if isinstance(tc, t_cam.Equirect) else p[:, 2]
        back = tc.unproject(uv, torch.as_tensor(depth))
        ref = jc.unproject(jnp.asarray(uv.numpy()), jnp.asarray(depth))
    np.testing.assert_allclose(back.numpy(), np.asarray(ref), **close)
    np.testing.assert_allclose(back.numpy(), p, rtol=1e-3, atol=1e-3)
    if isinstance(tc, t_cam.Equirect):
        a, b = uv.numpy(), uv.numpy() + np.array([250.0, 1.0], np.float32)
        np.testing.assert_allclose(
            tc.residual(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
            np.asarray(jc.residual(jnp.asarray(a), jnp.asarray(b))), atol=1e-4)


@pytest.mark.parametrize("camera", ["pinhole", "stereo", "equirect"])
def test_camera_from_config_matches_jax(camera):
    fe = FrontendConfig(camera=camera, baseline=0.3, image_size=(100, 200))
    assert t_cam.from_config(fe).__dict__ == j_cam.from_config(fe).__dict__
    with pytest.raises(KeyError):
        t_cam.from_config(FrontendConfig(camera="fisheye"))


# -- detection ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["grid", "desk", "pano", "seam"])
def test_fast_score_and_nms_match_jax(images, name):
    img, wrap = images[name]
    thr = 0.3 if name in ("grid", "seam") else 0.08
    got = t_det.fast_score(torch.as_tensor(img), thr, wrap_x=wrap)
    ref = np.asarray(j_det.fast_score(jnp.asarray(img), thr, wrap_x=wrap))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    kept = t_det.nms(got, 4, wrap_x=wrap).numpy()
    np.testing.assert_array_equal(kept > 0, np.asarray(j_det.nms(jnp.asarray(ref), 4, wrap_x=wrap)) > 0)


@pytest.mark.parametrize("name", ["grid", "desk", "pano", "seam"])
@pytest.mark.parametrize("detector", ["fast", "harris"])
def test_detect_matches_jax(images, name, detector):
    img, wrap = images[name]
    thr = 0.3 if name in ("grid", "seam") else 0.08
    K = 64
    xy, score, valid = t_det.detect(torch.as_tensor(img), max_features=K, detector=detector,
                                    threshold=thr, wrap_x=wrap)
    j_xy, j_score, j_valid = j_det.detect(jnp.asarray(img), max_features=K, detector=detector,
                                          threshold=thr, wrap_x=wrap)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(xy.numpy(), np.asarray(j_xy))  # keypoints and their order
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=1e-5, atol=1e-6)
    if detector == "fast" and name != "seam":
        assert int(valid.sum()) >= 9


def test_detect_seam_needs_wrap(images):
    img, _ = images["seam"]
    n = []
    for wrap in (True, False):
        xy, _, v = t_det.detect(torch.as_tensor(img), max_features=32, threshold=0.3, wrap_x=wrap)
        j_xy, _, j_v = j_det.detect(jnp.asarray(img), max_features=32, threshold=0.3, wrap_x=wrap)
        np.testing.assert_array_equal(xy.numpy(), np.asarray(j_xy))
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_v))
        n.append(int(v.sum()))
    assert n[0] >= n[1] > 0  # the reference's own bound


def test_top_k_keeps_the_lower_index_on_ties():
    x = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, 0.0])
    vals, idx = t_det.top_k_stable(x, 4)
    assert idx.tolist() == [1, 2, 4, 3] and vals.tolist() == [3.0, 3.0, 3.0, 2.0]


# -- description --------------------------------------------------------------


def test_pattern_equals_the_reference():
    np.testing.assert_array_equal(t_desc._DEFAULT_PATTERN, j_desc._DEFAULT_PATTERN)
    np.testing.assert_array_equal(t_desc.make_pattern(8, seed=3), j_desc.make_pattern(8, seed=3))


@pytest.mark.parametrize("name", ["grid", "desk", "pano"])
def test_smooth_matches_jax(images, name):
    img, _ = images[name]
    np.testing.assert_allclose(t_desc.smooth(torch.as_tensor(img)).numpy(),
                               np.asarray(j_desc.smooth(jnp.asarray(img))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["grid", "desk", "pano"])
@pytest.mark.parametrize("oriented", [False, True])
def test_describe_matches_jax(images, name, oriented):
    img, wrap = images[name]
    j_xy, _, j_valid = j_det.detect(jnp.asarray(img), max_features=48, threshold=0.08,
                                    wrap_x=wrap)
    xy, valid = torch.as_tensor(np.asarray(j_xy)), torch.as_tensor(np.asarray(j_valid))
    got = t_desc.describe(torch.as_tensor(img), xy, valid, oriented=oriented, wrap_x=wrap)
    ref = np.asarray(j_desc.describe(jnp.asarray(img), j_xy, j_valid, oriented=oriented,
                                     wrap_x=wrap))
    assert got.dtype == torch.int32
    # equal words; a differing bit would have to compare two smoothed
    # samples within an ulp of each other, and none does here
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    assert (got[~valid] == 0).all()
    if int(valid.sum()) >= 2:
        assert len({tuple(r) for r in got[valid].tolist()}) > 1  # discriminative


# -- synthetic worlds ------------------------------------------------------------


def test_desk_world_and_render_match_jax():
    tw, jw = _small_desk()
    np.testing.assert_array_equal(tw.landmarks, jw.landmarks)
    np.testing.assert_allclose(tw.gt_pose, jw.gt_pose, atol=1e-6)
    np.testing.assert_allclose(tw.odom, jw.odom, atol=1e-5)
    for i in (0, 3):
        np.testing.assert_allclose(tw.render(i), jw.render(i), atol=1e-5)
    assert tw.render(0).max() > 0.5


def test_drive_world_render_stereo_matches_jax():
    s = 320 / 1241
    kw = dict(num_landmarks=800, num_steps=3, image_size=(96, 320),
              intrinsics=(718.856 * s, 718.856 * s, 607.19 * s, 185.22 * s),
              baseline=0.5372, seed=21)
    tw, jw = t_sv.make_drive_world(**kw), j_sv.make_drive_world(**kw)
    for a, b in zip(tw.render_stereo(1), jw.render_stereo(1)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_panoramic_world_and_render_match_jax():
    tw, jw = _small_pano()
    np.testing.assert_array_equal(tw.landmarks, jw.landmarks)
    np.testing.assert_allclose(tw.gt_pose, jw.gt_pose, atol=1e-6)
    np.testing.assert_allclose(tw.odom, jw.odom, atol=1e-5)
    np.testing.assert_allclose(tw.render(2), jw.render(2), atol=1e-5)


def test_tum_writer_round_trips_through_the_loader(tmp_path):
    pytest.importorskip("cv2")
    from parakeet_slam_tpu_torch.data.tum import load_tum

    tw, _ = _small_desk(3)
    t_sv.write_tum_format(tw, str(tmp_path))
    seq = load_tum(str(tmp_path))
    assert len(seq) == 3
    np.testing.assert_allclose(seq.gt_pose[:, :3], tw.gt_pose[:, :3], atol=1e-5)
    np.testing.assert_allclose(seq.image(1), tw.render(1), atol=1.0 / 255 + 1e-6)
