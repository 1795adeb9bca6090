"""Parity of the port's vision models and SE(3) motion with the JAX model
zoo: pinhole_3d, stereo_3d and equirect_3d (h, jac, residual, init, in_fov),
sample_se3_odometry with JAX's own normals, the FastSLAM 2.0 Gaussian
motion (`_se3_odometry_mean_cov`, jacfwd on both sides) and the pose
Jacobians (closed form here, `jax.jacfwd` there).

Tolerances: rtol=atol=1e-5 on measurements and Jacobians, relative to each
row's largest entry for the pose Jacobians and Jacobians wrt the landmark;
init covariances 5e-4 of the row's largest entry (the stereo triangulation
inverts an ill-conditioned H, and the batched inverses of the two packages
round differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.core.config import FrontendConfig as JFrontendConfig
from parakeet_slam_tpu.filter import fastslam2 as jfs2
from parakeet_slam_tpu.filter import models as jmodels
from parakeet_slam_tpu_torch.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu_torch.eval.kernel_inputs import CAMERAS
from parakeet_slam_tpu_torch.filter import fastslam2 as tfs2
from parakeet_slam_tpu_torch.filter import models as tmodels

MODELS = {"pinhole_3d": 2, "stereo_3d": 3, "equirect_3d": 2}
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(model):
    Dz = MODELS[model]
    fx, fy, cx, cy, b, W, H = CAMERAS[model]
    kw = dict(lm_dim=3, obs_dim=Dz, pose_dim=7, desc_words=8, measurement_model=model,
              motion_model="se3_odometry", motion_noise=(0.02, 0.003),
              meas_noise=(1.5, 1.5, 1.0)[:Dz], max_range=40.0, init_range_prior=6.0,
              init_range_sigma=2.0, init_cov_inflation=1.5)
    fe = dict(intrinsics=(fx, fy, cx, cy), baseline=b, image_size=(int(H), int(W)))
    return FilterConfig(**kw), FrontendConfig(**fe), JFilterConfig(**kw), JFrontendConfig(**fe)


def _poses_and_points(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pose = np.concatenate([rng.normal(size=(n, 3)), q], 1).astype(np.float32)
    lm = (pose[:, :3] + rng.normal(size=(n, 3)) * 10).astype(np.float32)
    return pose, lm


def _row_scaled_close(got, want, tol=1e-5):
    scale = np.abs(want).max(axis=-1, keepdims=True) + 1e-6
    assert (np.abs(got - want) / scale).max() < tol


@pytest.mark.parametrize("model", list(MODELS))
def test_vision_models_match_jax(model):
    tc, tfe, jc, jfe = _cfgs(model)
    tm, jm = tmodels.get_measurement_model(tc, tfe), jmodels.get_measurement_model(jc, jfe)
    assert (tm.name, tm.obs_dim, tm.lm_dim) == (jm.name, jm.obs_dim, jm.lm_dim)
    pose, lm = _poses_and_points(400, MODELS[model] + len(model))
    T = torch.as_tensor
    zhat = np.asarray(jax.vmap(jm.h)(pose, lm))
    np.testing.assert_allclose(tm.h(T(pose), T(lm)).numpy(), zhat, rtol=1e-5, atol=1e-3)
    _row_scaled_close(tm.jac(T(pose), T(lm)).numpy(), np.asarray(jax.vmap(jm.jac)(pose, lm)))
    # residuals of perturbed measurements: equirect wraps u to (-W/2, W/2]
    rng = np.random.default_rng(5)
    W = CAMERAS[model][5]
    z = (zhat + rng.normal(scale=3.0, size=zhat.shape)).astype(np.float32)
    if model == "equirect_3d":
        z[:, 0] = np.mod(z[:, 0] + rng.choice([0, W / 2], len(z)), W)
    zhat = np.array(zhat)
    np.testing.assert_allclose(tm.residual(T(z), T(zhat)).numpy(),
                               jax.vmap(jm.residual)(z, zhat), rtol=1e-5, atol=1e-3)
    mean_t, cov_t = tm.init(T(pose), T(z))
    mean_j, cov_j = jax.vmap(jm.init)(pose, z)
    np.testing.assert_allclose(mean_t.numpy(), mean_j, rtol=1e-5, atol=1e-4)
    _row_scaled_close(cov_t.numpy(), np.asarray(cov_j), tol=5e-4)
    np.testing.assert_array_equal(tm.in_fov(T(pose), T(lm)).numpy(),
                                  np.asarray(jax.vmap(jm.in_fov)(pose, lm)))


@pytest.mark.parametrize("model", list(MODELS) + ["range_bearing_2d"])
def test_pose_jacobian_matches_jax_jacfwd(model):
    if model == "range_bearing_2d":
        t_slam, j_slam = tfs2.FastSLAM2(FilterConfig()), jfs2.FastSLAM2(JFilterConfig())
        rng = np.random.default_rng(3)
        pose = rng.normal(size=(256, 3)).astype(np.float32)
        lm = (pose[:, :2] + rng.normal(size=(256, 2)) * 4).astype(np.float32)
    else:
        tc, tfe, jc, jfe = _cfgs(model)
        t_slam, j_slam = tfs2.FastSLAM2(tc, tfe), jfs2.FastSLAM2(jc, jfe)
        pose, lm = _poses_and_points(256, 9)  # includes points behind the camera
    want = np.asarray(jax.vmap(j_slam._pose_jacobian)(jnp.asarray(pose), jnp.asarray(lm)))
    got = t_slam._pose_jacobian(torch.as_tensor(pose), torch.as_tensor(lm)).numpy()
    assert got.shape == want.shape
    _row_scaled_close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_odometry_with_jax_noise_and_mean_cov(seed):
    P = 64
    key = jax.random.PRNGKey(seed)
    pose, _ = _poses_and_points(P, seed)
    u = np.array([0.3, -0.05, 1.0, 0.02, -0.01, 0.03 * seed], np.float32)
    sig = (0.022, 0.003)
    ref = jmodels.sample_se3_odometry(key, jnp.asarray(pose), jnp.asarray(u), sig)
    noise = np.array(jax.random.normal(key, (P, 6)))
    got = tmodels.sample_se3_odometry(torch.as_tensor(pose), torch.as_tensor(u), sig,
                                      torch.as_tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    mean_cov, retract, dt = tmodels.get_motion_mean_cov("se3_odometry")
    j_mean_cov, j_retract, _ = jmodels.get_motion_mean_cov("se3_odometry")
    assert dt == 6
    mean_t, cov_t = mean_cov(torch.as_tensor(pose), torch.as_tensor(u), sig)
    mean_j, cov_j = jax.vmap(lambda p: j_mean_cov(p, jnp.asarray(u), sig))(pose)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), **TOL)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-4, atol=1e-9)
    delta = np.random.default_rng(seed).normal(scale=0.1, size=(P, 6)).astype(np.float32)
    np.testing.assert_allclose(retract(mean_t, torch.as_tensor(delta)).numpy(),
                               j_retract(mean_j, delta), **TOL)


def test_odometry_2d_mean_cov_and_se2_retract():
    rng = np.random.default_rng(4)
    pose = rng.normal(size=(32, 3)).astype(np.float32)
    u = np.array([0.5, 0.1, 0.2], np.float32)
    alphas = (0.2, 0.05, 0.2, 0.05)
    mean_t, cov_t = tmodels._odometry_2d_mean_cov(torch.as_tensor(pose), torch.as_tensor(u), alphas)
    mean_j, cov_j = jax.vmap(lambda p: jmodels._odometry_2d_mean_cov(p, jnp.asarray(u), alphas))(pose)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), **TOL)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), **TOL)
    delta = (rng.normal(size=(32, 3)) * 2).astype(np.float32)
    np.testing.assert_allclose(tmodels.se2_retract(torch.as_tensor(pose), torch.as_tensor(delta)).numpy(),
                               jmodels.se2_retract(jnp.asarray(pose), jnp.asarray(delta)), **TOL)
