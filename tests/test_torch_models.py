"""Parity of the port's 2-D motion and measurement models with the JAX
model zoo; the odometry noise is JAX's own `jax.random.normal` draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.filter import models as jmodels
from parakeet_slam_tpu_torch.core.config import FilterConfig
from parakeet_slam_tpu_torch.filter import models as tmodels

CFG = dict(meas_noise=(0.1, 0.03), max_range=6.5, fov_half_angle=2.5, init_cov_inflation=1.5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_odometry_matches_jax_with_jax_noise(seed):
    P = 64
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    pose = rng.normal(size=(P, 3)).astype(np.float32)
    u = np.array([0.3, -0.05, 0.2 * (seed - 1)], np.float32)
    alphas = (0.3, 0.1, 0.3, 0.1)
    ref = jmodels.sample_odometry_2d(key, jnp.asarray(pose), jnp.asarray(u), alphas)
    noise = np.array(jax.random.normal(key, (P, 3)))
    got = tmodels.sample_odometry_2d(
        torch.as_tensor(pose), torch.as_tensor(u), alphas, torch.as_tensor(noise)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_range_bearing_matches_jax():
    jm = jmodels.get_measurement_model(JFilterConfig(**CFG))
    tm = tmodels.get_measurement_model(FilterConfig(**CFG))
    rng = np.random.default_rng(4)
    N = 300
    pose = (rng.normal(size=(N, 3)) * [2, 2, 2]).astype(np.float32)
    lm = (pose[:, :2] + rng.uniform(-8, 8, size=(N, 2))).astype(np.float32)
    z = np.stack([rng.uniform(0.5, 6, N), rng.uniform(-3, 3, N)], 1).astype(np.float32)
    T = torch.as_tensor
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.h(T(pose), T(lm)).numpy(), jax.vmap(jm.h)(pose, lm), **tol)
    np.testing.assert_allclose(tm.jac(T(pose), T(lm)).numpy(), jax.vmap(jm.jac)(pose, lm), **tol)
    zhat = np.array(jax.vmap(jm.h)(pose, lm))
    np.testing.assert_allclose(
        tm.residual(T(z), T(zhat)).numpy(), jax.vmap(jm.residual)(z, zhat), **tol
    )
    mean_t, cov_t = tm.init(T(pose), T(z))
    mean_j, cov_j = jax.vmap(jm.init)(pose, z)
    np.testing.assert_allclose(mean_t.numpy(), mean_j, **tol)
    # R enters as float32(sigma^2) here and float32(sigma)^2 there: 1 ulp
    np.testing.assert_allclose(cov_t.numpy(), cov_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tm.in_fov(T(pose), T(lm)).numpy(), np.asarray(jax.vmap(jm.in_fov)(pose, lm))
    )


def test_registries_hold_the_2d_entries_only():
    """The registries hold the ported entries; the 2-D entries the port has
    not ported (velocity_2d, bearing_2d) still raise."""
    assert tmodels.get_motion_model("odometry_2d") is tmodels.sample_odometry_2d
    assert tmodels.get_motion_model("se3_odometry") is tmodels.sample_se3_odometry
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.get_motion_model("velocity_2d")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.get_measurement_model(FilterConfig(measurement_model="bearing_2d"))
    for name in ("range_bearing_2d", "pinhole_3d", "stereo_3d", "equirect_3d"):
        assert tmodels.get_measurement_model(FilterConfig(measurement_model=name)).name == name
