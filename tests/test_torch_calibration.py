"""Twins of tests/test_calibration.py for the port (pinhole_3d, FastSLAM 1.0):
monocular landmark EKFs converge to the true 3-D positions under a known
pose; a converged landmark's innovation chi^2 averages ~Dz; the anchor
freeze holds converged lanes still over a run; and the generic path with
the freeze equals the 3-D kernel's twin over a run (the reference's
kernel-vs-XLA freeze parity), with the JAX package's XLA run beside it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.core.config import FrontendConfig as JFrontendConfig
from parakeet_slam_tpu.core.state import make_observation as j_make_observation
from parakeet_slam_tpu.filter import make_filter as j_make_filter
from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu_torch.core.state import make_observation, state_to_numpy
from parakeet_slam_tpu_torch.filter import make_filter

FX, FY, CX, CY = 100.0, 100.0, 80.0, 60.0
H_IMG, W_IMG = 120, 160


def _scene(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                     rng.uniform(1.5, 4.0, n)], 1).astype(np.float32)


def _cfg(**kw):
    base = dict(
        num_particles=4, max_landmarks=64, max_observations=40, lm_dim=3, obs_dim=2,
        pose_dim=7, measurement_model="pinhole_3d", motion_model="se3_odometry",
        motion_noise=(1e-6, 1e-6), meas_noise=(1.5, 1.5), init_range_prior=2.0,
        init_range_sigma=1.0, max_range=8.0, desc_words=0, new_landmark_loglik=-8.0,
    )
    base.update(kw)
    fe = dict(camera="pinhole", intrinsics=(FX, FY, CX, CY), image_size=(H_IMG, W_IMG))
    return FilterConfig(**base), FrontendConfig(**fe), base, fe


def _poses(frames, u):
    p = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=torch.float32)
    out = [p]
    for _ in range(frames):
        out.append(geometry.se3_compose(out[-1], geometry.se3_exp(torch.as_tensor(u))))
    return out


def _frame_obs(model, pw, lm, Z, rng, noise=1.0, shift=0.0, desc_world=None):
    """The visible landmarks' projections (first Z) with pixel noise."""
    T = torch.as_tensor(lm)
    uv = model.h(pw[None], T).numpy()
    vis = model.in_fov(pw[None], T).numpy()
    idx = np.where(vis)[0][:Z]
    z = np.zeros((Z, 2), np.float32)
    v = np.zeros(Z, bool)
    z[: len(idx)] = uv[idx] + rng.normal(0, noise, (len(idx), 2)) + shift
    v[: len(idx)] = True
    d = None
    if desc_world is not None:
        d = np.zeros((Z, desc_world.shape[1]), np.uint32)
        d[: len(idx)] = desc_world[idx]
    return z, v, d


def _run_known_pose(slam, lm, frames=70, seed=3):
    """Exact odometry and ~1e-6 motion noise along a sideways + yaw orbit:
    every particle rides the true pose."""
    rng = np.random.default_rng(seed)
    u = np.array([0.02, 0, 0, 0, -0.008, 0], np.float32)
    poses = _poses(frames, u)
    state = slam.init_state(device="cpu")
    g = torch.Generator().manual_seed(0)
    P, Z = slam.cfg.num_particles, slam.cfg.max_observations
    for t in range(frames):
        z, v, _ = _frame_obs(slam.model, poses[t + 1], lm, Z, rng)
        obs = make_observation(torch.as_tensor(z), valid=torch.as_tensor(v), device="cpu")
        state, _ = slam.step(state, torch.as_tensor(u), obs,
                             torch.randn(P, slam.noise_dim, generator=g),
                             torch.rand((), generator=g) / P)
    return state, poses


@pytest.fixture(scope="module")
def converged():
    lm = _scene()
    fc, fe, _, _ = _cfg()
    slam = make_filter(fc, fe)
    assert slam.kernel_3d
    state, poses = _run_known_pose(slam, lm)
    return lm, fc, slam, state, poses


def test_mono_depth_converges(converged):
    lm, _, _, state, _ = converged
    means, valid = state.lm_mean[0].numpy(), state.lm_valid[0].numpy()
    cnt = state.lm_count[0].numpy()
    live = np.where(valid & (cnt > 20))[0]
    assert len(live) >= 20
    err = np.linalg.norm(means[live][:, None, :] - lm[None], axis=-1).min(1)
    assert float(err.mean()) < 0.05, f"mean landmark error {err.mean()}"


def test_innovation_chi2_calibrated(converged):
    lm, fc, slam, state, poses = converged
    model = slam.model
    rng = np.random.default_rng(99)
    pw = poses[-1]
    means, covs = state.lm_mean[0], state.lm_cov[0].numpy()
    valid, cnt = state.lm_valid[0].numpy(), state.lm_count[0].numpy()
    R = np.diag(np.asarray(fc.meas_noise[:2]) ** 2)
    chi2 = []
    for j in np.where(valid & (cnt > 20))[0]:
        tgt = lm[np.linalg.norm(lm - means[j].numpy(), axis=1).argmin()]
        zt = model.h(pw, torch.as_tensor(tgt)).numpy()
        if not (0 <= zt[0] < W_IMG and 0 <= zt[1] < H_IMG):
            continue
        z = zt + rng.normal(0, 1.5, 2)
        nu = z - model.h(pw, means[j]).numpy()
        Hj = model.jac(pw, means[j]).numpy()
        Q = Hj @ covs[j] @ Hj.T + R
        chi2.append(float(nu @ np.linalg.solve(Q, nu)))
    chi2 = np.asarray(chi2)
    assert len(chi2) >= 15
    assert 0.8 < float(chi2.mean()) < 4.5, f"mean chi2 {chi2.mean()}"


def test_freeze_stops_mean_updates():
    lm = _scene()
    fc, fe, _, _ = _cfg(freeze_min_count=12)
    slam = make_filter(fc, fe)
    state, poses = _run_known_pose(slam, lm, frames=30)
    frozen_means = state.lm_mean[0].clone()
    cnt0 = state.lm_count[0].clone()
    # one more frame of observations shifted by 3 px: frozen lanes stay
    z, v, _ = _frame_obs(slam.model, poses[-1], lm, fc.max_observations,
                         np.random.default_rng(5), noise=0.0, shift=3.0)
    obs = make_observation(torch.as_tensor(z), valid=torch.as_tensor(v), device="cpu")
    P = fc.num_particles
    state, _ = slam.step(state, torch.zeros(6), obs, torch.zeros(P, 6), torch.tensor(0.1 / P))
    was_frozen = (cnt0 >= 12) & state.lm_valid[0]
    assert int(was_frozen.sum()) >= 10
    assert torch.equal(state.lm_mean[0][was_frozen], frozen_means[was_frozen])


def test_freeze_generic_matches_the_3d_twin_and_jax_over_a_run():
    """8 frames with freeze_min_count=6 and descriptors: every frame of the
    3-D kernel's twin and of the generic path (the same filter with its
    fused route off) from one state give equal masks and counts and means
    within rtol=atol=1e-5; the free-running generic run and the JAX
    package's XLA run are held to the fused run at the reference's own bar
    for this parity over a run (masks and counts equal, means within 1e-3:
    unobservable depths magnify rounding over frames)."""
    lm = _scene(seed=5)
    fc, fe, kw, fkw = _cfg(freeze_min_count=6, desc_words=8, desc_weight=0.5,
                           new_landmark_loglik=-30.0, num_particles=8)
    fused = make_filter(fc, fe)
    generic = make_filter(fc, fe)
    generic.kernel_3d = False  # the model-agnostic path on the same config
    jslam = j_make_filter(JFilterConfig(**kw, use_pallas=False), JFrontendConfig(**fkw))
    rng = np.random.default_rng(11)
    u = np.array([0.03, 0, 0, 0, -0.01, 0], np.float32)
    desc_world = rng.integers(0, 2**32, (len(lm), 8), dtype=np.uint64).astype(np.uint32)
    poses = _poses(8, u)
    st_f = fused.init_state(device="cpu")
    st_run = fused.init_state(device="cpu")
    st_j = jslam.init_state()
    key = jax.random.PRNGKey(0)
    P, Z = fc.num_particles, fc.max_observations
    for t in range(8):
        z, v, d = _frame_obs(fused.model, poses[t + 1], lm, Z, rng, noise=0.5,
                             desc_world=desc_world)
        key, k = jax.random.split(key)
        k_m, k_r = jax.random.split(k)
        noise = torch.as_tensor(np.asarray(jax.random.normal(k_m, (P, 6))))
        u0 = torch.tensor(float(jax.random.uniform(k_r, (), minval=0.0, maxval=1.0 / P)))
        obs = make_observation(torch.as_tensor(z), desc=torch.as_tensor(d.view(np.int32)),
                               valid=torch.as_tensor(v), device="cpu")
        st_g, _ = generic.step(st_f, torch.as_tensor(u), obs, noise, u0)
        st_f, _ = fused.step(st_f, torch.as_tensor(u), obs, noise, u0)
        st_run, _ = generic.step(st_run, torch.as_tensor(u), obs, noise, u0)
        jobs = j_make_observation(jnp.asarray(z), desc=jnp.asarray(d), valid=jnp.asarray(v))
        st_j, _ = jslam.step(st_j, jnp.asarray(u), jobs, k)
        for f in ("lm_valid", "lm_count", "lm_desc"):
            assert torch.equal(getattr(st_g, f), getattr(st_f, f)), (t, f)
        vm = st_f.lm_valid
        np.testing.assert_allclose(st_g.lm_mean[vm].numpy(), st_f.lm_mean[vm].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(st_g.lm_cov[vm].numpy(), st_f.lm_cov[vm].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(st_g.log_w.numpy(), st_f.log_w.numpy(), atol=1e-4)
    vm = st_f.lm_valid.numpy()
    for other in (state_to_numpy(st_run), st_j.__dict__):
        np.testing.assert_array_equal(np.asarray(other["lm_valid"]), vm)
        np.testing.assert_array_equal(np.asarray(other["lm_count"]), st_f.lm_count.numpy())
        np.testing.assert_allclose(np.asarray(other["lm_mean"])[vm], st_f.lm_mean.numpy()[vm],
                                   rtol=1e-3, atol=1e-3)
    assert bool((st_f.lm_count >= 6).any())  # the freeze engaged
