"""The port's bearing_2d measurement model and velocity_2d motion model
against the JAX model zoo (the velocity noise is JAX's own draw; the
closed-form bearing pose Jacobian against JAX's jacfwd through the
retraction), and FastSLAM 1.0 and 2.0 runs on them against JAX's
`run_sequence` with JAX's per-frame draws injected, in both FastSLAM 2.0
association modes. Masks and counts equal, floats within rtol=atol=1e-5,
log_w within atol 1e-4.

FastSLAM 2.0 samples its pose through the Cholesky factor of the proposal
covariance. velocity_2d's covariance is the rank-2 J M J^T plus the
reference's 1e-8 I, so at the corridor's speeds with alphas of 0.05 its
smallest pivot is 1e-8 under entries of ~5e-3: float32 resolves it to a few
per cent, and JAX's LAPACK and torch's factor such blocks up to 3e-5 apart
from the same input (measured on this suite's blocks). The FastSLAM 2.0
frames are therefore held at the standing bar at alphas of 1e-4, where the
pivot is well resolved, each frame from one state (over a whole run a tight
proposal magnifies last-bit pose differences in the weights). There the
bearing-only EKF, twice in one frame on a landmark whose covariance is still
the elongated range prior, rounds float32 to about 1.5e-5 of the float64
answer, JAX on one side and the port on the other; so a landmark float
outside the bar must lie no farther from the port's float64 replay of the
same step than JAX's does. The whole runs at alphas of 0.05 hold masks,
counts and resampling equal and the estimates within 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.data import make_corridor
from parakeet_slam_tpu.filter import models as jmodels
from parakeet_slam_tpu.filter import run_sequence as j_run_sequence
from parakeet_slam_tpu.filter.fastslam2 import make_filter as j_make_filter
from parakeet_slam_tpu_torch.core.config import FilterConfig
from parakeet_slam_tpu_torch.core.state import state_from_numpy
from parakeet_slam_tpu_torch.filter import make_filter, run_sequence
from parakeet_slam_tpu_torch.filter import models as tmodels

T = torch.as_tensor
ALPHAS = (0.3, 0.1, 0.3, 0.1)
BEARING = dict(measurement_model="bearing_2d", obs_dim=1, meas_noise=(0.03,),
               max_range=6.5, fov_half_angle=2.5, init_range_prior=3.0, init_range_sigma=1.5)


@pytest.mark.parametrize("u", [(0.5, 0.2, 0.1), (0.5, 1e-7, 0.1), (0.0, 0.3, 0.2)],
                         ids=["turning", "straight", "in_place"])
def test_velocity_2d_matches_jax(u):
    P = 64
    rng = np.random.default_rng(1)
    pose = rng.normal(size=(P, 3)).astype(np.float32)
    u = np.array(u, np.float32)
    key = jax.random.PRNGKey(3)
    ref = jmodels.sample_velocity_2d(key, jnp.asarray(pose), jnp.asarray(u), ALPHAS)
    noise = np.asarray(jax.random.normal(key, (P, 2)))
    got = tmodels.sample_velocity_2d(T(pose), T(u), ALPHAS, T(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    mj, cj = jax.vmap(lambda p: jmodels._velocity_2d_mean_cov(p, jnp.asarray(u), ALPHAS))(pose)
    mt, ct = tmodels.get_motion_mean_cov("velocity_2d")[0](T(pose), T(u), ALPHAS)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-9)
    assert tmodels.motion_noise_dim("velocity_2d") == 2


def test_bearing_2d_matches_jax():
    from parakeet_slam_tpu.core.config import FilterConfig as JF

    jm = jmodels.get_measurement_model(JF(**BEARING))
    tm = tmodels.get_measurement_model(FilterConfig(**BEARING))
    rng = np.random.default_rng(4)
    N = 300
    pose = (rng.normal(size=(N, 3)) * [2, 2, 2]).astype(np.float32)
    lm = (pose[:, :2] + rng.uniform(-8, 8, size=(N, 2))).astype(np.float32)
    z = rng.uniform(-3, 3, (N, 1)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-6)
    for f in ("h", "jac"):
        np.testing.assert_allclose(getattr(tm, f)(T(pose), T(lm)).numpy(),
                                   jax.vmap(getattr(jm, f))(pose, lm), **tol, err_msg=f)
    np.testing.assert_array_equal(tm.in_fov(T(pose), T(lm)).numpy(),
                                  np.asarray(jax.vmap(jm.in_fov)(pose, lm)))
    zhat = np.asarray(jax.vmap(jm.h)(pose, lm))
    np.testing.assert_allclose(tm.residual(T(z), T(zhat)).numpy(),
                               jax.vmap(jm.residual)(z, zhat), **tol)
    mt, ct = tm.init(T(pose), T(z))
    mj, cj = jax.vmap(jm.init)(pose, z)
    np.testing.assert_allclose(mt.numpy(), mj, **tol)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-5, atol=1e-5)
    # the closed-form pose Jacobian against jacfwd through the retraction
    pj = jax.vmap(lambda p, m: jax.jacfwd(
        lambda d: jm.h(jmodels.se2_retract(p, d), m))(jnp.zeros(3)))(pose, lm)
    np.testing.assert_allclose(tm.pose_jac(T(pose), T(lm)).numpy(), pj, **tol)


def _velocity_corridor(frames):
    """The corridor's observations as bearings, its odometry as [v, w, dt]."""
    sim = make_corridor(num_landmarks=30, num_steps=200, max_obs=8, seed=3)
    dt = 0.1
    odom = np.stack([sim.odom[:frames, 0] / dt, sim.odom[:frames, 2] / dt,
                     np.full(frames, dt)], 1)
    return sim, odom.astype(np.float32), np.ascontiguousarray(sim.obs_z[:frames, :, 1:2])


def _jax_draws(key, T_, P, dim):
    noise, u0 = [], []
    for k in jax.random.split(key, T_):
        k1, k2 = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k1, (P, dim))))
        u0.append(float(jax.random.uniform(k2, (), minval=0.0, maxval=1.0 / P)))
    return torch.as_tensor(np.stack(noise)), torch.tensor(u0, dtype=torch.float32)


def _run_cfg(algorithm, assoc, alpha, P=16):
    return dict(num_particles=P, max_landmarks=48, max_observations=8, sig_dim=3,
                motion_model="velocity_2d", motion_noise=(alpha, alpha / 5, alpha, alpha / 5),
                sig_noise=0.5, new_landmark_loglik=-3.0, algorithm=algorithm,
                fs2_association=assoc, **BEARING)


def _assert_states(got, want, what, witness=None):
    for k in ("lm_valid", "lm_count"):
        assert torch.equal(getattr(got, k), getattr(want, k)), (what, k)
    for k in ("lm_mean", "lm_cov", "lm_sig", "pose"):
        g, w = getattr(got, k).numpy(), getattr(want, k).numpy()
        if witness is not None and k != "pose":
            # outside the bar only where JAX is as far from float64
            f64 = getattr(witness, k).numpy()
            out = np.abs(g - w) > 1e-5 + 1e-5 * np.abs(w)
            assert (np.abs(g - f64)[out] <= np.abs(w - f64)[out] + 1e-6).all(), (what, k)
            g = np.where(out, w, g)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f"{what} {k}")
    np.testing.assert_allclose(got.log_w.numpy(), want.log_w.numpy(), atol=1e-4, err_msg=what)


@pytest.mark.parametrize("algorithm,assoc,alpha", [
    ("fastslam1", "auto", 0.05), ("fastslam2", "sequential", 0.05),
    ("fastslam2", "hoisted", 0.05)])
def test_bearing_velocity_run_matches_jax(algorithm, assoc, alpha):
    """The whole 5-frame run: FastSLAM 1.0 at the standing bar; FastSLAM 2.0
    at alphas of 0.05 with masks, counts and resampling equal and estimates
    within 1e-3 (the Cholesky of the module docstring)."""
    frames, P = 5, 16
    kw = _run_cfg(algorithm, assoc, alpha, P)
    sim, odom, z = _velocity_corridor(frames)
    key = jax.random.PRNGKey(2)
    jslam = j_make_filter(JFilterConfig(**kw, use_pallas=False))
    j_final, j_est, j_met = j_run_sequence(
        jslam, jslam.init_state(init_pose=jnp.asarray(sim.gt_pose[0])), jnp.asarray(odom),
        jnp.asarray(z), jnp.asarray(sim.obs_sig[:frames]), jnp.asarray(sim.obs_valid[:frames]),
        key)
    slam = make_filter(FilterConfig(**kw))
    assert not slam.kernel_2d and not slam.kernel_3d
    if algorithm == "fastslam2":
        assert slam._hoist_association() == (assoc == "hoisted")
    noise, u0 = _jax_draws(key, frames, P, slam.noise_dim)
    final, est, met = run_sequence(
        slam, slam.init_state(init_pose=sim.gt_pose[0], device="cpu"), T(odom), T(z),
        T(sim.obs_sig[:frames]), T(sim.obs_valid[:frames]), motion_noise=noise,
        resample_u0=u0)
    back = state_from_numpy(j_final, device="cpu")
    assert [m.resampled for m in met] == [bool(r) for r in np.asarray(j_met.resampled)]
    assert final.lm_valid.sum(dim=1).min() > 3  # it mapped
    if algorithm == "fastslam1":
        _assert_states(final, back, "run")
        np.testing.assert_allclose(est.numpy(), np.asarray(j_est), rtol=1e-5, atol=1e-5)
    else:
        for k in ("lm_valid", "lm_count"):
            assert torch.equal(getattr(final, k), getattr(back, k)), k
        np.testing.assert_allclose(est.numpy(), np.asarray(j_est), atol=1e-3)


@pytest.mark.parametrize("assoc", ["sequential", "hoisted"])
def test_fastslam2_bearing_velocity_steps_match_jax(assoc):
    """FastSLAM 2.0 at alphas of 1e-4 over 5 frames, JAX's step and the
    port's from one state each frame with JAX's draws: the standing bar
    after every frame, landmark floats with the float64 witness (module
    docstring)."""
    from parakeet_slam_tpu.core.state import Observation as JObservation
    from parakeet_slam_tpu_torch.core.state import Observation, state_to_numpy

    frames, P = 5, 16
    kw = _run_cfg("fastslam2", assoc, 1e-4, P)
    sim, odom, z = _velocity_corridor(frames)
    key = jax.random.PRNGKey(2)
    jslam = j_make_filter(JFilterConfig(**kw, use_pallas=False))
    slam = make_filter(FilterConfig(**kw))
    noise, u0 = _jax_draws(key, frames, P, slam.noise_dim)
    js = jslam.init_state(init_pose=jnp.asarray(sim.gt_pose[0]))
    ts = slam.init_state(init_pose=sim.gt_pose[0], device="cpu")
    for t, k in enumerate(jax.random.split(key, frames)):
        args = (z[t], sim.obs_sig[t], np.zeros((8, 0), np.uint32), sim.obs_valid[t])
        jobs = JObservation(*(jnp.asarray(a) for a in args))
        tobs = Observation(*(T(a.view(np.int32) if a.dtype == np.uint32 else a) for a in args))
        d64 = lambda st: st.replace(**{f: getattr(st, f).double()  # noqa: E731
                                       for f in ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig")})
        w64, _ = slam.step(d64(ts), T(odom[t]).double(), Observation(
            tobs.z.double(), tobs.sig.double(), tobs.desc, tobs.valid), noise[t].double(),
            u0[t].double())
        js, jm = jslam.step(js, jnp.asarray(odom[t]), jobs, k)
        ts, tm_ = slam.step(ts, T(odom[t]), tobs, noise[t], u0[t])
        want = state_from_numpy(js, device="cpu")
        _assert_states(ts, want, f"frame {t}", witness=w64)
        assert tm_.resampled == bool(jm.resampled)
        js = js.replace(**{f: jnp.asarray(v) for f, v in state_to_numpy(ts).items()})
    assert ts.lm_valid.sum(dim=1).min() > 3
