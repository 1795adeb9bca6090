"""The port's generic measurement path (`FastSLAM._measurement_generic`: the
reference's model-agnostic scoring, association, per-observation EKF update,
allocation and cull) against the JAX package's `measurement_core` with
use_pallas=False, on the same numpy inputs over two frames: bearing_2d,
range_bearing_2d with each option no fused kernel takes (anchor freeze,
weight shaping, a gate, descriptors, fed scores) and pinhole_3d with a float
signature. Then the generic path against the port's own fused twins from one
state, where both apply. The bar: masks, counts and n_match equal, floats
within rtol=atol=1e-5, log_w within atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.core.config import FrontendConfig as JFrontendConfig
from parakeet_slam_tpu.core.state import Observation as JObservation
from parakeet_slam_tpu.core.state import make_particle_state as j_make_state
from parakeet_slam_tpu.filter import FastSLAM as JFastSLAM
from parakeet_slam_tpu_torch.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu_torch.core.state import Observation, state_from_numpy, state_to_numpy
from parakeet_slam_tpu_torch.eval.kernel_inputs import (
    CAMERAS, prefilled_frame, prefilled_frame_3d,
)
from parakeet_slam_tpu_torch.filter import FastSLAM

P, L, Z = 8, 40, 8
FLOATS = ("lm_mean", "lm_cov", "lm_sig")
INTS = ("lm_valid", "lm_count", "lm_desc")

# (id, config overrides, weight_matched, fed scores)
CASES_2D = [
    ("bearing_2d", dict(measurement_model="bearing_2d", obs_dim=1, meas_noise=(0.03,),
                        init_range_prior=3.0, init_range_sigma=1.5, new_landmark_loglik=-3.0),
     True, False),
    ("bearing_2d_desc_no_weights", dict(measurement_model="bearing_2d", obs_dim=1,
                                        meas_noise=(0.03,), desc_words=2, desc_weight=0.02,
                                        new_landmark_loglik=-3.0), False, False),
    ("freeze", dict(freeze_min_count=2), True, False),
    ("weight_min_count", dict(weight_min_count=2), True, False),
    ("weight_only_matched", dict(weight_only_matched=True), True, False),
    ("assoc_gate", dict(assoc_gate_px=0.05), True, False),
    ("desc_words", dict(desc_words=2, desc_weight=0.02), True, False),
    ("fed_scores", dict(), True, True),
    ("fed_scores_no_weights_cull_unseen", dict(cull_unseen=True), False, True),
]


def _assert_state(got, want, what):
    for k in INTS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{what} {k}")
    for k in FLOATS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["log_w"], np.asarray(want["log_w"]), atol=1e-4,
                               err_msg=f"{what} log_w")


def _desc(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def _frames_2d(S, W, obs_dim, seed, frames=2):
    """The first frame's pre-filled state, and (pose, z, sig, desc, valid)
    of each frame; descriptors of re-observations are their lane's."""
    rng = np.random.default_rng(seed + 7)
    first = prefilled_frame(P, L, Z, S, seed)
    world_desc = _desc(rng, (L, W))
    first["lm_desc"] = np.broadcast_to(world_desc, (P, L, W)).copy()
    out, pose = [], first["pose"]
    for f in range(frames):
        fr = first if f == 0 else prefilled_frame(P, L, Z, S, seed + f)
        if f:
            pose = (pose + rng.normal(scale=0.02, size=pose.shape)).astype(np.float32)
        desc = _desc(rng, (Z, W))
        desc[: Z // 2] = world_desc[rng.integers(0, L, Z // 2)]
        out.append((pose, fr["z"][:, 2 - obs_dim:], fr["sig"], desc, fr["valid"]))
    return first, out


def _observations(z, sig, desc, valid):
    return (JObservation(z=jnp.asarray(z), sig=jnp.asarray(sig), desc=jnp.asarray(desc),
                         valid=jnp.asarray(valid)),
            Observation(z=torch.as_tensor(z), sig=torch.as_tensor(sig),
                        desc=torch.as_tensor(desc.view(np.int32)), valid=torch.as_tensor(valid)))


def _run(slam, jslam, j0, frames, weight_matched, fed, what):
    st_j, st_t = j0, state_from_numpy(j0, device="cpu")
    assert fed or not (slam.kernel_2d or slam.kernel_3d)  # the generic path
    for f, (pose, z, sig, desc, valid) in enumerate(frames):
        st_j = st_j.replace(pose=jnp.asarray(pose))
        st_t = st_t.replace(pose=torch.as_tensor(pose))
        jobs, tobs = _observations(z, sig, desc, valid)
        js = ts = None
        if fed:
            b, ll = (np.asarray(a) for a in jslam._score_frame(st_j, jobs))
            js, ts = (jnp.asarray(b), jnp.asarray(ll)), (torch.as_tensor(b), torch.as_tensor(ll))
        st_t, m_t = slam.measurement_core(st_t, tobs, weight_matched, scores=ts)
        st_j, m_j = jslam.measurement_core(st_j, jobs, weight_matched, scores=js)
        _assert_state(state_to_numpy(st_t), st_j.__dict__, f"{what} frame {f}")
        assert float(m_t) == float(m_j), (what, f)
    return st_t


@pytest.mark.parametrize("overrides,weight_matched,fed", [c[1:] for c in CASES_2D],
                         ids=[c[0] for c in CASES_2D])
def test_generic_2d_matches_jax_xla_path(overrides, weight_matched, fed):
    S, W = 3, overrides.get("desc_words", 0)
    kw = dict(num_particles=P, max_landmarks=L, max_observations=Z, sig_dim=S,
              meas_noise=(0.1, 0.03), sig_noise=0.5, max_range=6.5, fov_half_angle=2.5)
    kw.update(overrides)
    slam, jslam = FastSLAM(FilterConfig(**kw)), JFastSLAM(JFilterConfig(**kw, use_pallas=False))
    first, frames = _frames_2d(S, W, kw.get("obs_dim", 2), seed=len(str(overrides)))
    j0 = j_make_state(P, L, 2, S, W).replace(
        **{k: jnp.asarray(first[k]) for k in
           ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_valid", "lm_count", "lm_desc")})
    st = _run(slam, jslam, j0, frames, weight_matched, fed, str(overrides))
    assert (st.lm_valid & ~torch.as_tensor(first["lm_valid"])).any()  # it allocated


def _cfgs_3d(model, S, **overrides):
    Dz = 3 if model == "stereo_3d" else 2
    fx, fy, cx, cy, b, Wi, Hi = CAMERAS[model]
    kw = dict(num_particles=P, max_landmarks=L, max_observations=Z, lm_dim=3, obs_dim=Dz,
              pose_dim=7, sig_dim=S, desc_words=8, desc_weight=0.5, measurement_model=model,
              motion_model="se3_odometry", motion_noise=(0.02, 0.01),
              meas_noise=(2.0, 2.0, 1.0)[:Dz], sig_noise=0.3, new_landmark_loglik=-30.0,
              max_range=35.0, init_range_prior=8.0, init_range_sigma=3.0, **overrides)
    fe = dict(camera="stereo" if model == "stereo_3d" else "pinhole", baseline=b,
              intrinsics=(fx, fy, cx, cy), image_size=(int(Hi), int(Wi)))
    return (FilterConfig(**kw), FrontendConfig(**fe),
            JFilterConfig(**kw, use_pallas=False), JFrontendConfig(**fe))


def _frames_3d(model, S, seed, frames=2):
    rng = np.random.default_rng(seed)
    first = prefilled_frame_3d(P, L, Z, model, seed)
    first["lm_sig"] = rng.uniform(0, 1, (P, L, S)).astype(np.float32)
    out = []
    for f in range(frames):
        fr = first if f == 0 else prefilled_frame_3d(P, L, Z, model, seed + f)
        sig = rng.uniform(0, 1, (Z, S)).astype(np.float32)
        out.append((first["pose"], fr["z"], sig, fr["desc"], fr["valid"]))
    return first, out


@pytest.mark.parametrize("overrides", [{}, {"freeze_min_count": 3, "cull_unseen": True}],
                         ids=["plain", "freeze_cull_unseen"])
def test_generic_pinhole_with_signature_matches_jax(overrides):
    S = 3
    cfg, fe, jcfg, jfe = _cfgs_3d("pinhole_3d", S, **overrides)
    slam, jslam = FastSLAM(cfg, fe), JFastSLAM(jcfg, jfe)
    first, frames = _frames_3d("pinhole_3d", S, seed=21)
    j0 = j_make_state(P, L, 3, S, 8, 7).replace(
        **{k: jnp.asarray(first[k]) for k in
           ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_valid", "lm_count", "lm_desc")})
    _run(slam, jslam, j0, frames, True, False, "pinhole sig")


def _twin_vs_generic(slam, st, obs, weight_matched=True):
    """The fused route and the generic path from one state."""
    a, ma = slam.measurement_core(st, obs, weight_matched)
    b, mb = slam._measurement_generic(st, obs, weight_matched)
    _assert_state(state_to_numpy(b), state_to_numpy(a), "generic vs twin")
    assert float(ma) == float(mb)
    return a


def test_generic_matches_the_2d_twin_on_the_corridor():
    """The corridor's own frames (benchmark config 1's model) through the 2-D
    kernel's twin and the generic path, from the same state each frame."""
    from parakeet_slam_tpu_torch.data import make_corridor

    sim = make_corridor(num_landmarks=40, num_steps=12, max_obs=8, seed=3)
    cfg = FilterConfig(num_particles=P, max_landmarks=64, max_observations=8, sig_dim=3,
                       motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
                       max_range=6.5, fov_half_angle=2.5)
    slam = FastSLAM(cfg)
    assert slam.kernel_2d
    st = slam.init_state(init_pose=torch.as_tensor(sim.gt_pose[0]), device="cpu")
    g = torch.Generator().manual_seed(0)
    for t in range(12):
        st = slam.motion_update(st, torch.as_tensor(sim.odom[t]),
                                torch.randn(P, 3, generator=g))
        obs = Observation(z=torch.as_tensor(sim.obs_z[t]), sig=torch.as_tensor(sim.obs_sig[t]),
                          desc=torch.zeros(8, 0, dtype=torch.int32),
                          valid=torch.as_tensor(sim.obs_valid[t]))
        st = _twin_vs_generic(slam, st, obs)
    assert st.lm_valid.sum(dim=1).min() > 5


@pytest.mark.parametrize("freeze", [0, 3])
def test_generic_matches_the_3d_twin_with_and_without_freeze(freeze):
    """pinhole_3d without a signature, anchor freeze on and off: the 3-D
    kernel's twin and the generic path from one state, over two frames."""
    cfg, fe, _, _ = _cfgs_3d("pinhole_3d", 0, freeze_min_count=freeze)
    slam = FastSLAM(cfg, fe)
    assert slam.kernel_3d
    first, frames = _frames_3d("pinhole_3d", 0, seed=33)
    first["lm_sig"] = np.zeros((P, L, 0), np.float32)
    first["lm_desc"] = first["lm_desc"]
    j0 = j_make_state(P, L, 3, 0, 8, 7).replace(
        **{k: jnp.asarray(first[k]) for k in
           ("pose", "log_w", "lm_mean", "lm_cov", "lm_valid", "lm_count", "lm_desc")})
    st = state_from_numpy(j0, device="cpu")
    frozen0 = None
    for pose, z, sig, desc, valid in frames:
        _, tobs = _observations(z, sig[:, :0], desc, valid)
        if freeze:
            frozen0 = (st.lm_count >= freeze) & st.lm_valid
            mean0 = st.lm_mean.clone()
        st2 = _twin_vs_generic(slam, st, tobs)
        if freeze:  # a frozen anchor's mean does not move
            keep = frozen0 & st2.lm_valid
            assert torch.equal(st2.lm_mean[keep], mean0[keep])
        st = st2
