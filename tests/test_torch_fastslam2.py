"""The port's vision filter as a whole against the JAX package: FastSLAM 1.0
and 2.0 runs on the synthetic drive world with JAX's own per-frame draws
injected, the FastSLAM 2.0 corridor (sequential association), the drive
world itself, the SE(3) pose estimate, the KITTI preset, the kernel bench
rows and the rule that the port imports no jax.

The JAX runs take the XLA path (use_pallas=False; FastSLAM 2.0 with
fs2_association="hoisted", the semantics of the reference's fused route).
Masks and counts must be equal; estimates agree to atol=1e-4, log_w to
rtol=1e-4 + atol=1e-3 (sums of many terms in another order)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import load_config as j_load_config
from parakeet_slam_tpu.data import make_corridor
from parakeet_slam_tpu.data.synth_vision import make_drive_world as j_make_drive_world
from parakeet_slam_tpu.filter import run_sequence as j_run_sequence
from parakeet_slam_tpu.filter.fastslam2 import make_filter as j_make_filter
from parakeet_slam_tpu_torch import cli
from parakeet_slam_tpu_torch.core.config import load_config
from parakeet_slam_tpu_torch.core.state import state_from_numpy
from parakeet_slam_tpu_torch.data import make_drive_world
from parakeet_slam_tpu_torch.eval.kernel_inputs import drive_observations, project_np
from parakeet_slam_tpu_torch.filter import FastSLAM, FastSLAM2, make_filter, run_sequence
from parakeet_slam_tpu_torch.kernels import ekf_update_3d, propose_3d, resample_cuda

KITTI = "configs/kitti_00.yaml"
FRAMES, P, Z = 3, 16, 32
UNSHAPED = {"filter.weight_min_count": 0, "filter.weight_only_matched": False,
            "filter.assoc_gate_px": 0.0}


def _jax_draws(key, T, P, dim):
    """run_sequence's draws: keys = split(key, T); per frame k1, k2 =
    split(keys[t]); normal(k1, (P, dim)) (motion or proposal);
    uniform(k2, (), 0, 1/P) (the resampling comb)."""
    noise, u0 = [], []
    for k in jax.random.split(key, T):
        k1, k2 = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k1, (P, dim))))
        u0.append(float(jax.random.uniform(k2, (), minval=0.0, maxval=1.0 / P)))
    return torch.as_tensor(np.stack(noise)), torch.tensor(u0, dtype=torch.float32)


def _drive_data(world, model):
    obs = [drive_observations(world, t, Z, 8, seed=0) for t in range(FRAMES)]
    z = np.stack([o[0] for o in obs])
    if model == "pinhole_3d":
        z = np.ascontiguousarray(z[..., :2])
    desc = np.stack([o[1] for o in obs])
    valid = np.stack([o[2] for o in obs])
    return world.odom[:FRAMES], z, desc, valid


def _vision_run_against_jax(algorithm, model, overrides):
    ov = {"filter.num_particles": P, "filter.max_landmarks": 256,
          "filter.max_observations": Z, "filter.algorithm": algorithm, **overrides}
    if model == "pinhole_3d":
        ov.update({"filter.measurement_model": model, "filter.obs_dim": 2,
                   "filter.meas_noise": [1.5, 1.5]})
    cfg = load_config(KITTI, ov)
    jcfg = j_load_config(KITTI, {**ov, "filter.use_pallas": False,
                                 "filter.fs2_association": "hoisted"})
    world = make_drive_world(num_steps=FRAMES + 1)
    odom, z, desc, valid = _drive_data(world, model)
    key = jax.random.PRNGKey(5)
    jslam = j_make_filter(jcfg.filter, jcfg.frontend)
    j_final, j_est, j_metrics = j_run_sequence(
        jslam, jslam.init_state(init_pose=jnp.asarray(world.gt_pose[0])), jnp.asarray(odom),
        jnp.asarray(z), jnp.zeros((FRAMES, Z, 0)), jnp.asarray(valid), key,
        obs_desc=jnp.asarray(desc),
    )
    slam = make_filter(cfg.filter, cfg.frontend)
    assert isinstance(slam, FastSLAM2 if algorithm == "fastslam2" else FastSLAM)
    noise, u0 = _jax_draws(key, FRAMES, P, 6)
    T = torch.as_tensor
    final, est, metrics = run_sequence(
        slam, slam.init_state(init_pose=world.gt_pose[0], device="cpu"), T(odom), T(z),
        torch.zeros(FRAMES, Z, 0), T(valid), motion_noise=noise, resample_u0=u0,
        obs_desc=T(desc.view(np.int32)),
    )
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), atol=1e-4)
    back = state_from_numpy(j_final, device="cpu")
    for k in ("lm_valid", "lm_count", "lm_desc"):
        assert torch.equal(getattr(final, k), getattr(back, k)), k
    vm = final.lm_valid
    np.testing.assert_allclose(final.lm_mean[vm].numpy(), back.lm_mean[vm].numpy(), atol=1e-3)
    np.testing.assert_allclose(final.log_w.numpy(), back.log_w.numpy(), rtol=1e-4, atol=1e-3)
    assert [m.resampled for m in metrics] == [bool(r) for r in np.asarray(j_metrics.resampled)]
    # frames re-observe mapped landmarks: the updates ran, not only inits
    assert float(metrics[-1].match_frac) > 0.5
    return final


@pytest.mark.parametrize(
    "algorithm,model,overrides",
    [
        ("fastslam1", "pinhole_3d", UNSHAPED),
        ("fastslam1", "stereo_3d", {}),
        ("fastslam2", "pinhole_3d", UNSHAPED),
        ("fastslam2", "stereo_3d", {}),
    ],
    ids=["fs1_pinhole_fused", "fs1_stereo_kitti_shaped", "fs2_pinhole_hoisted",
         "fs2_stereo_kitti"],
)
def test_vision_run_matches_jax_with_injected_draws(algorithm, model, overrides):
    _vision_run_against_jax(algorithm, model, overrides)


def test_fastslam2_corridor_sequential_matches_jax():
    from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
    from parakeet_slam_tpu_torch.core.config import FilterConfig

    kw = dict(num_particles=16, max_landmarks=64, max_observations=8, sig_dim=3,
              motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03), sig_noise=0.5,
              max_range=6.5, fov_half_angle=2.5, algorithm="fastslam2")
    sim = make_corridor(num_landmarks=30, num_steps=12, max_obs=8, seed=3)
    key = jax.random.PRNGKey(1)
    jslam = j_make_filter(JFilterConfig(**kw, use_pallas=False))
    j_final, j_est, _ = j_run_sequence(
        jslam, jslam.init_state(init_pose=jnp.asarray(sim.gt_pose[0])), jnp.asarray(sim.odom),
        jnp.asarray(sim.obs_z), jnp.asarray(sim.obs_sig), jnp.asarray(sim.obs_valid), key,
    )
    slam = make_filter(FilterConfig(**kw))
    assert not slam._hoist_association()
    noise, u0 = _jax_draws(key, 12, 16, 3)
    final, est, _ = run_sequence(slam, slam.init_state(init_pose=sim.gt_pose[0], device="cpu"),
                                 *cli.sim_tensors(sim, "cpu"), motion_noise=noise, resample_u0=u0)
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), atol=1e-4)
    np.testing.assert_array_equal(final.lm_valid.numpy(), np.asarray(j_final.lm_valid))
    np.testing.assert_allclose(final.log_w.numpy(), np.asarray(j_final.log_w), rtol=1e-4, atol=1e-3)


def test_filter_routes_through_the_3d_kernel_wrappers(monkeypatch):
    """The KITTI configuration calls score_3d and measurement_update_3d once
    per frame (the shaped split), the gather once per resample; its
    FastSLAM 2.0 calls propose_3d once a frame, FastSLAM 1.0 never, and
    neither does the corridor's sequential FastSLAM 2.0."""
    calls = {"score": 0, "update": 0, "gather": 0, "propose": 0}
    wrap = lambda name, fn: lambda *a, **k: (calls.__setitem__(name, calls[name] + 1), fn(*a, **k))[1]  # noqa: E731
    monkeypatch.setattr(ekf_update_3d, "score_3d", wrap("score", ekf_update_3d.score_3d))
    monkeypatch.setattr(ekf_update_3d, "measurement_update_3d",
                        wrap("update", ekf_update_3d.measurement_update_3d))
    monkeypatch.setattr(resample_cuda, "gather_state", wrap("gather", resample_cuda.gather_state))
    monkeypatch.setattr(propose_3d, "propose_3d", wrap("propose", propose_3d.propose_3d))
    for algorithm in ("fastslam2", "fastslam1"):
        calls.update(score=0, update=0, gather=0, propose=0)
        final = _vision_run_against_jax(algorithm, "stereo_3d", {})
        assert calls["score"] == calls["update"] == FRAMES, calls
        assert calls["propose"] == (FRAMES if algorithm == "fastslam2" else 0), calls
        assert final.lm_valid.any()
    calls.update(propose=0)
    test_fastslam2_corridor_sequential_matches_jax()
    assert calls["propose"] == 0, calls


def test_make_drive_world_matches_jax():
    kw = dict(num_landmarks=500, num_steps=40, seed=4)
    a, b = make_drive_world(**kw), j_make_drive_world(**kw)
    np.testing.assert_array_equal(a.landmarks, b.landmarks)
    np.testing.assert_allclose(a.gt_pose, b.gt_pose, atol=1e-6)
    np.testing.assert_allclose(a.odom, b.odom, atol=1e-6)
    assert (a.image_size, a.intrinsics, a.baseline) == (b.image_size, b.intrinsics, b.baseline)


def test_drive_observations_follow_the_stereo_model():
    world = make_drive_world(num_steps=5)
    z, desc, valid = drive_observations(world, 3, 128, 8, seed=1)
    assert z.shape == (128, 3) and desc.dtype == np.uint32 and valid.sum() == 128
    cfg = load_config(KITTI)
    slam = make_filter(cfg.filter, cfg.frontend)
    # every observation lies in the image, near the model's prediction of
    # some landmark
    fx, fy, cx, cy = world.intrinsics
    par = tuple(zip(("fx", "fy", "cx", "cy", "baseline", "img_w", "img_h"),
                    (fx, fy, cx, cy, world.baseline, 1241.0, 376.0)))
    _, zw = project_np("stereo_3d", world.gt_pose[3].astype(np.float64), world.landmarks, par)
    d = np.abs(z[:, None, :] - zw[None]).max(-1).min(-1)
    assert (d < 4.0).all()
    pose = torch.as_tensor(world.gt_pose[3])
    zhat = slam.model.h(pose, torch.as_tensor(world.landmarks[:10]))
    np.testing.assert_allclose(zhat.numpy(), zw[:10], rtol=1e-4, atol=1e-2)


def test_se3_estimate_pose_matches_jax():
    cfg = load_config(KITTI, {"filter.num_particles": 32, "filter.max_landmarks": 8})
    jcfg = j_load_config(KITTI, {"filter.num_particles": 32, "filter.max_landmarks": 8})
    slam, jslam = make_filter(cfg.filter, cfg.frontend), j_make_filter(jcfg.filter, jcfg.frontend)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(32, 4)) * [0.1, 0.1, 0.1, 1.0]
    q[::3] *= -1.0  # sign-flipped quaternions of the same rotation
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pose = np.concatenate([rng.normal(size=(32, 3)), q], 1).astype(np.float32)
    log_w = rng.normal(size=32).astype(np.float32)
    jst = jslam.init_state().replace(pose=jnp.asarray(pose), log_w=jnp.asarray(log_w))
    est = slam.estimate_pose(state_from_numpy(jst, device="cpu"))
    np.testing.assert_allclose(est.numpy(), np.asarray(jslam.estimate_pose(jst)), atol=1e-5)


def test_kitti_config_builds_the_fastslam2_stereo_filter():
    cfg = load_config(KITTI)
    slam = make_filter(cfg.filter, cfg.frontend)
    assert isinstance(slam, FastSLAM2) and slam.model.name == "stereo_3d"
    assert slam.vision and slam._hoist_association() and slam._weight_shaping
    assert (cfg.filter.num_particles, cfg.filter.max_landmarks, cfg.filter.max_observations,
            cfg.filter.desc_words) == (2048, 10240, 128, 8)
    assert slam.noise_dim == slam.tangent_dim == 6
    par = dict(slam._vision_kernel_params())
    assert par["baseline"] == pytest.approx(0.5372) and (par["img_w"], par["img_h"]) == (1241, 376)
    # log_p0 is shifted by the association gate (the reference's rule)
    assert slam._log_p0_assoc() < cfg.filter.new_landmark_loglik


@pytest.mark.parametrize("kernel", ["ekf_update_3d", "fs1_step", "fs2_step"])
def test_cli_bench_kernel_rows(capsys, kernel):
    cli.main(["bench", "--kernel", kernel, "--device", "cpu", "--shape", "8", "64", "8"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["kernel"] == kernel and row["device"] == "cpu" and row["ms"] > 0
    assert row["sol_bw_frac"] is None  # no device share from a CPU run
