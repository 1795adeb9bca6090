"""The port's online monocular system against the JAX package: the batched
loop closure over the stacked keyframe store (planted closure, no false
closure, store growth), the closure verification (Horn consensus and the
reprojection refines), a panoramic-world run under JAX's own per-frame
draws, the reference's functional bounds on the whole run, the
corrected-trajectory re-anchoring, the metrics log, the CLI's TUM path and
the paths that are not ported.

The JAX system runs its XLA path (use_pallas=False, the config default).
Match tables, keyframe frames, closure lists and descriptors must be equal;
poses and points agree to atol=1e-4 (Horn/refine on noiseless or lightly
noisy correspondences) or 1e-3 (a 12-frame filter run; float sums in
another order)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu import cli as j_cli
from parakeet_slam_tpu.core import config as jcm
from parakeet_slam_tpu.core import geometry as j_geo
from parakeet_slam_tpu.data.panoramic import make_panoramic_world as j_make_panoramic_world
from parakeet_slam_tpu.system import Keyframe as JKeyframe
from parakeet_slam_tpu.system import SLAMSystem as JSystem
from parakeet_slam_tpu.system import _global_descriptor as j_global_descriptor
from parakeet_slam_tpu_torch import cli, system
from parakeet_slam_tpu_torch.core import config as pcm
from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.kernels import match

PANO_FRAMES = 24
PARITY_FRAMES = 12


def _pano_cfg(cm, **fe_kw):
    """tests/test_system.py's panoramic configuration, from either package."""
    return cm.SLAMConfig(
        filter=cm.FilterConfig(
            num_particles=32, max_landmarks=256, max_observations=24, lm_dim=3, obs_dim=2,
            pose_dim=7, sig_dim=0, desc_words=8, measurement_model="equirect_3d",
            motion_model="se3_odometry", motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0),
            init_range_prior=14.0, init_range_sigma=8.0, new_landmark_loglik=-14.0,
            max_range=45.0, desc_weight=0.05,
        ),
        frontend=cm.FrontendConfig(
            detector="fast", max_features=64, fast_threshold=0.12, nms_radius=4,
            camera="equirect", image_size=(128, 256), **fe_kw,
        ),
        backend=cm.BackendConfig(
            max_keyframes=32, keyframe_translation=1.0, keyframe_rotation=0.4, gn_iters=8,
        ),
    )


def _host_cfg(cm, camera="equirect", depth_sigma=0.0):
    """tests/test_system_host_paths.py's configuration (or its pinhole twin)."""
    fe = (dict(camera="equirect", image_size=(64, 128)) if camera == "equirect" else
          dict(camera="pinhole", image_size=(480, 640),
               intrinsics=(517.3, 516.5, 318.6, 255.3)))
    model = "equirect_3d" if camera == "equirect" else "pinhole_3d"
    return cm.SLAMConfig(
        filter=cm.FilterConfig(
            num_particles=8, max_landmarks=64, max_observations=16, lm_dim=3, obs_dim=2,
            pose_dim=7, sig_dim=0, desc_words=8, measurement_model=model,
            motion_model="se3_odometry", motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0),
        ),
        frontend=cm.FrontendConfig(max_features=32, **fe),
        backend=cm.BackendConfig(max_keyframes=32, max_landmarks=128, loop_inlier_radius=0.7,
                                 loop_refine_depth_sigma=depth_sigma),
    )


def _pair(**kw):
    """(JAX system, port system on the CPU) of one host-path configuration."""
    return JSystem(_host_cfg(jcm, **kw)), system.SLAMSystem(_host_cfg(pcm, **kw), device="cpu")


def _rand_pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.concatenate([rng.uniform(-3, 3, 3), q]).astype(np.float32)


def _add_keyframe(systems, index, pose, world_pts, desc):
    """Append one keyframe (keyframes every 25 frames, so older ones clear
    the loop_min_frame_gap gate) to both systems' stores."""
    pts_kf = np.asarray(jax.vmap(lambda p: j_geo.se3_apply_inverse(jnp.asarray(pose), p))(
        jnp.asarray(world_pts)), np.float32)
    j_sys, p_sys = systems
    valid = np.ones(len(desc), bool)
    for s, cls, d in ((j_sys, JKeyframe, desc), (p_sys, system.Keyframe, desc.view(np.int32))):
        kf = cls(index=index, pose=pose.copy(), points_kf=pts_kf.copy(), desc=d.copy(),
                 valid=valid, frame=index * 25)
        s.keyframes.append(kf)
        s._kf_store_append(kf)


def _same_pose(a, b, atol):
    """Poses [.., 7] equal up to the quaternion's sign."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a[..., :3], b[..., :3], atol=atol)
    sign = np.sign(np.sum(a[..., 3:] * b[..., 3:], axis=-1, keepdims=True))
    np.testing.assert_allclose(a[..., 3:], sign * b[..., 3:], atol=atol)


@pytest.mark.parametrize("planted", [True, False], ids=["planted_closure", "no_false_closure"])
def test_loop_closure_matches_jax(planted):
    """test_system_host_paths.py's planted-closure and distinct-maps cases,
    run by both systems on the same keyframes."""
    rng = np.random.default_rng(3 if planted else 4)
    systems = _pair()
    F, W = 32, 8
    shared_world = rng.uniform(-5, 5, (F, 3)).astype(np.float32)
    shared_desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)
    for i in range(5):
        pose = _rand_pose(rng)
        if planted and i == 1:
            world, desc = shared_world, shared_desc
        else:
            world = rng.uniform(-5, 5, (F, 3)).astype(np.float32)
            desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)
        _add_keyframe(systems, i, pose, world, desc)
    if planted:
        _add_keyframe(systems, 5, _rand_pose(rng), shared_world, shared_desc)
    j_sys, p_sys = systems
    # the match tables of the dispatch are equal
    p_sys._dispatch_loop_closure(p_sys.keyframes[-1])
    j_sys._dispatch_loop_closure(j_sys.keyframes[-1])
    (pk, pn, pf, pr), (jk, jn, jf, jr) = p_sys._closure_pending[0], j_sys._closure_pending[0]
    assert (pk, pn) == (jk, jn)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    need = p_sys._resolve_closures()
    assert need == j_sys._resolve_closures() == planted
    assert p_sys.loop_closures == j_sys.loop_closures == ([(1, 5)] if planted else [])
    assert p_sys.graph.n_edges == int(j_sys.graph.n_edges)
    if planted:
        e = p_sys.graph.n_edges - 1
        _same_pose(p_sys.graph.edge_rel[e].numpy(), np.asarray(j_sys.graph.edge_rel[e]), 1e-4)
        # the edge encodes Z = T_old^-1 T_kf (exact: noiseless points)
        expect = geometry.se3_between(torch.as_tensor(p_sys.keyframes[1].pose),
                                      torch.as_tensor(p_sys.keyframes[5].pose))
        np.testing.assert_allclose(p_sys.graph.edge_rel[e, :3].numpy(), expect[:3].numpy(),
                                   atol=1e-3)


def test_store_grows_past_initial_capacity():
    rng = np.random.default_rng(5)
    p_sys = system.SLAMSystem(_host_cfg(pcm), device="cpu")
    F, W = 32, 8
    for i in range(70):  # > the initial 64-keyframe capacity
        world = rng.uniform(-5, 5, (F, 3)).astype(np.float32)
        desc = rng.integers(0, 2**32, (F, W), dtype=np.uint32)
        _add_port_keyframe(p_sys, i, _rand_pose(rng), world, desc)
    assert p_sys._kf_desc_dev.shape == (128, F, W)
    np.testing.assert_array_equal(p_sys._kf_desc_dev[69].numpy(), p_sys.keyframes[69].desc)
    assert not p_sys._try_loop_closure(p_sys.keyframes[-1])
    # a rebuilt store equals the appended one
    desc_dev, valid_dev = p_sys._kf_desc_dev, p_sys._kf_valid_dev
    p_sys._rebuild_kf_store()
    assert torch.equal(desc_dev, p_sys._kf_desc_dev) and torch.equal(valid_dev, p_sys._kf_valid_dev)


def _add_port_keyframe(p_sys, index, pose, world_pts, desc):
    pts_kf = geometry.se3_apply_inverse(torch.as_tensor(pose), torch.as_tensor(world_pts))
    kf = system.Keyframe(index=index, pose=pose, points_kf=pts_kf.numpy(),
                         desc=desc.view(np.int32), valid=np.ones(len(desc), bool),
                         frame=index * 25)
    p_sys.keyframes.append(kf)
    p_sys._kf_store_append(kf)


def _correspondences(rng, camera, F=48, n=36, noise=0.0, outliers=0):
    """Closure correspondences: pa [F, 3] kf-frame points, pb = T(pa) in the
    old frame (+ noise, + outliers), the first n rows valid (padding after)."""
    if camera == "pinhole":
        pa = np.stack([rng.uniform(-1.5, 1.5, F), rng.uniform(-1, 1, F),
                       rng.uniform(2.0, 6.0, F)], axis=1)
    else:
        d = rng.normal(size=(F, 3))
        pa = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(4, 12, F)[:, None]
    q = np.concatenate([0.05 * rng.normal(size=3), [1.0]])
    rel = np.concatenate([rng.uniform(-0.3, 0.3, 3), q / np.linalg.norm(q)]).astype(np.float32)
    pb = np.asarray(jax.vmap(lambda p: j_geo.se3_apply(jnp.asarray(rel), p))(
        jnp.asarray(pa, jnp.float32)))
    pb = pb + noise * rng.normal(size=pb.shape)
    pb[:outliers] += rng.uniform(-3, 3, (outliers, 3))
    valid = np.arange(F) < n
    pa[~valid] = 0.0
    pb[~valid] = 0.0
    return pa.astype(np.float32), pb.astype(np.float32), valid, rel


@pytest.mark.parametrize("camera,depth_sigma", [("equirect", 0.0), ("pinhole", 0.0),
                                                ("pinhole", 0.3)],
                         ids=["equirect", "pinhole", "pinhole_depth_relaxed"])
def test_closure_verification_matches_jax(camera, depth_sigma):
    """Horn consensus, the reprojection refine (depth-relaxed with
    loop_refine_depth_sigma > 0) and their batched form against JAX."""
    rng = np.random.default_rng(17)
    j_sys, p_sys = _pair(camera=camera, depth_sigma=depth_sigma)
    cases = [_correspondences(rng, camera, noise=0.01, outliers=5),
             _correspondences(rng, camera, noise=0.0, outliers=0, n=20)]
    T = torch.as_tensor
    for pa, pb, valid, rel_true in cases:
        j_rel, j_n = j_sys._horn_consensus(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid))
        p_rel, p_n = p_sys._horn_consensus_impl(T(pa), T(pb), T(valid))
        assert int(p_n) == int(j_n)
        _same_pose(p_rel.numpy(), np.asarray(j_rel), 1e-4)
        _same_pose(p_rel.numpy(), rel_true, 0.05)
        refine = "_refine_rel_depth" if depth_sigma > 0 else "_refine_rel"
        j_ref = getattr(j_sys, refine)(j_rel, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid))
        p_ref = getattr(p_sys, refine + "_impl")(T(np.asarray(j_rel)), T(pa), T(pb), T(valid))
        _same_pose(p_ref.numpy(), np.asarray(j_ref), 1e-4)
    # the batched verification of a flush window equals the JAX vmap
    pa_b, pb_b, v_b = (np.stack([c[i] for c in cases]) for i in range(3))
    j_rels, j_ns = j_sys._verify_candidates(jnp.asarray(pa_b), jnp.asarray(pb_b),
                                            jnp.asarray(v_b))
    p_rels, p_ns = p_sys._verify_candidates(T(pa_b), T(pb_b), T(v_b))
    np.testing.assert_array_equal(p_ns.numpy(), np.asarray(j_ns))
    _same_pose(p_rels.numpy(), np.asarray(j_rels), 1e-4)


def test_global_descriptor_matches_jax():
    rng = np.random.default_rng(2)
    desc = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    valid = rng.random(40) > 0.3
    np.testing.assert_allclose(system._global_descriptor(desc.view(np.int32), valid),
                               j_global_descriptor(desc, valid), atol=1e-7)
    assert not system._global_descriptor(desc.view(np.int32), np.zeros(40, bool)).any()


# -- the panoramic world ----------------------------------------------------


@pytest.fixture(scope="module")
def pano():
    """tests/test_system.py's world, rendered once (the port's renders equal
    JAX's: tests/test_torch_frontend.py)."""
    world = j_make_panoramic_world(num_landmarks=120, num_steps=PANO_FRAMES,
                                   image_size=(128, 256), seed=11)
    return world, [world.render(t) for t in range(PANO_FRAMES)]


def _system_draws(seed, T, P, dim):
    """SLAMSystem's per-frame draws: k_step, key = split(key); then the
    filter step's k_motion, k_resample = split(k_step); normal(k_motion,
    (P, dim)) and uniform(k_resample, (), 0, 1/P)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T):
        k_step, key = jax.random.split(key)
        k1, k2 = jax.random.split(k_step)
        out.append((np.asarray(jax.random.normal(k1, (P, dim))),
                    float(jax.random.uniform(k2, (), minval=0.0, maxval=1.0 / P))))
    return out


def test_panoramic_run_matches_jax_under_its_draws(pano):
    world, images = pano
    j_sys = JSystem(_pano_cfg(jcm))
    p_sys = system.SLAMSystem(_pano_cfg(pcm), device="cpu")
    draws = _system_draws(0, PARITY_FRAMES, 32, p_sys.slam.noise_dim)
    j_est, p_est = [], []
    for t, (noise, u0) in enumerate(draws):
        j_est.append(np.asarray(j_sys.process_frame(images[t], world.odom[t])))
        p_est.append(p_sys.process_frame(images[t], world.odom[t], motion_noise=noise,
                                         resample_u0=u0).numpy())
    for s in (j_sys, p_sys):
        s.flush_flags()
    np.testing.assert_allclose(np.stack(p_est), np.stack(j_est), atol=1e-3)
    assert [k.frame for k in p_sys.keyframes] == [k.frame for k in j_sys.keyframes]
    assert len(p_sys.keyframes) >= 2
    assert p_sys.loop_closures == j_sys.loop_closures
    for pk, jk in zip(p_sys.keyframes, j_sys.keyframes):
        np.testing.assert_array_equal(pk.valid, jk.valid)
        np.testing.assert_array_equal(pk.desc, jk.desc.view(np.int32))
        np.testing.assert_allclose(pk.points_kf[pk.valid], jk.points_kf[jk.valid], atol=1e-3)
        _same_pose(pk.pose, jk.pose, 1e-3)
    n = p_sys.graph.n_edges
    assert n == int(j_sys.graph.n_edges)
    np.testing.assert_array_equal(p_sys.graph.edge_ij[:n].numpy(),
                                  np.asarray(j_sys.graph.edge_ij[:n]))
    np.testing.assert_allclose(p_sys.graph.edge_info[:n].numpy(),
                               np.asarray(j_sys.graph.edge_info[:n]), rtol=1e-6)


def test_panoramic_run_meets_the_reference_bounds(pano):
    """tests/test_system.py's functional bounds on the whole run: finite,
    >= 2 keyframes, end drift < 3.5 m."""
    world, images = pano
    p_sys = system.SLAMSystem(_pano_cfg(pcm), device="cpu")
    est = torch.stack([p_sys.process_frame(images[t], world.odom[t])
                       for t in range(PANO_FRAMES)]).numpy()
    p_sys.flush_flags()
    err = np.linalg.norm(est[:, :3] - world.gt_pose[:, :3], axis=1)
    assert np.isfinite(err).all()
    assert len(p_sys.keyframes) >= 2
    assert err[-1] < 3.5, err[-1]
    out = p_sys.corrected_trajectory(est)
    assert out.shape == est.shape and np.isfinite(out).all()


def test_corrected_trajectory_reanchors_segments(pano):
    """Frames before the first keyframe are unchanged; with pose == anchor
    the map is the identity; a perturbed keyframe pose moves its whole
    segment by the same left-correction."""
    world, images = pano
    p_sys = system.SLAMSystem(_pano_cfg(pcm), device="cpu")
    est = torch.stack([p_sys.process_frame(images[t], world.odom[t]) for t in range(8)]).numpy()
    p_sys.flush_flags()
    assert len(p_sys.keyframes) >= 1
    out = p_sys.corrected_trajectory(est, final_optimize=False)
    assert out.shape == est.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, est, atol=1e-5)
    kf = p_sys.keyframes[0]
    kf.pose = kf.pose.copy()
    kf.pose[:3] += np.array([1.0, -2.0, 0.5], np.float32)
    out2 = p_sys.corrected_trajectory(est, final_optimize=False)
    corr = geometry.se3_compose(torch.as_tensor(kf.pose),
                                geometry.se3_inverse(torch.as_tensor(kf.anchor)))
    exp = geometry.se3_compose(corr, torch.as_tensor(est)).numpy()
    frames = np.arange(1, 9)
    kf2 = p_sys.keyframes[1].frame if len(p_sys.keyframes) > 1 else 9
    seg0 = (frames >= kf.frame) & (frames < kf2)
    np.testing.assert_allclose(out2[seg0], exp[seg0], atol=1e-5)
    np.testing.assert_allclose(out2[~seg0 & (frames < kf.frame)], est[frames < kf.frame])


def test_process_obs_equals_process_frame(pano):
    """process_obs on the frontend's own observation gives process_frame's
    estimate, keyframe flags and snapshots under the same draws."""
    world, images = pano
    a = system.SLAMSystem(_pano_cfg(pcm), device="cpu")
    b = system.SLAMSystem(_pano_cfg(pcm), device="cpu")
    for t, (noise, u0) in enumerate(_system_draws(1, 3, 32, a.slam.noise_dim)):
        est_a = a.process_frame(images[t], world.odom[t], motion_noise=noise, resample_u0=u0)
        obs = b._to_observation(*b._frontend(torch.as_tensor(images[t])))
        est_b = b.process_obs(obs, world.odom[t], motion_noise=noise, resample_u0=u0)
        assert torch.equal(est_a, est_b)
    assert [k.frame for k in a.keyframes] == [k.frame for k in b.keyframes]
    for ka, kb in zip(a.keyframes, b.keyframes):
        np.testing.assert_array_equal(ka.points_kf, kb.points_kf)


def test_metrics_logged(tmp_path, pano):
    world, images = pano
    cfg = dataclasses.replace(_pano_cfg(pcm), metrics_path=str(tmp_path / "m.jsonl"))
    p_sys = system.SLAMSystem(cfg, device="cpu")
    for t in range(3):
        p_sys.process_frame(images[t], world.odom[t])
    p_sys.flush_metrics()
    p_sys.metrics.flush()
    lines = (tmp_path / "m.jsonl").read_text().strip().splitlines()
    assert len(lines) == 3
    rec = json.loads(lines[0])
    assert {"frame", "ess", "landmarks", "match_frac", "resampled", "keyframes"} <= set(rec)


# -- the CLI's TUM path -------------------------------------------------------


def test_odometry_and_dead_reckoning_match_jax():
    world = j_make_panoramic_world(num_landmarks=10, num_steps=20, seed=4)
    gt = world.gt_pose.copy()
    gt[7] = np.nan
    data = pcm.DataConfig(odom_source="gt", odom_noise=(0.01, 0.005), seed=3)
    odom = cli._make_odometry(data, gt, 20)
    np.testing.assert_allclose(odom, j_cli._make_odometry(data, gt, 20), atol=1e-6)
    np.testing.assert_allclose(cli._dead_reckoning(gt[0], odom),
                               j_cli._dead_reckoning(gt[0], odom), atol=1e-5)


def test_cli_synth_and_run_tum(tmp_path, capsys):
    out = tmp_path / "tum"
    cli.main(["synth", "--kind", "tum", "--out", str(out), "--steps", "10",
              "--landmarks", "300"])
    assert (out / "rgb.txt").exists() and len(list((out / "rgb").iterdir())) == 10
    traj = tmp_path / "traj.txt"
    cli.main(["run", "--config", "configs/tum_fr1_desk.yaml", "--device", "cpu",
              "--set", f"data.path={out}", "filter.num_particles=8",
              "filter.max_landmarks=64", "filter.max_observations=16",
              "frontend.max_features=24", "--frames", "6", "--out", str(traj)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("frames=6 keyframes=") and "ate_rmse=" in line, line
    rows = np.loadtxt(traj)
    assert rows.shape == (6, 8) and np.isfinite(rows).all()


# -- not ported ---------------------------------------------------------------


def test_unported_paths_raise(pano):
    world, images = pano
    p_sys = system.SLAMSystem(_pano_cfg(pcm, pyramid_levels=2), device="cpu")
    with pytest.raises(NotImplementedError, match="pyramid"):
        p_sys.process_frame(images[0], world.odom[0])
    p_sys = system.SLAMSystem(_pano_cfg(pcm), device="cpu")
    for call in (lambda: p_sys.process_stereo_frame(images[0], images[0], world.odom[0]),
                 lambda: p_sys.save_checkpoint("x"), lambda: p_sys.load_checkpoint("x"),
                 lambda: p_sys.build_ba_problem(), lambda: p_sys.run_ba()):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(NotImplementedError, match="kitti"):
        cli.main(["run", "--config", "configs/kitti_00.yaml", "--device", "cpu"])
    # the matcher kernel is picked by the device: on the CPU no launch counts
    before = match.hamming_top2.launches
    system._batched_kf_match(torch.zeros(4, 8, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
                             torch.zeros(2, 4, 8, dtype=torch.int32),
                             torch.ones(2, 4, dtype=torch.bool), 0.8)
    assert match.hamming_top2.launches == before
