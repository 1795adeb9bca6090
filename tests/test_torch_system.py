"""The port's online monocular system against the JAX package: the batched
loop closure over the stacked keyframe store (planted closure, no false
closure, store growth), the closure verification (Horn consensus and the
reprojection refines), a panoramic-world run under JAX's own per-frame
draws, the reference's functional bounds on the whole run, the
corrected-trajectory re-anchoring, the metrics log, the CLI's TUM path, the
bundle-adjustment entry points (the point dedup, `build_ba_problem`,
`run_ba`, alone on planted keyframes and after the panoramic run) and the
paths that are not ported.

The JAX system runs its XLA path (use_pallas=False, the config default).
Match tables, keyframe frames, closure lists and descriptors must be equal;
poses and points agree to atol=1e-4 (Horn/refine on noiseless or lightly
noisy correspondences) or 1e-3 (a 12-frame filter run; float sums in
another order). BA problems: index tables and masks equal, floats within
1e-4; after `run_ba(iters=2)` keyframe poses within 1e-3 and costs within
rtol=1e-3."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu import cli as j_cli
from parakeet_slam_tpu.backend import ba as j_ba
from parakeet_slam_tpu.backend import graph as j_graph
from parakeet_slam_tpu.core import config as jcm
from parakeet_slam_tpu.core import geometry as j_geo
from parakeet_slam_tpu.data.panoramic import make_panoramic_world as j_make_panoramic_world
from parakeet_slam_tpu.system import Keyframe as JKeyframe
from parakeet_slam_tpu.system import SLAMSystem as JSystem
from parakeet_slam_tpu.system import _assign_point_ids as j_assign_point_ids
from parakeet_slam_tpu.system import _global_descriptor as j_global_descriptor
from parakeet_slam_tpu.frontend.camera import Pinhole as JPinhole
from parakeet_slam_tpu_torch import cli, system
from parakeet_slam_tpu_torch.backend import ba as t_ba
from parakeet_slam_tpu_torch.backend import graph as t_graph
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


@pytest.fixture(scope="module")
def pano_pair(pano):
    """Both systems after PARITY_FRAMES frames of the panoramic world, the
    port under JAX's own draws: (JAX system, port system, JAX estimates,
    port estimates)."""
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
    return j_sys, p_sys, j_est, p_est


def test_panoramic_run_matches_jax_under_its_draws(pano_pair):
    j_sys, p_sys, j_est, p_est = pano_pair
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


def _assert_same_ba_problem(p_prob, j_prob):
    for f in ("cam_valid", "pt_valid", "obs_cam", "obs_pt", "obs_valid", "cam_fixed"):
        np.testing.assert_array_equal(getattr(p_prob, f).numpy(), np.asarray(getattr(j_prob, f)), f)
    _same_pose(p_prob.cam_pose.numpy(), np.asarray(j_prob.cam_pose), 1e-4)
    pv, ov = p_prob.pt_valid.numpy(), p_prob.obs_valid.numpy()
    np.testing.assert_allclose(p_prob.points.numpy()[pv], np.asarray(j_prob.points)[pv], atol=1e-3)
    np.testing.assert_allclose(p_prob.obs_uv.numpy()[ov], np.asarray(j_prob.obs_uv)[ov],
                               rtol=1e-4, atol=1e-2)


def test_panoramic_run_then_bundle_adjustment_matches_jax(pano_pair):
    """The slice as a whole: after the panoramic run under JAX's draws, both
    systems assemble the same BA problem (dedup, observations, gating) and
    `run_ba(iters=2)` with the fused pose-graph edges moves the keyframes
    alike. `run_ba` rewrites the keyframe poses and nothing else of a
    system, so the shared pair gets them back whatever the order of the
    tests."""
    j_sys, p_sys, _, _ = pano_pair
    saved = [(kf, np.array(kf.pose)) for s in (j_sys, p_sys) for kf in s.keyframes]
    try:
        _check_ba_after_panoramic_run(j_sys, p_sys)
    finally:
        for kf, pose in saved:
            kf.pose = pose


def _check_ba_after_panoramic_run(j_sys, p_sys):
    j_prob, p_prob = j_sys.build_ba_problem(), p_sys.build_ba_problem()
    assert p_prob.num_cams == len(p_sys.keyframes) >= 2
    assert int(p_prob.obs_valid.sum()) > 50 and int(p_prob.pt_valid.sum()) > 20
    _assert_same_ba_problem(p_prob, j_prob)
    j_edges, p_edges = j_sys.graph_pose_edges(30.0), p_sys.graph_pose_edges(30.0)
    np.testing.assert_array_equal(p_edges[0].numpy(), np.asarray(j_edges[0]))
    np.testing.assert_allclose(p_edges[2].numpy(), np.asarray(j_edges[2]), rtol=1e-6)
    j_res, p_res = j_sys.run_ba(iters=2), p_sys.run_ba(iters=2)
    np.testing.assert_allclose(p_res.costs.numpy(), np.asarray(j_res.costs), rtol=1e-3)
    assert np.isfinite(p_res.costs.numpy()).all()
    for pk, jk in zip(p_sys.keyframes, j_sys.keyframes):
        _same_pose(pk.pose, jk.pose, 1e-3)
    np.testing.assert_allclose(p_sys.keyframes[0].pose, p_prob.cam_pose[0].numpy())  # the gauge


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


# -- bundle adjustment ----------------------------------------------------------


def _dedup_case(name):
    """(desc [K, F, W] uint32, valid, world, cap): the two fixtures of
    tests/test_system_host_paths.py and a larger one with descriptors drawn
    from a small pool (cross-keyframe matches, duplicates within a keyframe,
    near-duplicates under the Hamming gate, an overflowing store)."""
    W = 8
    if name == "dedup_order":
        rng = np.random.default_rng(9)
        d = rng.integers(0, 2**32, (4, W), dtype=np.uint32)
        desc = np.stack([np.stack([d[0], d[1], d[2]]), np.stack([d[1], d[3], d[0]])])
        valid = np.array([[True, True, False], [True, True, True]])
        return desc, valid, rng.normal(size=(2, 3, 3)).astype(np.float32), 16
    if name == "capacity_overflow":
        rng = np.random.default_rng(10)
        return (rng.integers(0, 2**32, (1, 6, W), dtype=np.uint32), np.ones((1, 6), bool),
                rng.normal(size=(1, 6, 3)).astype(np.float32), 4)
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 2**32, (60, W), dtype=np.uint32)
    desc = pool[rng.integers(0, 60, (5, 24))]
    desc[2:, :6, 0] ^= np.uint32(0b1011)                  # 3 bits off: under the gate
    return desc, rng.random((5, 24)) > 0.15, rng.normal(size=(5, 24, 3)).astype(np.float32), 48


@pytest.mark.parametrize("name", ["dedup_order", "capacity_overflow", "pool"])
def test_assign_point_ids_matches_jax(name):
    desc, valid, world, cap = _dedup_case(name)
    (jd, jv, jp, jc, jdrop), jpid = j_assign_point_ids(
        jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(world), cap=cap, use_pallas=False,
        max_ham=40)
    T = torch.as_tensor
    (sd, sv, sp, cnt, drop), pid = system._assign_point_ids(
        T(desc.view(np.int32)), T(valid), T(world), cap=cap, max_ham=40)
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jpid))
    assert (int(cnt), int(drop)) == (int(jc), int(jdrop))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(sd.numpy().view(np.uint32), np.asarray(jd))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jp))
    assert pid.dtype == torch.int32 and sd.shape == (cap, 8)
    if name == "dedup_order":
        assert pid.tolist() == [[0, 1, -1], [1, 2, 0]]
    elif name == "capacity_overflow":
        assert pid.tolist() == [[0, 1, 2, 3, -1, -1]] and (int(cnt), int(drop)) == (4, 2)
    else:
        assert int(drop) > 0 and int(cnt) == cap


def _noisy_keyframes(systems, rng, n=4, F=32, noise=0.05):
    world = rng.uniform(-6, 6, (F, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    for i in range(n):
        pose = np.array([0.6 * i, 0.1 * i, 0, 0, 0, 0, 1], np.float32)
        noisy = world + rng.normal(0, noise, world.shape).astype(np.float32)
        _add_keyframe(systems, i, pose, noisy, desc)


def test_build_ba_problem_and_run_ba_match_jax(capsys):
    """tests/test_system_host_paths.py's BA fixtures on both systems: four
    keyframes measure the same 32 landmarks with independent noise."""
    systems = _pair()
    j_sys, p_sys = systems
    assert p_sys.build_ba_problem() is None and p_sys.run_ba() is None  # < 2 keyframes
    _noisy_keyframes(systems, np.random.default_rng(21))
    j_prob, p_prob = j_sys.build_ba_problem(), p_sys.build_ba_problem()
    assert (p_prob.num_cams, p_prob.num_points, p_prob.num_obs) == (4, 128, 128)
    assert int(p_prob.pt_valid.sum()) == 32 and int(p_prob.obs_valid.sum()) == 4 * 32
    assert p_prob.cam_fixed.tolist() == [True, False, False, False]
    _assert_same_ba_problem(p_prob, j_prob)
    # matched observations share their point ids across keyframes
    pid = p_prob.obs_pt.reshape(4, 32)
    assert (pid == pid[0]).all()
    j_res, p_res = j_sys.run_ba(iters=3), p_sys.run_ba(iters=3)
    np.testing.assert_allclose(p_res.costs.numpy(), np.asarray(j_res.costs), rtol=1e-3)
    assert float(p_res.costs[-1]) < float(p_res.costs[0])
    for pk, jk in zip(p_sys.keyframes, j_sys.keyframes):
        _same_pose(pk.pose, jk.pose, 1e-3)
    np.testing.assert_allclose(p_sys.keyframes[2].pose, p_res.problem.cam_pose[2].numpy())
    assert "exhausted" not in capsys.readouterr().err


def test_build_ba_problem_capacity_and_gauge(capsys):
    """An exhausted point store is logged and the run carries on; without
    fused pose edges the second camera is fixed too (the scale gauge)."""
    cfg = _host_cfg(pcm)
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, max_landmarks=40, ba_fuse_pose_graph=False))
    p_sys = system.SLAMSystem(cfg, device="cpu")
    logged = []
    p_sys.metrics.log = lambda frame, **rec: logged.append(rec)
    rng = np.random.default_rng(5)
    for i in range(3):  # distinct maps: 96 new points against a capacity of 40
        _add_port_keyframe(p_sys, i, np.array([0.5 * i, 0, 0, 0, 0, 0, 1], np.float32),
                           rng.uniform(-6, 6, (32, 3)).astype(np.float32),
                           rng.integers(0, 2**32, (32, 8), dtype=np.uint32))
    prob = p_sys.build_ba_problem()
    assert "point capacity 40" in capsys.readouterr().err
    assert logged == [{"ba_points_dropped": 56, "ba_point_capacity": 40}]
    assert prob.num_points == 40 and int(prob.obs_valid.sum()) == 40
    assert prob.cam_fixed.tolist() == [True, True, False]
    res = p_sys.run_ba(iters=2)
    assert np.isfinite(res.problem.cam_pose.numpy()).all() and res.costs.shape == (2,)


def test_run_ba_low_damping_rejections_match_jax():
    """`run_ba` starts LM at the config's lm_damping_init (1e-4 for
    configs/tum_fr1_desk.yaml). On the BA problem of a desk-world run (28
    frames at a small width) the first iterations are rejected while the
    damping climbs, and the JAX solver, handed the same problem and pose
    edges as numpy, rejects them too; both then descend. Later accepts may
    differ: PCG at low damping has not converged in 50 iterations, and its
    step is sensitive to rounding."""
    from parakeet_slam_tpu_torch.data.synth_vision import make_desk_world

    frames = 28
    cfg = pcm.load_config("configs/tum_fr1_desk.yaml", {
        "filter.num_particles": 16, "filter.max_landmarks": 256,
        "filter.max_observations": 32, "frontend.max_features": 64})
    world = make_desk_world(num_steps=frames)
    odom = cli._make_odometry(cfg.data, world.gt_pose, frames)
    p_sys = system.SLAMSystem(cfg, device="cpu")
    cli.run_image_sequence(p_sys, [world.render(i) for i in range(frames)], odom)
    be = cfg.backend
    assert be.lm_damping_init == 1e-4 and be.ba_fuse_pose_graph
    prob = p_sys.build_ba_problem()
    prob = t_graph.cap_obs_per_point(
        t_graph.gate_outlier_obs(p_sys.camera, prob, be.ba_outlier_px), be.ba_max_obs_per_point)
    edges = p_sys.graph_pose_edges(be.ba_pose_edge_weight)
    assert prob.num_cams >= 10 and int(prob.obs_valid.sum()) > 500 and len(edges[0]) >= 9
    kw = dict(iters=be.gn_iters, lam=be.lm_damping_init, pcg_iters=be.pcg_iters,
              huber_delta=be.huber_delta, solver="pcg",
              step_clamp=(be.ba_step_clamp_cam, be.ba_step_clamp_pt))
    t_costs = t_ba.optimize_ba(p_sys.camera, prob, pose_edges=edges, **kw).costs.numpy()
    fx, fy, cx, cy = cfg.frontend.intrinsics[:4]
    H, W = cfg.frontend.image_size
    j_prob = j_graph.BAProblem(**{k: jnp.asarray(v)
                                  for k, v in t_graph.ba_problem_to_numpy(prob).items()})
    j_costs = np.asarray(j_ba.optimize_ba(
        JPinhole(fx, fy, cx, cy, W, H), j_prob,
        pose_edges=tuple(jnp.asarray(e.numpy()) for e in edges), **kw).costs)
    print("port", t_costs, "jax", j_costs)
    # rejected iterations report the unchanged cost: the same in both
    np.testing.assert_allclose(t_costs[:2], j_costs[:2], rtol=1e-5)
    assert t_costs[0] == t_costs[1] and j_costs[0] == j_costs[1]
    assert t_costs[-1] < 0.8 * t_costs[0] and j_costs[-1] < 0.8 * j_costs[0]
    # the system's own entry point is that solve
    res = p_sys.run_ba()
    np.testing.assert_array_equal(res.costs.numpy(), t_costs)


def test_corrected_trajectory_composes_on_the_system_device(pano, monkeypatch):
    """The re-anchoring builds its tensors on the system's device and copies
    the result to the host once. Shown without a card by moving the system
    to the `meta` device after the run: both compositions then see meta
    tensors, and the one copy to the host is what fails."""
    world, images = pano
    p_sys = system.SLAMSystem(_pano_cfg(pcm), device="cpu")
    est = torch.stack([p_sys.process_frame(images[t], world.odom[t]) for t in range(6)]).numpy()
    out = p_sys.corrected_trajectory(est, final_optimize=False)
    seen = []
    compose = geometry.se3_compose
    monkeypatch.setattr(system.geometry, "se3_compose",
                        lambda a, b: seen.append((a.device.type, b.device.type)) or compose(a, b))
    np.testing.assert_array_equal(p_sys.corrected_trajectory(est, final_optimize=False), out)
    assert seen == [("cpu", "cpu")] * 2
    # lists and tensors of estimates are taken as well
    np.testing.assert_array_equal(
        p_sys.corrected_trajectory(list(torch.as_tensor(est)), final_optimize=False), out)
    p_sys.device = torch.device("meta")
    del seen[:]
    with pytest.raises(NotImplementedError, match="meta"):
        p_sys.corrected_trajectory(est, final_optimize=False)
    assert seen == [("meta", "meta")] * 2


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


# -- the distributed BA at one rank, and the remaining refusal ---------------


def test_distributed_ba_at_one_rank_and_the_stereo_refusal(pano):
    """`run_ba(distributed=True)` with no process group runs the distributed
    solver on a 1 x 1 mesh (dist.map_axis=1, as the reference's
    make_mesh(n_devices=map_axis) on one device): on the BA fixture its
    costs follow JAX's distributed solve, its final cost meets the
    reference's bar against the one-device solver (<= 2 x + 1), and it
    rewrites the keyframe poses. A monocular system refuses stereo frames.
    On the CPU the matcher launches no kernel."""
    world, images = pano
    systems = _pair()
    j_sys, p_sys = systems
    _noisy_keyframes(systems, np.random.default_rng(21))
    one = p_sys.solve_ba(p_sys.ba_problem(), iters=3)
    j_res, p_res = j_sys.run_ba(iters=3, distributed=True), p_sys.run_ba(iters=3, distributed=True)
    np.testing.assert_allclose(p_res.costs.numpy(), np.asarray(j_res.costs), rtol=1e-3)
    assert np.isfinite(p_res.costs.numpy()).all()
    assert float(p_res.costs[-1]) <= 2.0 * float(one.costs[-1]) + 1.0
    for i, kf in enumerate(p_sys.keyframes):
        np.testing.assert_array_equal(kf.pose, p_res.problem.cam_pose[i].numpy())
        # tests/test_schur_distba.py's bar for the distributed solver
        _same_pose(kf.pose, j_sys.keyframes[i].pose, 5e-3)
    p_sys = system.SLAMSystem(_pano_cfg(pcm), device="cpu")
    # stereo frames are ported (tests/test_torch_stereo.py); a monocular
    # configuration refuses them, as the reference's does
    with pytest.raises(ValueError, match="obs_dim=3"):
        p_sys.process_stereo_frame(images[0], images[0], world.odom[0])
    # the matcher kernel is picked by the device: on the CPU no launch counts
    before = match.hamming_top2.launches
    system._batched_kf_match(torch.zeros(4, 8, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
                             torch.zeros(2, 4, 8, dtype=torch.int32),
                             torch.ones(2, 4, dtype=torch.bool), 0.8)
    assert match.hamming_top2.launches == before
