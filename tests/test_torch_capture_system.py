"""The one-device system's captured programs on the CPU, at small sizes: the
frame with its frontend (`SLAMSystem._image_frame`: the port's counterpart of
the reference's jitted `_fused_frame_impl` and `_fused_stereo_impl`), closure
verification (`_verify_batch`, the jitted `_verify_candidates`) and the
pose-graph solve (`posegraph.CapturedSolver`, `@jax.jit optimize_pose_graph`).

(a) Capture safety: after one warm-up call, one call of each under the
    guard of tests/test_torch_capture.py, which makes the Python-level host
    reads and host-to-device copies raise: a mono frame with FAST and with
    Harris, a pyramid frame (two levels), a stereo frame, the verify refine
    and the depth-relaxed refine, a pose-graph solve. Horn's consensus is
    left out: on the card its `linalg.svd` checks convergence on the host,
    so it runs eagerly before the refine's graph.
(b) `SLAMSystem(capture=True)`, which on the CPU runs the captured path's
    buffer rules eagerly, equals `capture=False` bit for bit: config 2's
    filter over 26 frames of a small desk world from images, with accepted
    closures (each verified, optimized and applied), a forced correction
    and a save/load round trip into a fresh captured system; and over 4
    frames of the reference's stereo fixture, the last 2 with injected draws.
(c) The captured solver and the captured verify against JAX's jitted ones
    on numpy inputs from a seed, at the tolerances of
    tests/test_torch_backend.py (poses atol 2e-3, costs rtol 2e-2 atol 1e-6)
    and tests/test_torch_system.py (rels atol 1e-4 up to the quaternion's
    sign, inlier counts equal).
(d) The eager solve and both refines through `linalg.solve_ex` without its
    check equal, bit for bit, the same through `linalg.solve`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.backend import posegraph as j_pg
from parakeet_slam_tpu_torch import cli, system
from parakeet_slam_tpu_torch.backend import graph as graph_mod
from parakeet_slam_tpu_torch.backend import posegraph as pg
from parakeet_slam_tpu_torch.core import config as pcm
from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.core.config import load_config
from parakeet_slam_tpu_torch.data.synth_vision import make_desk_world
from parakeet_slam_tpu_torch.filter import captured
from test_torch_backend import _circle_graph
from test_torch_capture import FIELDS, no_host_reads
from test_torch_stereo import _fixture_world, _stereo_cfg
from test_torch_system import _correspondences, _pair, _same_pose

DESK_FRAMES = 26
CORRECT_AT = 12   # the forced correction, after this many frames
SAVE_AT = 23      # the snapshot, after this many frames: past the first closures


def _desk_cfg(**overrides):
    """Config 2 (configs/tum_fr1_desk.yaml) at P=16, L=128, Z=16 and 32
    features on 96x128 frames; a keyframe every 5 cm."""
    return load_config("configs/tum_fr1_desk.yaml", {
        "filter.num_particles": 16, "filter.max_landmarks": 128, "filter.max_observations": 16,
        "frontend.max_features": 32, "frontend.image_size": [96, 128],
        "frontend.intrinsics": [103.46, 103.3, 63.72, 51.06],
        "backend.keyframe_translation": 0.05, "backend.max_keyframes": 64, **overrides})


@pytest.fixture(scope="module")
def desk():
    """The desk world of 40 steps (two orbits of 20 frames): the second
    orbit's keyframes close on the first's from frame 21."""
    cfg = _desk_cfg()
    world = make_desk_world(num_landmarks=300, num_steps=40, image_size=(96, 128),
                            intrinsics=tuple(cfg.frontend.intrinsics))
    images = [world.render(i) for i in range(DESK_FRAMES)]
    return cfg, images, cli._make_odometry(cfg.data, world.gt_pose, DESK_FRAMES)


def _assert_states_equal(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x, y), f"{what}: {f} differs in {int((x != y).sum())} entries"


# -- (a) capture safety --------------------------------------------------------


def _frame_case(sys_, images, odom):
    """One call of the system's captured image frame on images[t]."""
    shape = np.shape(images(0)[0])
    fn = sys_._image_frame(len(images(0)), shape)
    P = sys_.slam.cfg.num_particles

    def call(t):
        x = {"frame": torch.cat([torch.as_tensor(np.asarray(a, np.float32)).reshape(-1)
                                 for a in images(t)] + [torch.as_tensor(odom[t]).float()]),
             "noise": torch.zeros(P, sys_.slam.noise_dim), "u0": torch.full((), 0.5),
             "u0_drawn": torch.ones((), dtype=torch.bool), "has_kf": sys_._has_kf_dev}
        return lambda: fn((sys_.state, sys_._last_kf_dev), x)

    return call


def _verify_case(depth_sigma):
    _, p_sys = _pair(camera="pinhole", depth_sigma=depth_sigma)
    rng = np.random.default_rng(3)
    pa, pb, valid = (torch.as_tensor(np.stack(a)) for a in zip(
        *(_correspondences(rng, "pinhole", noise=0.01, outliers=3)[:3] for _ in range(4))))
    rel0, _ = p_sys._horn_consensus_impl(pa, pb, valid)
    return lambda t: lambda: p_sys._refine()(rel0, pa, pb, valid)


def _case(name, desk):
    cfg, images, odom = desk
    if name == "stereo":
        world = _fixture_world()
        s = system.SLAMSystem(_stereo_cfg(pcm), device="cpu", capture=False)
        return _frame_case(s, lambda t: world.render_stereo(t), world.odom)
    if name in ("verify_refine", "verify_depth_relaxed"):
        return _verify_case(0.3 if name == "verify_depth_relaxed" else 0.0)
    if name == "posegraph":
        _, tgr, _ = _circle_graph(n=12)
        return lambda t: lambda: pg.optimize_pose_graph(tgr, iters=3)
    over = {"mono_harris": {"frontend.detector": "harris"},
            "pyramid": {"frontend.pyramid_levels": 2}}.get(name, {})
    s = system.SLAMSystem(_desk_cfg(**over), device="cpu", capture=False)
    return _frame_case(s, lambda t: (images[t],), odom)


CASES = ["mono_fast", "mono_harris", "pyramid", "stereo", "verify_refine",
         "verify_depth_relaxed", "posegraph"]


@pytest.mark.parametrize("name", CASES)
def test_captured_program_reads_nothing_on_the_host(name, desk):
    call = _case(name, desk)
    call(0)()  # the warm-up: the constants reach the device
    step = call(1)
    with pytest.MonkeyPatch.context() as mp:
        no_host_reads(mp)
        out = step()
    assert all(torch.isfinite(t).all() for t in captured.leaves(out) if t.is_floating_point())
    if name.startswith(("mono", "pyramid", "stereo")):
        (state, _), (est, _, _, _) = out
        assert bool(state.lm_valid.any()) and est.shape == (7,)


# -- (b) the captured system against the eager one --------------------------------


def _keyframes(s):
    return [(k.index, k.frame, k.pose.tobytes(), k.points_kf.tobytes(), k.desc.tobytes(),
             [(st, a.tobytes()) for st, a in k.anchors]) for k in s.keyframes]


def _correct(sys_):
    """A pose-graph correction: a loop edge 0 -> last keyframe that
    disagrees with the chain by 5 cm, optimized and applied to the state."""
    k = len(sys_.keyframes) - 1
    rel = geometry.se3_between(sys_.graph.poses[0], sys_.graph.poses[k])
    rel = rel + torch.tensor([0.05, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    sys_.graph = graph_mod.add_edge(sys_.graph, 0, k, rel, info=[100.0] * 6)
    sys_._optimize_and_correct()


def test_captured_system_from_images_equals_the_eager_system(desk, tmp_path):
    cfg, images, odom = desk
    eager = system.SLAMSystem(cfg, device="cpu", capture=False)
    static = system.SLAMSystem(cfg, device="cpu", capture=True)
    prefix = str(tmp_path / "snap")
    for t in range(DESK_FRAMES):
        if t == SAVE_AT:  # a round trip into a fresh captured system
            static.save_checkpoint(prefix)
            static = system.SLAMSystem(cfg, device="cpu", capture=True)
            static.load_checkpoint(prefix)
        buffers = [b.data_ptr() for b in captured.leaves((static.state, static._last_kf_dev))]
        a = eager.process_frame(images[t], odom[t])
        b = static.process_frame(images[t], odom[t])
        assert torch.equal(a, b), f"frame {t}: estimates differ"
        if t + 1 == CORRECT_AT:
            _correct(eager)
            _correct(static)
        _assert_states_equal(static.state, eager.state, f"frame {t}")
        assert torch.equal(static._last_kf_dev, eager._last_kf_dev), f"frame {t}"
        assert [b.data_ptr() for b in
                captured.leaves((static.state, static._last_kf_dev))] == buffers
    ests = [s.corrected_trajectory(np.zeros((DESK_FRAMES, 7), np.float32) + [0, 0, 0, 0, 0, 0, 1])
            for s in (eager, static)]
    assert np.array_equal(*ests)
    assert len(eager.loop_closures) >= 2 and static.loop_closures == eager.loop_closures
    assert _keyframes(static) == _keyframes(eager)
    for f in ("poses", "edge_ij", "edge_rel", "edge_valid"):
        assert torch.equal(getattr(static.graph, f), getattr(eager.graph, f)), f
    # every program of the captured system went through its step
    assert list(static._frame_steps) == [("mono", (96, 128), 6)]
    assert static._verify_steps and static._pg_solver.steps
    assert not (eager._frame_steps or eager._verify_steps or eager._pg_solver)
    # what a frame hands out is the caller's own: the outputs are one buffer
    cs = static._frame_steps[("mono", (96, 128), 6)]
    views = captured.leaves(cs.outputs)
    base = cs._packed.data_ptr()
    assert all(base <= v.data_ptr() < base + cs._packed.numel() for v in views if v.numel())
    e0 = static.process_frame(images[0], odom[0])
    e1 = static.process_frame(images[1], odom[1])
    assert not torch.equal(e0, e1) and e0.data_ptr() != e1.data_ptr()


def test_captured_stereo_frames_equal_the_eager_ones():
    """The reference's stereo fixture: two frames drawn by the system, then
    two with injected draws (the u0 input holds the offset as given)."""
    world = _fixture_world()
    cfg = _stereo_cfg(pcm)
    eager = system.SLAMSystem(cfg, device="cpu", capture=False)
    static = system.SLAMSystem(cfg, device="cpu", capture=True)
    gen = torch.Generator().manual_seed(1)
    for t in range(4):
        kw = {} if t < 2 else {"motion_noise": torch.randn(16, eager.slam.noise_dim,
                                                           generator=gen),
                               "resample_u0": float(torch.rand((), generator=gen)) / 16}
        left, right = world.render_stereo(t)
        a = eager.process_stereo_frame(left, right, world.odom[t], **kw)
        b = static.process_stereo_frame(left, right, world.odom[t], **kw)
        assert torch.equal(a, b), f"frame {t}: estimates differ"
        _assert_states_equal(static.state, eager.state, f"frame {t}")
    assert list(static._frame_steps) == [("stereo", (96, 160), 6)]
    assert static._u0_drawn[("stereo", (96, 160), 6)] is False
    assert bool(static.state.lm_valid.any())
    with pytest.raises(ValueError, match="stereo pair"):
        static.process_stereo_frame(left, right[:, :-1], world.odom[0])


# -- (c) JAX parity of the captured programs ----------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_captured_solver_matches_jax(seed):
    jgr, tgr, _ = _circle_graph(seed=seed)
    jopt, jcosts = j_pg.optimize_pose_graph(jgr, iters=10)
    solver = pg.CapturedSolver(iters=10, graph=False)
    first = solver(tgr)
    topt, tcosts = solver(tgr)  # through the step's static buffers again
    assert torch.equal(topt.poses, first[0].poses) and torch.equal(tcosts, first[1])
    eager, ecosts = pg.optimize_pose_graph(tgr, iters=10)
    assert torch.equal(topt.poses, eager.poses) and torch.equal(tcosts, ecosts)
    np.testing.assert_allclose(topt.poses.numpy(), np.asarray(jopt.poses), atol=2e-3)
    np.testing.assert_allclose(tcosts.numpy(), np.asarray(jcosts), rtol=2e-2, atol=1e-6)
    assert list(solver.steps) == [(tgr.max_nodes, tgr.max_edges)]
    assert topt.n_nodes == tgr.n_nodes and topt.poses.data_ptr() != first[0].poses.data_ptr()


@pytest.mark.parametrize("camera,depth_sigma", [("equirect", 0.0), ("pinhole", 0.0),
                                                ("pinhole", 0.3)],
                         ids=["equirect", "pinhole", "pinhole_depth_relaxed"])
def test_captured_verify_matches_jax(camera, depth_sigma):
    rng = np.random.default_rng(19)
    j_sys, p_sys = _pair(camera=camera, depth_sigma=depth_sigma)
    p_sys = system.SLAMSystem(dataclasses.replace(p_sys.cfg), device="cpu", capture=True)
    for rep in range(2):  # the step's first call, then its static buffers again
        cases = [_correspondences(rng, camera, noise=0.01, outliers=5),
                 _correspondences(rng, camera, noise=0.0, outliers=0, n=20)]
        pa, pb, v = (np.stack([c[i] for c in cases]) for i in range(3))
        j_rels, j_ns = j_sys._verify_candidates(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(v))
        rels, ns = p_sys._verify_batch(pa, pb, v)
        np.testing.assert_array_equal(ns, np.asarray(j_ns))
        _same_pose(rels.numpy(), np.asarray(j_rels), 1e-4)
        e_rels, e_ns = p_sys._verify_candidates(*(torch.as_tensor(a) for a in (pa, pb, v)))
        assert torch.equal(rels, e_rels) and np.array_equal(ns, e_ns.numpy())
    assert list(p_sys._verify_steps) == [pa.shape]


# -- (d) solve_ex without its check leaves the eager results as they were -----------


@pytest.mark.parametrize("name", ["posegraph", "verify_refine", "verify_depth_relaxed"])
def test_solve_ex_equals_solve_bit_for_bit(name, desk, monkeypatch):
    run = _case(name, desk)(0)
    ex = run()
    monkeypatch.setattr(torch.linalg, "solve_ex", lambda A, B, check_errors=False: (
        torch.linalg.solve(A, B), torch.zeros(A.shape[:-2], dtype=torch.int32)))
    plain = run()
    for a, b in zip(captured.leaves(ex), captured.leaves(plain)):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
