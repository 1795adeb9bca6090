"""The captured filter step (`filter/captured.py`) on the CPU, at small
sizes: the port's counterpart of the reference's jitted step, `lax.cond`
resample and `lax.scan` runner.

(a) Capture safety: after one warm-up step, a step of each filter the
    benchmark configs build (and of the generic path's bearing_2d /
    velocity_2d, and of the system's frame) runs under a guard that makes
    the host's reads of the device and its copies of host data raise:
    `Tensor.__bool__`, `item`, `tolist`, `cpu`, `numpy`, `__int__`,
    `__float__`, `__index__`, `torch.tensor`, `torch.as_tensor`,
    `nonzero`, `masked_select`, and indexing with a 0-dim or a boolean
    tensor (torch reads the first on the host, and the second through
    `nonzero`). On the card, where no such guard can see inside torch,
    `chip_smoke.py` runs each under `torch.cuda.set_sync_debug_mode`.
(b) `run_sequence` through the captured path's static buffers (eager on the
    CPU) equals the eager loop bit for bit over 24 frames with and without
    a resample; frame by frame, `CapturedStep` keeps its buffers in place,
    overwrites its outputs, holds log_w on a frame without a resample and
    equals the eager step bit for bit.
(c) The device-side resample keeps JAX parity: the captured `run_sequence`
    with JAX's draws injected equals JAX's `run_sequence` under the
    tolerances of tests/test_torch_slice.py and tests/test_torch_fastslam2.py.
(d) `SLAMSystem(capture=True)` (config 2's filter, FastSLAM 2.0 pinhole_3d
    with its weight shaping) equals the eager system bit for bit over a run
    with a pose-graph correction and a save/load round trip into a fresh
    captured system.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.core.config import load_config as j_load_config
from parakeet_slam_tpu.data import make_corridor
from parakeet_slam_tpu.filter import run_sequence as j_run_sequence
from parakeet_slam_tpu.filter.fastslam2 import make_filter as j_make_filter
from parakeet_slam_tpu_torch import cli, system
from parakeet_slam_tpu_torch.backend import graph as graph_mod
from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.core.config import FilterConfig, load_config
from parakeet_slam_tpu_torch.core.state import Observation, state_from_numpy
from parakeet_slam_tpu_torch.data import make_drive_world
from parakeet_slam_tpu_torch.data.panoramic import make_panoramic_world
from parakeet_slam_tpu_torch.eval.kernel_inputs import drive_observations, panoramic_observations
from parakeet_slam_tpu_torch.filter import captured, make_filter, run_sequence
from parakeet_slam_tpu_torch.filter.runner import draw_noise
from tests import torch_dist_worker as W
from tests.torch_dist_worker import HostRead

FIELDS = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_desc", "lm_valid", "lm_count")
SMALL = dict(num_particles=16, max_landmarks=64, max_observations=8, sig_dim=3,
             motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
             max_range=6.5, fov_half_angle=2.5)
BEARING = dict(measurement_model="bearing_2d", obs_dim=1, meas_noise=(0.03,), sig_dim=3,
               max_range=6.5, fov_half_angle=2.5, init_range_prior=3.0, init_range_sigma=1.5,
               num_particles=16, max_landmarks=48, max_observations=8, sig_noise=0.5,
               new_landmark_loglik=-3.0)
SMALL_3D = {"filter.num_particles": 16, "filter.max_landmarks": 256,
            "filter.max_observations": 32}
# config 2's filter (configs/tum_fr1_desk.yaml: FastSLAM 2.0, pinhole_3d, the
# weight shaping and the tempering) on the drive world's KITTI camera
CONFIG2_FILTER = {"filter.measurement_model": "pinhole_3d", "filter.obs_dim": 2,
                  "filter.meas_noise": [1.5, 1.5], "filter.weight_min_count": 5,
                  "filter.weight_only_matched": True, "filter.assoc_gate_px": 4.0,
                  "filter.likelihood_temper": 8.0}
T = torch.as_tensor


def _assert_states_equal(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x, y), f"{what}: {f} differs in {int((x != y).sum())} entries"


# -- (a) capture safety --------------------------------------------------------


@pytest.fixture
def one_thread():
    """One intra-op thread for the test, restored after it: a test of many
    small ops slows by orders of magnitude in torch's thread pool when the
    test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def no_host_reads(mp):
    """Make the Python-level host reads and host-to-device copies raise
    (module docstring, (a)) for the rest of the monkeypatch context."""
    for obj, name, fn in W.host_read_patches():
        mp.setattr(obj, name, fn)


def _corridor_frames(frames=2):
    sim = make_corridor(num_landmarks=30, num_steps=frames, max_obs=8, seed=3)
    odom, z, sig, valid = cli.sim_tensors(sim, "cpu")
    obs = [Observation(z=z[t], sig=sig[t], desc=torch.zeros(8, 0, dtype=torch.int32),
                       valid=valid[t]) for t in range(frames)]
    return sim.gt_pose[0], odom, obs


def _bearing_frames(velocity):
    init, odom, obs = _corridor_frames()
    obs = [o.replace(z=o.z[:, 1:2].contiguous()) for o in obs]
    if velocity:  # [v, w, dt] from the corridor's increments at dt = 0.1
        odom = torch.stack([odom[:, 0] / 0.1, odom[:, 2] / 0.1, torch.full_like(odom[:, 0], 0.1)],
                           1)
    return init, odom, obs


def _vision_frames(model, overrides, frames=2):
    cfg = load_config("configs/kitti_00.yaml", {**SMALL_3D, **overrides})
    world = make_drive_world(num_steps=frames + 1)
    obs = []
    for t in range(frames):
        z, desc, valid = drive_observations(world, t, 32, 8, seed=0)
        if model == "pinhole_3d":
            z = np.ascontiguousarray(z[:, :2])
        obs.append(Observation(z=T(z), sig=torch.zeros(32, 0), desc=T(desc.view(np.int32)),
                               valid=T(valid)))
    return cfg, world.gt_pose[0], T(world.odom[:frames]), obs


def _equirect_frames(frames=2):
    cfg = load_config("configs/panoramic.yaml", {
        **SMALL_3D, "frontend.image_size": [128, 256]})
    world = make_panoramic_world(num_landmarks=400, num_steps=frames + 1, image_size=(128, 256),
                                 seed=3)
    obs = []
    for t in range(frames):
        z, desc, valid = panoramic_observations(world, t, 32, 8, seed=0)
        obs.append(Observation(z=T(z), sig=torch.zeros(32, 0), desc=T(desc.view(np.int32)),
                               valid=T(valid)))
    return cfg, world.gt_pose[0], T(world.odom[:frames]), obs


def _filter_case(name):
    """(filter, state, [(u, obs)] of two frames, SLAMSystem or None)."""
    if name == "corridor_fs1":
        slam = make_filter(cli.corridor_config())
        init, odom, obs = _corridor_frames()
    elif name in ("bearing_fs1", "bearing_velocity_fs2"):
        fs2 = name == "bearing_velocity_fs2"
        slam = make_filter(FilterConfig(
            **BEARING, motion_model="velocity_2d" if fs2 else "odometry_2d",
            motion_noise=(0.05, 0.01, 0.05, 0.01),
            algorithm="fastslam2" if fs2 else "fastslam1"))
        init, odom, obs = _bearing_frames(fs2)
    elif name == "equirect_fs1":
        cfg, init, odom, obs = _equirect_frames()
        slam = make_filter(cfg.filter, cfg.frontend)
    else:
        model = "stereo_3d" if name == "config3_fs2_stereo" else "pinhole_3d"
        cfg, init, odom, obs = _vision_frames(model, {} if model == "stereo_3d"
                                              else CONFIG2_FILTER)
        slam = make_filter(cfg.filter, cfg.frontend)
        if name == "config2_system_frame":
            sys_ = system.SLAMSystem(cfg, device="cpu", capture=False)
            return slam, None, list(zip(odom, obs)), sys_
    return slam, slam.init_state(init_pose=init, device="cpu"), list(zip(odom, obs)), None


FILTERS = ["corridor_fs1", "config2_fs2_pinhole", "config3_fs2_stereo", "equirect_fs1",
           "bearing_fs1", "bearing_velocity_fs2", "config2_system_frame"]


@pytest.mark.parametrize("name", FILTERS)
def test_step_reads_nothing_on_the_host(name):
    slam, state, frames, sys_ = _filter_case(name)
    gen = torch.Generator().manual_seed(0)
    if sys_ is not None:
        slam = sys_.slam
        state = sys_.state
    noise, u0 = draw_noise(len(frames), slam.cfg.num_particles, slam.noise_dim, gen, "cpu")

    def step(t, state):
        u, obs = frames[t]
        if sys_ is None:
            state, m = slam.step(state, u, obs, noise[t], u0[t])
            return state, (slam.estimate_pose(state), m)
        x = {"u": u, "obs": obs, "noise": noise[t], "u0": u0[t], "has_kf": sys_._has_kf_dev}
        (state, _), out = sys_._frame((state, sys_._last_kf_dev), x)
        return state, out

    state, _ = step(0, state)  # the warm-up: the constants reach the device
    before = state.lm_valid.sum()
    with pytest.MonkeyPatch.context() as mp:
        no_host_reads(mp)
        state, out = step(1, state)
    assert state.lm_valid.sum() >= before > 0
    assert all(torch.isfinite(t).all() for t in captured.leaves(out) if t.is_floating_point())


def test_the_guard_refuses_host_reads():
    x = torch.arange(4)
    with pytest.MonkeyPatch.context() as mp:
        no_host_reads(mp)
        for read in (lambda: bool(x[0] > 1), lambda: x.sum().item(), lambda: x[x > 1],
                     lambda: x[torch.argmax(x)], lambda: torch.tensor([1.0]), lambda: int(x[1]),
                     lambda: x.tolist()):
            with pytest.raises(HostRead):
                read()
        assert torch.equal(x.index_select(0, torch.argmax(x).reshape(1)), x[3:])


# -- (b) the captured path's buffers against the eager loop ----------------------


def _corridor_run(frames=24):
    """A corridor whose ESS crosses the threshold both ways (resample_frac
    0.1): frames with and without a resample."""
    sim = make_corridor(num_landmarks=30, num_steps=frames, max_obs=8, seed=3)
    slam = make_filter(FilterConfig(**SMALL, resample_frac=0.1))
    noise, u0 = draw_noise(frames, 16, 3, torch.Generator().manual_seed(0), "cpu")
    return slam, slam.init_state(init_pose=sim.gt_pose[0], device="cpu"), \
        cli.sim_tensors(sim, "cpu"), noise, u0


def test_captured_run_sequence_equals_the_eager_loop():
    slam, state0, data, noise, u0 = _corridor_run()
    eager = run_sequence(slam, state0, *data, motion_noise=noise, resample_u0=u0, capture=False)
    res = [bool(m.resampled) for m in eager[2]]
    assert 0 < sum(res) < len(res), res  # both kinds of frame
    for run in (1, 2):  # the second replays the filter's held step
        final, est, metrics = run_sequence(slam, state0, *data, motion_noise=noise,
                                           resample_u0=u0, capture=True)
        _assert_states_equal(final, eager[0], f"run {run}")
        assert torch.equal(est, eager[1])
        for m, e in zip(metrics, eager[2]):
            for k in ("ess", "num_landmarks", "match_frac", "resampled"):
                assert torch.equal(getattr(m, k), getattr(e, k)), k
    assert not state0.lm_valid.any()  # the input state is left alone
    # default on the CPU: the eager loop
    _assert_states_equal(run_sequence(slam, state0, *data, motion_noise=noise,
                                      resample_u0=u0)[0], eager[0], "default")


def test_captured_step_buffers_frame_by_frame():
    slam, state0, (odom, z, sig, valid), noise, u0 = _corridor_run()
    W0 = torch.zeros(8, 0, dtype=torch.int32)

    def fn(state, x):
        state, m = slam.step(state, x["u"], x["obs"], x["noise"], x["u0"])
        return state, (slam.estimate_pose(state), m)

    obs = lambda t: Observation(z=z[t], sig=sig[t], desc=W0, valid=valid[t])  # noqa: E731
    x = {"u": odom[0].clone(), "obs": captured.clone(obs(0)), "noise": noise[0].clone(),
         "u0": u0[0].clone()}
    cs = captured.CapturedStep(fn, state0.clone(), x, graph=False)
    ptrs = [t.data_ptr() for t in captured.leaves(cs.state)]
    eager, out_prev, est_prev, held = state0.clone(), None, None, 0
    for t in range(len(odom)):
        captured.copy_into(cs.inputs, {"u": odom[t], "obs": obs(t), "noise": noise[t],
                                       "u0": u0[t]})
        lw_before = cs.state.log_w.clone()
        out = cs()
        eager, m = slam.step(eager, odom[t], obs(t), noise[t], u0[t])
        _assert_states_equal(cs.state, eager, f"frame {t}")
        assert torch.equal(out[0], slam.estimate_pose(eager))
        assert [t_.data_ptr() for t_ in captured.leaves(cs.state)] == ptrs
        if out_prev is not None:  # the outputs are overwritten, not reallocated
            assert out is out_prev and not torch.equal(est_prev, out[0])
        out_prev, est_prev = out, out[0].clone()
        if not bool(m.resampled):
            held += 1
            assert not bool(out[1].resampled)
            assert not torch.equal(cs.state.log_w, torch.zeros_like(lw_before))
        else:
            assert torch.equal(cs.state.log_w, torch.zeros_like(lw_before))
    assert held > 0


def test_captured_step_refuses_cpu_buffers_for_a_graph():
    with pytest.raises(ValueError, match="CUDA"):
        captured.CapturedStep(lambda s, x: (s, ()), torch.zeros(2), {}, graph=True)
    with pytest.raises(ValueError, match="into"):
        captured.copy_into((torch.zeros(2),), (torch.zeros(3),))


# -- (c) JAX parity of the captured runner ---------------------------------------


def _jax_draws(key, T_, P, dim):
    """run_sequence's draws: keys = split(key, T); per frame k1, k2 =
    split(keys[t]); normal(k1, (P, dim)); uniform(k2, (), 0, 1/P)."""
    noise, u0 = [], []
    for k in jax.random.split(key, T_):
        k1, k2 = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k1, (P, dim))))
        u0.append(float(jax.random.uniform(k2, (), minval=0.0, maxval=1.0 / P)))
    return torch.as_tensor(np.stack(noise)), torch.tensor(u0, dtype=torch.float32)


def test_captured_corridor_matches_jax_with_injected_draws():
    """tests/test_torch_slice.py's parity run, through the captured path."""
    sim = make_corridor(num_landmarks=30, num_steps=40, max_obs=8, seed=3)
    key = jax.random.PRNGKey(0)
    jslam = j_make_filter(JFilterConfig(**SMALL, use_pallas=False))
    j_final, j_est, j_met = j_run_sequence(
        jslam, jslam.init_state(init_pose=jnp.asarray(sim.gt_pose[0])),
        jnp.asarray(sim.odom), jnp.asarray(sim.obs_z), jnp.asarray(sim.obs_sig),
        jnp.asarray(sim.obs_valid), key,
    )
    noise, u0 = _jax_draws(key, 40, 16, 3)
    slam = make_filter(FilterConfig(**SMALL))
    final, est, metrics = run_sequence(
        slam, slam.init_state(init_pose=sim.gt_pose[0], device="cpu"),
        *cli.sim_tensors(sim, "cpu"), motion_noise=noise, resample_u0=u0, capture=True)
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), atol=1e-4)
    np.testing.assert_array_equal(final.lm_valid.numpy(), np.asarray(j_final.lm_valid))
    np.testing.assert_allclose(final.log_w.numpy(), np.asarray(j_final.log_w), atol=1e-3)
    assert [bool(m.resampled) for m in metrics] == [bool(r) for r in np.asarray(j_met.resampled)]


def test_captured_fastslam2_stereo_matches_jax_with_injected_draws():
    """tests/test_torch_fastslam2.py's config-3 run (FastSLAM 2.0 stereo_3d,
    the KITTI weight shaping), through the captured path."""
    frames = 3
    ov = {**SMALL_3D, "filter.algorithm": "fastslam2"}
    cfg = load_config("configs/kitti_00.yaml", ov)
    jcfg = j_load_config("configs/kitti_00.yaml", {**ov, "filter.use_pallas": False,
                                                   "filter.fs2_association": "hoisted"})
    world = make_drive_world(num_steps=frames + 1)
    obs = [drive_observations(world, t, 32, 8, seed=0) for t in range(frames)]
    z, desc, valid = (np.stack([o[i] for o in obs]) for i in range(3))
    key = jax.random.PRNGKey(5)
    jslam = j_make_filter(jcfg.filter, jcfg.frontend)
    j_final, j_est, j_met = j_run_sequence(
        jslam, jslam.init_state(init_pose=jnp.asarray(world.gt_pose[0])),
        jnp.asarray(world.odom[:frames]), jnp.asarray(z), jnp.zeros((frames, 32, 0)),
        jnp.asarray(valid), key, obs_desc=jnp.asarray(desc))
    slam = make_filter(cfg.filter, cfg.frontend)
    noise, u0 = _jax_draws(key, frames, 16, 6)
    final, est, metrics = run_sequence(
        slam, slam.init_state(init_pose=world.gt_pose[0], device="cpu"),
        T(world.odom[:frames]), T(z), torch.zeros(frames, 32, 0), T(valid),
        motion_noise=noise, resample_u0=u0, obs_desc=T(desc.view(np.int32)), capture=True)
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), atol=1e-4)
    back = state_from_numpy(j_final, device="cpu")
    for k in ("lm_valid", "lm_count", "lm_desc"):
        assert torch.equal(getattr(final, k), getattr(back, k)), k
    vm = final.lm_valid
    np.testing.assert_allclose(final.lm_mean[vm].numpy(), back.lm_mean[vm].numpy(), atol=1e-3)
    np.testing.assert_allclose(final.log_w.numpy(), back.log_w.numpy(), rtol=1e-4, atol=1e-3)
    assert [bool(m.resampled) for m in metrics] == [bool(r) for r in np.asarray(j_met.resampled)]


# -- (d) the system through its static buffers -------------------------------------

SYS_FRAMES = 10
CORRECT_AT = 5   # the forced pose-graph correction, after this many frames
SAVE_AT = 7      # the snapshot, after this many frames


def _config2_system_cfg():
    """Config 2 (configs/tum_fr1_desk.yaml: FastSLAM 2.0, pinhole_3d, its
    weight shaping) cut to P=16, L=128, Z=16 on 96x128 desk frames."""
    cfg = load_config("configs/tum_fr1_desk.yaml", {
        "filter.num_particles": 16, "filter.max_landmarks": 128, "filter.max_observations": 16,
        "frontend.max_features": 32, "frontend.image_size": [96, 128],
        "frontend.intrinsics": [103.46, 103.3, 63.72, 51.06],
        "backend.keyframe_translation": 0.05, "backend.max_keyframes": 32})
    return cfg


@pytest.fixture(scope="module")
def desk():
    from parakeet_slam_tpu_torch.data.synth_vision import make_desk_world

    cfg = _config2_system_cfg()
    world = make_desk_world(num_landmarks=300, num_steps=60, image_size=(96, 128),
                            intrinsics=tuple(cfg.frontend.intrinsics))
    images = [world.render(i) for i in range(SYS_FRAMES)]
    return cfg, images, cli._make_odometry(cfg.data, world.gt_pose, SYS_FRAMES)


def _correct(sys_):
    """A pose-graph correction: a loop edge 0 -> last keyframe that
    disagrees with the chain by 5 cm, optimized and applied to the state."""
    k = len(sys_.keyframes) - 1
    rel = geometry.se3_between(sys_.graph.poses[0], sys_.graph.poses[k])
    rel = rel + torch.tensor([0.05, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    sys_.graph = graph_mod.add_edge(sys_.graph, 0, k, rel, info=[100.0] * 6)
    sys_._optimize_and_correct()


def test_captured_system_equals_the_eager_system(desk, tmp_path):
    cfg, images, odom = desk
    eager = system.SLAMSystem(cfg, device="cpu", capture=False)
    static = system.SLAMSystem(cfg, device="cpu", capture=True)
    assert not eager.capture and static.capture
    buffers = [t.data_ptr() for t in captured.leaves((static.state, static._last_kf_dev))]
    prefix = str(tmp_path / "snap")
    for t in range(SYS_FRAMES):
        if t == SAVE_AT:  # a round trip into a fresh captured system
            static.save_checkpoint(prefix)
            static = system.SLAMSystem(cfg, device="cpu", capture=True)
            static.load_checkpoint(prefix)
            buffers = [t_.data_ptr() for t_ in
                       captured.leaves((static.state, static._last_kf_dev))]
        a = eager.process_frame(images[t], odom[t])
        b = static.process_frame(images[t], odom[t])
        assert torch.equal(a, b), f"frame {t}: estimates differ"
        if t + 1 == CORRECT_AT:
            assert len(eager.keyframes) >= 2
            pose = eager.state.pose.clone()
            _correct(eager)
            _correct(static)
            assert not torch.equal(pose, eager.state.pose)  # the correction moved it
        _assert_states_equal(static.state, eager.state, f"frame {t}")
        assert torch.equal(static._last_kf_dev, eager._last_kf_dev), f"frame {t}"
        assert bool(static._has_kf_dev) == static._has_kf == eager._has_kf
        # the state lives in the static buffers: written, never rebound
        assert [t_.data_ptr() for t_ in
                captured.leaves((static.state, static._last_kf_dev))] == buffers
    for s in (eager, static):
        s.flush_flags()
        s.flush_metrics()
    assert [(k.index, k.frame, k.pose.tobytes(), k.points_kf.tobytes(), k.desc.tobytes())
            for k in static.keyframes] == \
        [(k.index, k.frame, k.pose.tobytes(), k.points_kf.tobytes(), k.desc.tobytes())
         for k in eager.keyframes]
    assert torch.equal(static.graph.poses, eager.graph.poses)
    assert static._frame_steps and not eager._frame_steps
    # an estimate a caller keeps is its own copy, not a static output
    est = [static.process_frame(images[i], odom[i]) for i in range(2)]
    assert not torch.equal(est[0], est[1])


def test_capture_is_refused_on_the_sharded_path(desk, monkeypatch, tmp_path, one_thread):
    """The sharded system no longer refuses capture=True: on the 1 x 1 mesh
    (no process group; every collective the identity) the captured sharded
    system equals the eager sharded system and the one-device system bit
    for bit, its state written into its static buffers, across a
    save/load round trip into a fresh captured sharded system. The
    2-rank case is tests/test_torch_config5.py's."""
    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM

    cfg, images, odom = desk
    one = system.SLAMSystem(cfg, device="cpu", capture=False)
    monkeypatch.setattr(system.SLAMSystem, "_make_mesh",
                        lambda self, d: (lambda m: (m, ShardedFastSLAM(self.slam, m)))(
                            mesh_mod.make_mesh()))
    eager = system.SLAMSystem(cfg, device="cpu", capture=False)
    static = system.SLAMSystem(cfg, device="cpu", capture=True)
    assert static._sharded is not None and static.capture and not eager.capture
    prefix = str(tmp_path / "snap")
    for t in range(SYS_FRAMES):
        if t == SAVE_AT:
            static.save_checkpoint(prefix)
            static = system.SLAMSystem(cfg, device="cpu", capture=True)
            static.load_checkpoint(prefix)
        buffers = [t_.data_ptr() for t_ in captured.leaves((static.state, static._last_kf_dev))]
        a, b, c = (s.process_frame(images[t], odom[t]) for s in (eager, static, one))
        assert torch.equal(a, b) and torch.equal(a, c), f"frame {t}: estimates differ"
        _assert_states_equal(static.state, eager.state, f"frame {t}")
        _assert_states_equal(static.state, one.state, f"frame {t}")
        assert [t_.data_ptr() for t_ in
                captured.leaves((static.state, static._last_kf_dev))] == buffers
    assert static._frame_steps and not eager._frame_steps
