"""The port's EuRoC path (benchmark config 4) against the JAX package: the
loader on the reference's hand-written fixture, the machine-hall world, the
ASL writer (CSV text equal, PNGs equal pixel for pixel), and the
multi-session runner on `tests/test_euroc_multisession.py`'s fixture (two
sessions of 10 frames at 64x96, P=8): alone through `cli run --ba 2
--device cpu`, and under JAX's own draws beside the JAX runner, where the
estimates agree within atol=1e-3 (a filter run; float sums in another
order), the keyframe frames are equal and the joint BA's costs agree within
rtol=1e-3 (as `test_build_ba_problem_and_run_ba_match_jax` holds them)."""

import argparse

import jax
import numpy as np
import pytest

from parakeet_slam_tpu import cli as j_cli
from parakeet_slam_tpu.backend import ba as j_ba
from parakeet_slam_tpu.core import config as jcm
from parakeet_slam_tpu.data import synth_vision as j_sv
from parakeet_slam_tpu.data.euroc import load_euroc as j_load_euroc
from parakeet_slam_tpu.system import SLAMSystem as JSystem
from parakeet_slam_tpu_torch import cli
from parakeet_slam_tpu_torch.core import config as pcm
from parakeet_slam_tpu_torch.data import synth_vision as p_sv
from parakeet_slam_tpu_torch.data.euroc import load_euroc, load_multi_session
from parakeet_slam_tpu_torch.filter import make_filter

cv2 = pytest.importorskip("cv2")

S = 96 / 752
INTR = (458.654 * S, 457.296 * S, 367.215 * S, 248.375 * S)
STEPS = 10


def test_euroc_fixture(tmp_path):
    """tests/test_utils.py's hand-written ASL directory: the qw-first ground
    truth reordered to xyzw, matched within max_dt."""
    root = tmp_path / "MH01"
    data_dir = root / "mav0" / "cam0" / "data"
    data_dir.mkdir(parents=True)
    gt_dir = root / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True)
    cv2.imwrite(str(data_dir / "100.png"), np.zeros((16, 16), np.uint8))
    (root / "mav0" / "cam0" / "data.csv").write_text("#ts,filename\n1000000000,100.png\n")
    (gt_dir / "data.csv").write_text("#hdr\n1000000100,1.0,2.0,3.0,1.0,0.0,0.0,0.0\n")
    seq, j_seq = load_euroc(str(root)), j_load_euroc(str(root))
    assert len(seq) == 1
    np.testing.assert_allclose(seq.gt_pose[0], [1, 2, 3, 0, 0, 0, 1])
    np.testing.assert_array_equal(seq.gt_pose, j_seq.gt_pose)
    np.testing.assert_array_equal(seq.timestamps, j_seq.timestamps)
    np.testing.assert_array_equal(seq.image(0), j_seq.image(0))
    assert seq.intrinsics == j_seq.intrinsics


def _hall(sv, session, **kw):
    kw = {"num_landmarks": 400, "num_steps": STEPS, "image_size": (64, 96), "intrinsics": INTR,
          "seed": 30, **kw}
    return sv.make_hall_world(session=session, **kw)


@pytest.mark.parametrize("session", [0, 2])
def test_hall_world_matches_jax(session):
    """The landmarks equal bit for bit (numpy, one stream); poses and
    odometry within 1e-6 and 1e-5 (float32 torch against jnp, as the other
    worlds' tests hold them); a rendered frame within 1e-5."""
    tw, jw = _hall(p_sv, session), _hall(j_sv, session)
    np.testing.assert_array_equal(tw.landmarks, jw.landmarks)
    np.testing.assert_allclose(tw.gt_pose, jw.gt_pose, atol=1e-6)
    np.testing.assert_allclose(tw.odom, jw.odom, atol=1e-5)
    np.testing.assert_allclose(tw.render(3), jw.render(3), atol=1e-5)
    assert (tw.image_size, tw.intrinsics, tw.baseline, tw.max_render_range) == \
           (jw.image_size, jw.intrinsics, jw.baseline, jw.max_render_range)
    # sessions share the world, not the trajectory
    other = _hall(p_sv, session + 1)
    np.testing.assert_array_equal(other.landmarks, tw.landmarks)
    assert np.abs(other.gt_pose[:, :3] - tw.gt_pose[:, :3]).max() > 0.5


def test_euroc_writer_matches_jax(tmp_path):
    """Each package writes its own hall world: the CSVs are the same text
    and the PNGs the same pixels; both loaders read either directory alike,
    the ground truth back within the writer's 6 decimals."""
    p_root = p_sv.write_euroc_format(_hall(p_sv, 1, num_steps=4), str(tmp_path / "p" / "MH02"))
    j_root = j_sv.write_euroc_format(_hall(j_sv, 1, num_steps=4), str(tmp_path / "j" / "MH02"))
    for rel in ("mav0/cam0/data.csv", "mav0/state_groundtruth_estimate0/data.csv"):
        assert (tmp_path / "p" / "MH02" / rel).read_text() == \
               (tmp_path / "j" / "MH02" / rel).read_text(), rel
    p_seq, j_seq = load_multi_session([p_root])[0], j_load_euroc(j_root)
    assert len(p_seq) == len(j_seq) == 4 and p_seq.image_files == j_seq.image_files
    for i in range(4):
        a, b = p_seq.image(i), j_seq.image(i)
        assert a.shape == (64, 96) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p_seq.gt_pose, j_load_euroc(p_root).gt_pose)
    np.testing.assert_allclose(p_seq.gt_pose, _hall(p_sv, 1, num_steps=4).gt_pose, atol=2e-5)


# -- the multi-session runner -----------------------------------------------------


CFG_YAML = """
name: euroc_test
data:
  dataset: euroc
  path: {root}
  odom_source: gt
  odom_noise: [0.005, 0.002]
filter:
  num_particles: 8
  max_landmarks: 128
  max_observations: 12
  lm_dim: 3
  obs_dim: 2
  pose_dim: 7
  desc_words: 8
  measurement_model: pinhole_3d
  motion_model: se3_odometry
  motion_noise: [0.02, 0.01]
  meas_noise: [2.0, 2.0]
  init_range_prior: 5.0
  init_range_sigma: 3.0
  max_range: 16.0
frontend:
  max_features: 24
  fast_threshold: 0.08
  camera: pinhole
  intrinsics: [{i[0]}, {i[1]}, {i[2]}, {i[3]}]
  image_size: [64, 96]
backend:
  max_keyframes: 32
  max_landmarks: 256
  keyframe_translation: 0.6
  gn_iters: 2
  pcg_iters: 10
  solver: pcg
checkpoint_dir: {ckpt}
"""


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """tests/test_euroc_multisession.py's two sessions, written once by the
    port's writer, and its configuration file."""
    root = tmp_path_factory.mktemp("euroc")
    for k in range(2):
        p_sv.write_euroc_format(_hall(p_sv, k), str(root / f"MH{k + 1:02d}"))
    (root / "ckpt").mkdir()
    cfg = root.parent / f"{root.name}.yaml"
    cfg.write_text(CFG_YAML.format(root=root, i=INTR, ckpt=root / "ckpt"))
    return root, cfg


def test_runner_carries_state_and_runs_joint_ba(sessions, capsys):
    root, cfg = sessions
    traj = root.parent / f"{root.name}_traj.txt"
    cli.main(["run", "--config", str(cfg), "--ba", "2", "--device", "cpu", "--out", str(traj)])
    out = capsys.readouterr().out
    assert "sessions=2 frames=20" in out
    assert "BA: points=" in out and "iters/s=" in out and "ate_ba=" in out
    assert (root / "ckpt" / "session_01.kf.npz").exists()
    assert (root / "ckpt" / "session_01.state.npz").exists()
    rows = np.loadtxt(traj)
    assert rows.shape == (20, 8) and np.isfinite(rows).all()


def test_single_session_and_synth(sessions, tmp_path, capsys):
    """One session directory runs through `cli run`'s image loop; `synth
    --kind euroc --sessions 2` writes MH01 and MH02 of one hall."""
    root, cfg = sessions
    cli.main(["run", "--config", str(cfg), "--device", "cpu", "--frames", "6",
              "--set", f"data.path={root / 'MH01'}"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("frames=6 keyframes=") and "ate_rmse=" in line, line
    cli.main(["synth", "--kind", "euroc", "--sessions", "2", "--steps", "2", "--landmarks", "50",
              "--out", str(tmp_path)])
    seqs = load_multi_session(cli.euroc_sessions(str(tmp_path)))
    assert [len(s) for s in seqs] == [2, 2]
    assert seqs[0].image(0).shape == (480, 752)


def _system_draws(seed, n, P, dim):
    """The JAX system's per-frame draws (tests/test_torch_system.py): the
    key runs through the snapshot at the session boundary, so the draws of
    all sessions are one stream."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        k_step, key = jax.random.split(key)
        k1, k2 = jax.random.split(k_step)
        out.append((np.array(jax.random.normal(k1, (P, dim))),
                    float(jax.random.uniform(k2, (), minval=0.0, maxval=1.0 / P))))
    return out


def test_runner_matches_jax_under_its_draws(sessions, monkeypatch, capsys):
    root, cfg_path = sessions
    roots = cli.euroc_sessions(str(root))
    j_cfg = jcm.load_config(str(cfg_path))
    j_est, j_sys, j_costs = [], [], []
    frame = JSystem.process_frame
    build = JSystem.build_ba_problem
    solve = j_ba.optimize_ba

    def record_frame(self, *a, **kw):
        out = frame(self, *a, **kw)
        j_est.append(np.asarray(out))
        return out

    def record_build(self, *a, **kw):
        j_sys.append(self)
        return build(self, *a, **kw)

    def record_solve(*a, **kw):
        res = solve(*a, **kw)
        j_costs.append(np.asarray(res.costs))
        return res

    monkeypatch.setattr(JSystem, "process_frame", record_frame)
    monkeypatch.setattr(JSystem, "build_ba_problem", record_build)
    monkeypatch.setattr(j_ba, "optimize_ba", record_solve)
    args = argparse.Namespace(frames=0, ba=2, out="")
    j_cli._run_euroc_multisession(j_cfg, args, roots)
    j_line = capsys.readouterr().out.strip().splitlines()[-1]

    p_cfg = pcm.load_config(str(cfg_path))
    noise_dim = make_filter(p_cfg.filter, p_cfg.frontend).noise_dim
    draws = _system_draws(p_cfg.filter.seed, 2 * STEPS, p_cfg.filter.num_particles, noise_dim)
    run = cli._run_euroc_multisession(p_cfg, args, roots, "cpu", draws=draws)
    p_line = capsys.readouterr().out.strip().splitlines()[-1]
    p_sys = run["system"]
    assert p_line.split(" | ")[0].split(" fps=")[0] == j_line.split(" | ")[0].split(" fps=")[0]
    np.testing.assert_allclose(run["est"], np.stack(j_est), atol=1e-3)
    assert [k.frame for k in p_sys.keyframes] == [k.frame for k in j_sys[-1].keyframes]
    assert p_sys.loop_closures == [tuple(int(x) for x in c) for c in j_sys[-1].loop_closures]
    res, prob, _ = run["ba"]
    assert len(j_costs) == 2  # JAX's warm-up solve and its timed one
    np.testing.assert_allclose(res.costs.numpy(), j_costs[-1], rtol=1e-3)
