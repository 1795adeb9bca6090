"""The port's corridor slice as a whole: `run_sequence` against the JAX
`run_sequence` with JAX's own per-frame draws injected, the accuracy bound,
the CLI, and the rule that the port never imports jax."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.data import make_corridor
from parakeet_slam_tpu.filter import FastSLAM as JFastSLAM
from parakeet_slam_tpu.filter import run_sequence as j_run_sequence
from parakeet_slam_tpu_torch import cli
from parakeet_slam_tpu_torch.core.config import FilterConfig
from parakeet_slam_tpu_torch.eval import ate_rmse
from parakeet_slam_tpu_torch.filter import make_filter, run_sequence
from parakeet_slam_tpu_torch.kernels import ekf_update, resample_cuda

REPO = os.path.join(os.path.dirname(__file__), "..")
SMALL = dict(
    num_particles=16, max_landmarks=64, max_observations=8, sig_dim=3,
    motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
    max_range=6.5, fov_half_angle=2.5,
)


def _jax_draws(key, T, P):
    """The draws the JAX run_sequence makes: keys = split(key, T); per frame
    k_m, k_r = split(keys[t]); normal(k_m, (P, 3)); uniform(k_r, (), 0, 1/P)."""
    noise, u0 = [], []
    for k in jax.random.split(key, T):
        k_m, k_r = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_m, (P, 3))))
        u0.append(float(jax.random.uniform(k_r, (), minval=0.0, maxval=1.0 / P)))
    return torch.as_tensor(np.stack(noise)), torch.tensor(u0, dtype=torch.float32)


def _run_against_jax(**overrides):
    """The port's run_sequence and the JAX one on the same sim and draws."""
    sim = make_corridor(num_landmarks=30, num_steps=40, max_obs=8, seed=3)
    T, P = 40, SMALL["num_particles"]
    key = jax.random.PRNGKey(0)
    jslam = JFastSLAM(JFilterConfig(**SMALL, **overrides, use_pallas=False))
    j_final, j_est, _ = j_run_sequence(
        jslam, jslam.init_state(init_pose=jnp.asarray(sim.gt_pose[0])),
        jnp.asarray(sim.odom), jnp.asarray(sim.obs_z), jnp.asarray(sim.obs_sig),
        jnp.asarray(sim.obs_valid), key,
    )
    noise, u0 = _jax_draws(key, T, P)
    data = cli.sim_tensors(sim, "cpu")
    slam = make_filter(FilterConfig(**SMALL, **overrides, use_pallas=True))
    state0 = slam.init_state(init_pose=sim.gt_pose[0], device="cpu")
    final, est, metrics = run_sequence(slam, state0, *data, motion_noise=noise, resample_u0=u0)
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), atol=1e-4)
    np.testing.assert_array_equal(final.lm_valid.numpy(), np.asarray(j_final.lm_valid))
    np.testing.assert_allclose(final.log_w.numpy(), np.asarray(j_final.log_w), atol=1e-3)
    assert not state0.lm_valid.any()  # run_sequence leaves its input alone
    assert sum(m.resampled for m in metrics) > 0


def test_run_sequence_matches_jax_with_injected_draws():
    _run_against_jax()


def test_tempered_run_matches_jax():
    _run_against_jax(likelihood_temper=3.0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_filter_routes_through_kernel_wrappers(monkeypatch, use_pallas):
    """The filter calls the kernel wrappers whatever `use_pallas` says: the
    state's device alone picks kernel or twin, inside the wrappers."""
    calls = {"ekf": 0, "gather": 0}
    ekf, gather = ekf_update.measurement_update_2d, resample_cuda.gather_state

    def count_ekf(*a, **k):
        calls["ekf"] += 1
        return ekf(*a, **k)

    def count_gather(*a, **k):
        calls["gather"] += 1
        return gather(*a, **k)

    monkeypatch.setattr(ekf_update, "measurement_update_2d", count_ekf)
    monkeypatch.setattr(resample_cuda, "gather_state", count_gather)
    sim = make_corridor(num_landmarks=30, num_steps=20, max_obs=8, seed=3)
    slam = make_filter(FilterConfig(**SMALL, use_pallas=use_pallas))
    state0 = slam.init_state(init_pose=sim.gt_pose[0], device="cpu")
    gen = torch.Generator().manual_seed(0)
    _, _, metrics = run_sequence(slam, state0, *cli.sim_tensors(sim, "cpu"), generator=gen)
    assert calls["ekf"] == 20
    assert calls["gather"] == sum(m.resampled for m in metrics) > 0


def test_corridor_ate_bound():
    sim = make_corridor(num_landmarks=60, num_steps=150, max_obs=12, seed=7)
    cfg = FilterConfig(**{**SMALL, "num_particles": 64, "max_landmarks": 128,
                          "max_observations": 12}, sig_noise=0.5, use_pallas=True)
    before = (ekf_update.measurement_update_2d.launches, resample_cuda.gather_state.launches)
    run = cli.run_corridor(make_filter(cfg), sim, seed=0, device=torch.device("cpu"))
    est, ate = run["est"], run["ate"]
    assert est.shape == (150, 3) and torch.isfinite(est).all()
    assert ate < 0.5, f"corridor ATE regression: {ate}"
    assert float(ate_rmse(est[:, :2], sim.gt_pose[:, :2])) == pytest.approx(ate)
    assert 0 < run["resamples"] <= 150
    # no kernel launches on CPU tensors
    after = (ekf_update.measurement_update_2d.launches, resample_cuda.gather_state.launches)
    assert after == before


def test_cli_run_and_device_rule(capsys):
    cli.main(["run", "--config", os.path.join(REPO, "configs", "corridor.yaml"),
              "--device", "cpu", "--set", "data.num_steps=20"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("frames=20 ate_rmse=") and " fps=" in line
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            cli.main(["run", "--config", os.path.join(REPO, "configs", "corridor.yaml")])
    with pytest.raises(NotImplementedError):
        cli.main(["run", "--config", os.path.join(REPO, "configs", "kitti_00.yaml"),
                  "--device", "cpu"])


def test_bench_prints_bench_py_keys(capsys):
    cli.main(["bench", "--device", "cpu", "--steps", "15"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "ate_rmse_m", "ate_std_m"}
    assert out["metric"] == "corridor_online_fastslam_fps_per_chip"


def test_make_filter_refuses_unported_algorithms():
    """fastslam2 is ported; what the port lacks still raises: the 2-D
    models' XLA-only options, bearing_2d, and 3-D models with a float
    signature."""
    from parakeet_slam_tpu_torch.filter import FastSLAM2

    assert isinstance(make_filter(FilterConfig(algorithm="fastslam2")), FastSLAM2)
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_filter(FilterConfig(algorithm="fastslam3"))
    for kw in (dict(freeze_min_count=3), dict(measurement_model="bearing_2d", obs_dim=1),
               dict(measurement_model="pinhole_3d", lm_dim=3, pose_dim=7, sig_dim=2,
                    motion_model="se3_odometry"),
               dict(algorithm="fastslam2", fs2_association="hoisted")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_filter(FilterConfig(**kw))


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import parakeet_slam_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 24, names\n"
        "new = ('kernels.ekf_update_3d', 'filter.fastslam2', 'data.synth_vision', 'eval.bench_kernels')\n"
        "assert all(pkg.__name__ + '.' + m in names for m in new), names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'parakeet_slam_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
        "print('ok', len(names))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
