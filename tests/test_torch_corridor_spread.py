"""The corridor's ATE spread over 20 filter seeds: the port's twin path
against the JAX package's XLA path, both on the CPU (benchmark config 1:
P=64, L=192, Z=16, S=3, 500 frames of the seed-7 corridor).

The two draw their noise from different generators (torch.Generator and
jax.random), so each seed gives another sample of one ATE distribution, and
the comparison is of distributions: the ratio of the two sample variances
against the F distribution with (19, 19) degrees of freedom, two-sided. The
port's spread counts as wider than the reference's only beyond chance
(p < 0.05 with the port's variance the larger). Slow (about 7 minutes):

    python -m pytest tests/test_torch_corridor_spread.py -m slow -s
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.data import make_corridor as j_make_corridor
from parakeet_slam_tpu.eval import ate_rmse as j_ate_rmse
from parakeet_slam_tpu.filter import FastSLAM as JFastSLAM
from parakeet_slam_tpu.filter import run_sequence as j_run_sequence
from parakeet_slam_tpu_torch import cli

SEEDS = 20


def _jax_ates(n):
    sim = j_make_corridor(num_landmarks=100, num_steps=500, max_obs=16, seed=7)
    cfg = JFilterConfig(num_particles=64, max_landmarks=192, max_observations=16, sig_dim=3,
                        motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
                        sig_noise=0.5, max_range=6.5, fov_half_angle=2.5, use_pallas=False)
    slam = JFastSLAM(cfg)
    state0 = slam.init_state(init_pose=jnp.asarray(sim.gt_pose[0]))
    data = [jnp.asarray(a) for a in (sim.odom, sim.obs_z, sim.obs_sig, sim.obs_valid)]
    ates = []
    for s in range(n):
        _, est, _ = j_run_sequence(slam, state0, *data, jax.random.PRNGKey(s))
        ates.append(float(j_ate_rmse(np.asarray(est)[:, :2], sim.gt_pose[:, :2])))
    return np.array(ates)


@pytest.mark.slow
def test_port_spread_is_not_wider_than_the_reference():
    port = np.array(cli.measure_corridor(torch.device("cpu"), seeds=range(SEEDS))["ates"])
    ref = _jax_ates(SEEDS)
    F = port.var(ddof=1) / ref.var(ddof=1)
    cdf = stats.f.cdf(F, SEEDS - 1, SEEDS - 1)
    p = 2 * min(cdf, 1 - cdf)
    print(f"\ncorridor ATE over {SEEDS} seeds: port twin path {port.mean():.4f} +- "
          f"{port.std():.4f} m, JAX XLA path {ref.mean():.4f} +- {ref.std():.4f} m; "
          f"F = {F:.4f}, two-sided p = {p:.4f}")
    print("port", np.round(port, 4).tolist())
    print("jax ", np.round(ref, 4).tolist())
    assert (port < 0.5).all() and (ref < 0.5).all()
    assert not (F > 1 and p < 0.05), "the port's ATE spread is wider than the reference's"
