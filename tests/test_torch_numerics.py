"""Twins of tests/test_numerics.py for the port: every state leaf finite
after 10 corridor frames (torch has no NaN-raising mode like
jax_debug_nans, so every leaf of every frame is checked), landmark
covariances positive definite and contracted after 60 frames, the scaling
harness at one rank, and `profiling.timed` (which needs the card)."""

import numpy as np
import pytest
import torch

from parakeet_slam_tpu_torch.core.config import FilterConfig
from parakeet_slam_tpu_torch.core.state import make_observation
from parakeet_slam_tpu_torch.data import make_corridor
from parakeet_slam_tpu_torch.filter import FastSLAM

CFG = dict(sig_dim=3, motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
           max_range=6.5, fov_half_angle=2.5)
LEAVES = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig")


def _run(sim, slam, steps, seed, each=None):
    P = slam.cfg.num_particles
    state = slam.init_state(init_pose=torch.as_tensor(sim.gt_pose[0]), device="cpu")
    g = torch.Generator().manual_seed(seed)
    for t in range(steps):
        obs = make_observation(torch.as_tensor(sim.obs_z[t]), sig=torch.as_tensor(sim.obs_sig[t]),
                               valid=torch.as_tensor(sim.obs_valid[t]), device="cpu")
        state, _ = slam.step(state, torch.as_tensor(sim.odom[t]), obs,
                             torch.randn(P, 3, generator=g), torch.rand((), generator=g) / P)
        if each is not None:
            each(t, state)
    return state


@pytest.mark.parametrize("generic", [False, True], ids=["kernel_twin", "generic"])
def test_filter_steps_stay_finite(generic):
    sim = make_corridor(num_landmarks=20, num_steps=10, max_obs=6, seed=2)
    slam = FastSLAM(FilterConfig(num_particles=16, max_landmarks=32, max_observations=6, **CFG))
    slam.kernel_2d = not generic

    def finite(t, st):
        for k in LEAVES:
            assert bool(torch.isfinite(getattr(st, k)).all()), (t, k)

    _run(sim, slam, 10, 0, finite)


@pytest.mark.parametrize("generic", [False, True], ids=["kernel_twin", "generic"])
def test_covariances_stay_pd(generic):
    sim = make_corridor(num_landmarks=30, num_steps=60, max_obs=8, seed=4)
    slam = FastSLAM(FilterConfig(num_particles=16, max_landmarks=64, max_observations=8, **CFG))
    slam.kernel_2d = not generic
    state = _run(sim, slam, 60, 1)
    eigs = np.linalg.eigvalsh(state.lm_cov[state.lm_valid].numpy())
    assert eigs.min() > -1e-6, eigs.min()
    assert np.median(eigs) < 0.05


def test_scaling_harness_smoke():
    from parakeet_slam_tpu_torch.eval.scaling import _filter_throughput

    fps, warm = _filter_throughput(1, particles_per_device=16, max_landmarks=64, steps=3,
                                   device="cpu")
    assert fps > 0 and len(warm) == 3


def test_profiling_timed_needs_the_card():
    """`timed` measures on the card; with no CUDA device it refuses rather
    than time the CPU."""
    from parakeet_slam_tpu_torch.eval.profiling import queued, timed

    if torch.cuda.is_available():
        ms, out = timed(lambda x: x * 2.0, torch.ones(8, device="cuda"), reps=3)
        assert ms > 0 and float(out[0]) == 2.0
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            timed(lambda x: x * 2.0, torch.ones(8), reps=3)
        with pytest.raises(RuntimeError, match="CUDA"):
            queued(lambda i: None)
