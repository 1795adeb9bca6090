"""Sequence runner: the SLAM step over a whole prerecorded sequence
(port of `parakeet_slam_tpu.filter.runner`).

The reference scans one jitted step over the sequence; here it is a Python
loop over frames. The per-frame random draws (odometry noise [P, 3] and the
resampling comb offset u0) come from an explicit `torch.Generator`, or are
injected, so that a test can replay the reference's exact draws.
"""

from __future__ import annotations

import torch

from parakeet_slam_tpu_torch.core.state import Observation, ParticleState
from parakeet_slam_tpu_torch.filter.fastslam import FastSLAM


def draw_noise(num_steps: int, num_particles: int, generator: torch.Generator, device):
    """(motion_noise [T, P, 3] standard normals, resample_u0 [T] in [0, 1/P))."""
    noise = torch.randn(num_steps, num_particles, 3, generator=generator, device=device)
    u0 = torch.rand(num_steps, generator=generator, device=device) / num_particles
    return noise, u0


def run_sequence(
    slam: FastSLAM,
    state: ParticleState,
    odom: torch.Tensor,       # [T, 3]
    obs_z: torch.Tensor,      # [T, Z, 2]
    obs_sig: torch.Tensor,    # [T, Z, S]
    obs_valid: torch.Tensor,  # [T, Z]
    generator: torch.Generator | None = None,
    motion_noise: torch.Tensor | None = None,  # [T, P, 3]
    resample_u0: torch.Tensor | None = None,   # [T]
):
    """Run the filter over a sequence; returns (final_state, est [T, 3],
    metrics: list of per-frame StepMetrics). `state` is not modified."""
    T = odom.shape[0]
    P = state.num_particles
    dev = state.pose.device
    if motion_noise is None or resample_u0 is None:
        if generator is None:
            raise ValueError("run_sequence needs a generator or injected draws")
        noise, u0 = draw_noise(T, P, generator, dev)
        motion_noise = noise if motion_noise is None else motion_noise
        resample_u0 = u0 if resample_u0 is None else resample_u0
    desc = torch.zeros(obs_z.shape[1], 0, dtype=torch.int32, device=dev)
    state = state.clone()
    est, metrics = [], []
    for t in range(T):
        obs = Observation(z=obs_z[t], sig=obs_sig[t], desc=desc, valid=obs_valid[t])
        state, m = slam.step(state, odom[t], obs, motion_noise[t], resample_u0[t])
        est.append(slam.estimate_pose(state))
        metrics.append(m)
    return state, torch.stack(est), metrics
