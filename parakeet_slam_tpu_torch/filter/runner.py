"""Sequence runner: the SLAM step over a whole prerecorded sequence
(port of `parakeet_slam_tpu.filter.runner`).

The reference scans one jitted step over the sequence; here it is a Python
loop over frames. The per-frame random draws (the motion or proposal noise
[P, noise_dim] and the resampling comb offset u0) come from an explicit
`torch.Generator`, or are injected, so that a test can replay the
reference's exact draws.
"""

from __future__ import annotations

import torch

from parakeet_slam_tpu_torch.core.state import Observation, ParticleState
from parakeet_slam_tpu_torch.filter.fastslam import FastSLAM


def draw_noise(num_steps: int, num_particles: int, dim: int, generator: torch.Generator,
               device):
    """(noise [T, P, dim] standard normals, resample_u0 [T] in [0, 1/P))."""
    noise = torch.randn(num_steps, num_particles, dim, generator=generator, device=device)
    u0 = torch.rand(num_steps, generator=generator, device=device) / num_particles
    return noise, u0


def run_sequence(
    slam: FastSLAM,
    state: ParticleState,
    odom: torch.Tensor,       # [T, u_dim]
    obs_z: torch.Tensor,      # [T, Z, Dz]
    obs_sig: torch.Tensor,    # [T, Z, S]
    obs_valid: torch.Tensor,  # [T, Z]
    generator: torch.Generator | None = None,
    motion_noise: torch.Tensor | None = None,  # [T, P, slam.noise_dim]
    resample_u0: torch.Tensor | None = None,   # [T]
    obs_desc: torch.Tensor | None = None,      # [T, Z, W] int32 packed descriptors
):
    """Run the filter over a sequence; returns (final_state, est [T, pose_dim],
    metrics: list of per-frame StepMetrics). `state` is not modified."""
    T, Z = obs_valid.shape
    P = state.num_particles
    dev = state.pose.device
    if motion_noise is None or resample_u0 is None:
        if generator is None:
            raise ValueError("run_sequence needs a generator or injected draws")
        noise, u0 = draw_noise(T, P, slam.noise_dim, generator, dev)
        motion_noise = noise if motion_noise is None else motion_noise
        resample_u0 = u0 if resample_u0 is None else resample_u0
    if obs_desc is None:
        obs_desc = torch.zeros(T, Z, 0, dtype=torch.int32, device=dev)
    state = state.clone()
    est, metrics = [], []
    for t in range(T):
        obs = Observation(z=obs_z[t], sig=obs_sig[t], desc=obs_desc[t], valid=obs_valid[t])
        state, m = slam.step(state, odom[t], obs, motion_noise[t], resample_u0[t])
        est.append(slam.estimate_pose(state))
        metrics.append(m)
    return state, torch.stack(est), metrics
