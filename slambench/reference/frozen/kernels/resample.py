"""Systematic (low-variance) resampling: index computation + state gather
(port of `parakeet_slam_tpu.kernels.resample`).

One uniform draw u0 ~ U[0, 1/P), comb positions u0 + i/P, inverse-CDF
lookup, then a gather of the full per-particle state. The indices are plain
torch ops (XLA in the reference); the gather is `kernels/resample_cuda.py`,
the hand kernel on CUDA tensors and its plain twin on CPU tensors.
"""

from __future__ import annotations

import torch

from slambench.reference.frozen.core.state import ParticleState
from slambench.reference.frozen.kernels import resample_cuda


def systematic_resample_indices(log_w: torch.Tensor, u0) -> torch.Tensor:
    """Low-variance resampling indices [P] (int64) from log-weights [P] and
    the comb offset u0 in [0, 1/P). Monotone non-decreasing."""
    P = log_w.shape[0]
    w = torch.softmax(log_w, dim=0)
    cdf = torch.cumsum(w, dim=0)
    positions = u0 + torch.arange(P, dtype=w.dtype, device=w.device) / P
    # side="left" of jnp.searchsorted is right=False
    idx = torch.searchsorted(cdf, positions, right=False)
    return torch.clamp(idx, 0, P - 1)


def gather_particles(state: ParticleState, idx: torch.Tensor) -> ParticleState:
    """The full particle state gathered at `idx`, weights reset to 0."""
    return resample_cuda.gather_state(state, idx)


def effective_sample_size(log_w: torch.Tensor) -> torch.Tensor:
    w = torch.softmax(log_w, dim=0)
    return 1.0 / torch.sum(w * w)
