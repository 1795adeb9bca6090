"""Dense batched SLAM state containers (port of `parakeet_slam_tpu.core.state`).

The whole filter state is a struct of dense tensors over fixed capacities:
a particle axis P and a landmark-slot axis L with a validity mask. Layouts
and dtypes are those of the JAX package, so states carry across as numpy
arrays (`state_from_numpy` / `state_to_numpy`). Packed descriptors are
int32 words here (torch has thin uint32 support), the same bits as the
reference's uint32 words; the 2-D path keeps W=0.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

_FIELDS = (
    "pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_desc", "lm_valid", "lm_count",
)


@dataclass
class ParticleState:
    """FastSLAM filter state: P particles x L landmark slots.

      pose      [P, pose_dim]  float32 SE(2) [x, y, th] or SE(3) [t(3), q(4)]
      log_w     [P]            unnormalized log importance weights
      lm_mean   [P, L, Dl]     landmark EKF means
      lm_cov    [P, L, Dl, Dl] landmark EKF covariances
      lm_sig    [P, L, Ds]     appearance signature (running mean)
      lm_desc   [P, L, W]      packed binary descriptor words (int32), W may be 0
      lm_valid  [P, L]         slot occupancy mask (bool)
      lm_count  [P, L]         observation counter (int32) for culling
    """

    pose: torch.Tensor
    log_w: torch.Tensor
    lm_mean: torch.Tensor
    lm_cov: torch.Tensor
    lm_sig: torch.Tensor
    lm_desc: torch.Tensor
    lm_valid: torch.Tensor
    lm_count: torch.Tensor

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "ParticleState":
        """A deep copy (the CUDA update kernel writes its state in place)."""
        return ParticleState(**{f: getattr(self, f).clone() for f in _FIELDS})

    @property
    def num_particles(self) -> int:
        return self.pose.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.lm_valid.shape[1]

    def normalized_weights(self) -> torch.Tensor:
        return torch.softmax(self.log_w, dim=0)

    def effective_sample_size(self) -> torch.Tensor:
        w = self.normalized_weights()
        return 1.0 / torch.sum(w * w)

    def num_landmarks(self) -> torch.Tensor:
        """Per-particle live landmark count [P]."""
        return self.lm_valid.sum(dim=-1)


def make_particle_state(
    num_particles: int,
    max_landmarks: int,
    lm_dim: int = 2,
    sig_dim: int = 3,
    desc_words: int = 0,
    pose_dim: int = 3,
    init_pose=None,
    *,
    device: torch.device | str,
) -> ParticleState:
    """Allocate an empty filter state; all particles at `init_pose` (the
    origin by default, with the identity quaternion for SE(3))."""
    P, L = num_particles, max_landmarks
    f32 = dict(dtype=torch.float32, device=device)
    if init_pose is None:
        init_pose = torch.zeros(pose_dim, **f32)
        if pose_dim == 7:
            init_pose[6] = 1.0
    pose = torch.as_tensor(init_pose, **f32).reshape(1, pose_dim).repeat(P, 1)
    return ParticleState(
        pose=pose,
        log_w=torch.zeros(P, **f32),
        lm_mean=torch.zeros(P, L, lm_dim, **f32),
        lm_cov=torch.zeros(P, L, lm_dim, lm_dim, **f32),
        lm_sig=torch.zeros(P, L, sig_dim, **f32),
        lm_desc=torch.zeros(P, L, desc_words, dtype=torch.int32, device=device),
        lm_valid=torch.zeros(P, L, dtype=torch.bool, device=device),
        lm_count=torch.zeros(P, L, dtype=torch.int32, device=device),
    )


@dataclass
class Observation:
    """A frame's observation batch at fixed capacity Z.

    z [Z, Dz] float32, sig [Z, Ds] float32, desc [Z, W] int32, valid [Z] bool.
    """

    z: torch.Tensor
    sig: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    def replace(self, **kw) -> "Observation":
        return dataclasses.replace(self, **kw)

    @property
    def capacity(self) -> int:
        return self.z.shape[0]


def make_observation(z, sig=None, desc=None, valid=None, *, device) -> Observation:
    z = torch.as_tensor(np.asarray(z, np.float32), device=device)
    Z = z.shape[0]
    if sig is None:
        sig = np.zeros((Z, 0), np.float32)
    if desc is None:
        desc = np.zeros((Z, 0), np.int32)
    if valid is None:
        valid = np.ones((Z,), bool)
    return Observation(
        z=z,
        sig=torch.as_tensor(np.asarray(sig, np.float32), device=device),
        desc=torch.as_tensor(np.asarray(desc).astype(np.int32), device=device),
        valid=torch.as_tensor(np.asarray(valid, bool), device=device),
    )


def state_from_numpy(st, *, device) -> ParticleState:
    """Carry a state across from any object with the eight ParticleState
    fields as arrays (e.g. a JAX `ParticleState`). uint32 descriptor words
    are reinterpreted as int32."""
    out = {}
    for f in _FIELDS:
        a = np.asarray(getattr(st, f))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[f] = torch.tensor(a, device=device)  # a copy: JAX buffers are read-only
    return ParticleState(**out)


def state_to_numpy(st: ParticleState) -> dict[str, np.ndarray]:
    """The state's fields as numpy arrays (descriptor words back to uint32),
    keyed by field name: `jax_state.replace(**state_to_numpy(st))` carries
    it back."""
    out = {f: getattr(st, f).detach().cpu().numpy() for f in _FIELDS}
    out["lm_desc"] = out["lm_desc"].view(np.uint32)
    return out
