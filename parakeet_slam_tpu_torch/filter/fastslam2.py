"""FastSLAM 2.0: the measurement-informed proposal (port of
`parakeet_slam_tpu.filter.fastslam2`).

Per particle, a Gaussian over the pose tangent starts from the motion
model's mean and covariance and is EKF-updated by every observation that
associates with a known landmark; the pose is then sampled from it, and the
importance weight of a matched observation is N(z; zhat, Hx P Hx^T + Hm S
Hm^T + R). Pose Jacobians Hx = d h(pose (+) delta) / d delta at delta = 0
are each model's closed form (`pose_jac`), held to the reference's
`jax.jacfwd` in the tests. The landmark map pass then reuses the
FastSLAM 1.0 measurement core with its weight update off.

Association: "hoisted" scores the whole frame once at the motion-mean pose
(one `score_3d` sweep, or the generic scoring, reused by the map pass);
"sequential" re-associates each observation at the progressively refined
pose, appearance terms included. "auto" is hoisted on the vision models
that `score_3d` covers (no float signature) and sequential otherwise. The
refinement is sequential over the observations either way. Hoisted, on an
SE(3) motion model and a model that `kernels/propose_3d` covers (stereo_3d,
pinhole_3d), it is one `propose_3d` call: one kernel launch a frame on
CUDA, the loop `propose_3d.refine` on the CPU. Everywhere else it is that
loop of small [P, dt] tensor programs.
"""

from __future__ import annotations

import torch

from parakeet_slam_tpu_torch.core.config import FrontendConfig
from parakeet_slam_tpu_torch.core.state import Observation, ParticleState
from parakeet_slam_tpu_torch.filter import models as model_zoo
from parakeet_slam_tpu_torch.filter.fastslam import FastSLAM
from parakeet_slam_tpu_torch.kernels import propose_3d

_JITTER = 1e-9


class FastSLAM2(FastSLAM):
    """FastSLAM with the optimal (measurement-informed) proposal."""

    def __init__(self, cfg, fe_cfg=None):
        super().__init__(cfg, fe_cfg)
        self.motion_mean_cov, self.retract, self.tangent_dim = (
            model_zoo.get_motion_mean_cov(cfg.motion_model)
        )
        self.noise_dim = self.tangent_dim  # the proposal's draw replaces the motion draw
        # the fused refinement covers SE(3) poses on these camera models
        self.propose_kernel = self.tangent_dim == 6 and self.model.name in propose_3d.MODELS
        fe = fe_cfg or FrontendConfig()  # the constants the model was built with
        self._camera = (*(float(x) for x in fe.intrinsics[:4]), float(fe.baseline))

    # -- proposal stage -----------------------------------------------------

    def _pose_jacobian(self, pose, lm):
        """Hx = d h(pose (+) delta, lm) / d delta at delta = 0, [P, Dz, dt]:
        the model's closed form of the reference's jacfwd."""
        return self.model.pose_jac(pose, lm)

    def _hoist_association(self) -> bool:
        mode = getattr(self.cfg, "fs2_association", "auto")
        if mode == "auto":
            return self.kernel_3d
        return mode == "hoisted"

    def _associate(self, pose, state: ParticleState, obs: Observation, i: int):
        """Masked ML association of observation i at the given poses
        (sequential mode): (best [P], best_ll [P])."""
        one = Observation(z=obs.z[i:i + 1], sig=obs.sig[i:i + 1], desc=obs.desc[i:i + 1],
                          valid=obs.valid[i:i + 1])
        best, best_ll = self._frame_scores(state.replace(pose=pose), one)
        return best[:, 0], best_ll[:, 0]

    def _propose(self, state: ParticleState, u, obs: Observation, noise):
        """Refine a per-particle pose Gaussian with this frame's matched
        observations, then sample the poses from it with `noise` [P, dt]
        standard normals. The importance weights are fully determined here.
        Returns (state with sampled poses and log-weights, the (best, best_ll)
        scores for the map pass, None in sequential mode)."""
        c = self.cfg
        dev, dtype = state.pose.device, state.pose.dtype
        eye_t = torch.eye(self.tangent_dim, dtype=dtype, device=dev)
        kw = dict(log_p0=self._log_p0_assoc(),
                  unmatched_w=0.0 if c.weight_only_matched else c.new_landmark_loglik,
                  weight_min_count=c.weight_min_count)

        pose, P_cov = self.motion_mean_cov(state.pose, u, c.motion_noise)
        hoist = self._hoist_association()
        scores = self._frame_scores(state.replace(pose=pose), obs) if hoist else None
        any_valid = state.lm_valid.any(dim=-1)
        frame = (state.lm_mean, state.lm_cov, state.lm_count, any_valid, obs.z, obs.valid)
        if hoist and self.propose_kernel:
            pose, P_cov, log_w = propose_3d.propose_3d(
                pose, P_cov, state.log_w, *scores, *frame, measurement=self.model,
                retract=self.retract, camera=self._camera, r_var=self._meas_var(assoc=True),
                **kw)
        else:
            if hoist:
                assoc = lambda _, i: (scores[0][:, i].long(), scores[1][:, i])  # noqa: E731
            else:
                assoc = lambda pose, i: self._associate(pose, state, obs, i)  # noqa: E731
            pose, P_cov, log_w = propose_3d.refine(
                self.model, self.retract, pose, P_cov, state.log_w, *frame,
                self._r_matrix(True, state.pose), assoc, **kw)

        # Sample pose ~ N(mean, P) in tangent coordinates; a failed or
        # non-finite factor samples at the refined mean.
        chol, info = torch.linalg.cholesky_ex(P_cov + _JITTER * eye_t)
        chol = torch.where((info == 0)[:, None, None] & torch.isfinite(chol), chol,
                           torch.zeros_like(chol))
        pose = self.retract(pose, (chol @ noise[..., None])[..., 0])
        return state.replace(pose=pose, log_w=log_w), scores

    # -- full step ------------------------------------------------------------

    def step(self, state: ParticleState, u, obs: Observation, noise, u0):
        """One FastSLAM 2.0 frame: proposal-refined pose sampling with
        `noise` [P, dt], the map pass (weights already applied), resample
        with comb offset u0."""
        log_w0 = state.log_w.clone() if self.cfg.likelihood_temper != 1.0 else None
        state, scores = self._propose(state, u, obs, noise)
        state, mean_match = self.measurement_core(state, obs, weight_matched=False,
                                                  scores=scores)
        state = self._temper(state, log_w0)
        return self._resample_and_metrics(state, obs, mean_match, u0)


def make_filter(cfg, fe_cfg=None) -> FastSLAM:
    """Algorithm-selecting factory: cfg.algorithm in {fastslam1, fastslam2}."""
    algo = getattr(cfg, "algorithm", "fastslam1")
    if algo == "fastslam2":
        return FastSLAM2(cfg, fe_cfg)
    if algo == "fastslam1":
        return FastSLAM(cfg, fe_cfg)
    raise ValueError(f"unknown algorithm {algo!r}")
