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
(one `score_3d` sweep, reused by the map pass); "sequential" re-associates
each observation at the progressively refined pose. "auto" is hoisted on
the vision models and sequential on the 2-D corridor. The refinement is
sequential over the observations either way: a Python loop of small [P, 6]
tensor programs.
"""

from __future__ import annotations

import torch

from parakeet_slam_tpu_torch.core import linalg
from parakeet_slam_tpu_torch.core.state import Observation, ParticleState
from parakeet_slam_tpu_torch.filter import models as model_zoo
from parakeet_slam_tpu_torch.filter.fastslam import FastSLAM

_JITTER = 1e-9


class FastSLAM2(FastSLAM):
    """FastSLAM with the optimal (measurement-informed) proposal."""

    def __init__(self, cfg, fe_cfg=None):
        super().__init__(cfg, fe_cfg)
        self.motion_mean_cov, self.retract, self.tangent_dim = (
            model_zoo.get_motion_mean_cov(cfg.motion_model)
        )
        self.noise_dim = self.tangent_dim  # the proposal's draw replaces the motion draw
        if not self.vision and self._hoist_association():
            raise NotImplementedError(
                "hoisted association on the 2-D model takes the reference's XLA map "
                "pass, which is not ported (ROADMAP Queue 1)"
            )

    # -- proposal stage -----------------------------------------------------

    def _pose_jacobian(self, pose, lm):
        """Hx = d h(pose (+) delta, lm) / d delta at delta = 0, [P, Dz, dt]:
        the model's closed form of the reference's jacfwd."""
        return self.model.pose_jac(pose, lm)

    def _hoist_association(self) -> bool:
        mode = getattr(self.cfg, "fs2_association", "auto")
        if mode == "auto":
            return self.vision
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
        P, dt = state.num_particles, self.tangent_dim
        dev, dtype = state.pose.device, state.pose.dtype
        rows = torch.arange(P, device=dev)
        R = torch.diag(torch.tensor(self._meas_var(assoc=True), dtype=dtype, device=dev))
        eye_t = torch.eye(dt, dtype=dtype, device=dev)
        log_p0 = self._log_p0_assoc()
        unmatched_w = 0.0 if c.weight_only_matched else c.new_landmark_loglik

        pose, P_cov = self.motion_mean_cov(state.pose, u, c.motion_noise)
        hoist = self._hoist_association()
        scores = self._frame_scores(state.replace(pose=pose), obs) if hoist else None
        any_valid = state.lm_valid.any(dim=-1)
        log_w = state.log_w
        for i in range(obs.capacity):
            if hoist:
                best, best_ll = scores[0][:, i].long(), scores[1][:, i]
            else:
                best, best_ll = self._associate(pose, state, obs, i)
            valid = obs.valid[i]
            matched = valid & any_valid & (best_ll >= log_p0)
            mu, cv = state.lm_mean[rows, best], state.lm_cov[rows, best]
            if c.weight_min_count > 0:
                matched = matched & (state.lm_count[rows, best] >= c.weight_min_count)

            zhat = self.model.h(pose, mu)
            Hm = self.model.jac(pose, mu)
            Hx = self._pose_jacobian(pose, mu)
            nu = self.model.residual(obs.z[i], zhat)
            Q = Hm @ cv @ Hm.transpose(-1, -2) + R
            S = Hx @ P_cov @ Hx.transpose(-1, -2) + Q
            Sinv, _ = linalg.inv_psd(S)
            K = P_cov @ Hx.transpose(-1, -2) @ Sinv
            delta = (K @ nu[..., None])[..., 0]
            # Joseph form: PSD by construction, where (I - KH) P can go
            # indefinite in float32 and NaN the sampling Cholesky.
            IKH = eye_t - K @ Hx
            P_new = IKH @ P_cov @ IKH.transpose(-1, -2) + K @ Q @ K.transpose(-1, -2)
            P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
            # One degenerate landmark must not poison the particle: skip the
            # observation when the step or the likelihood is not finite.
            ll_s = linalg.gaussian_loglik(S, nu)
            ok = (
                torch.isfinite(delta).all(dim=-1)
                & torch.isfinite(P_new).all(dim=-1).all(dim=-1)
                & torch.isfinite(ll_s)
                & (torch.linalg.vector_norm(delta, dim=-1) < 1.0)
            )
            matched = matched & ok
            pose = torch.where(matched[:, None], self.retract(pose, delta), pose)
            P_cov = torch.where(matched[:, None, None], P_new, P_cov)
            log_w = log_w + torch.where(
                matched, ll_s,
                torch.where(valid, torch.full_like(ll_s, unmatched_w), torch.zeros_like(ll_s)),
            )

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
