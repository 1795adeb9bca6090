"""Dense-batched FastSLAM 1.0 engine on the 2-D models (port of
`parakeet_slam_tpu.filter.fastslam`).

Sampled motion update, per-particle maximum-likelihood data association,
per-landmark EKF updates, importance weighting, adaptive systematic
resampling and counter-based map management, each one batched tensor
program over dense [P, L] arrays with validity masks.

The frame's measurement update goes through
`kernels.ekf_update.measurement_update_2d` and the resampling gather through
`kernels.resample_cuda.gather_state`. The state's device picks the route:
the hand-written CUDA kernels on CUDA tensors, their plain twins on CPU
tensors. The config key `use_pallas` is ignored.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from parakeet_slam_tpu_torch.core.config import FilterConfig
from parakeet_slam_tpu_torch.core.geometry import wrap_angle
from parakeet_slam_tpu_torch.core.state import Observation, ParticleState, make_particle_state
from parakeet_slam_tpu_torch.filter import models as model_zoo
from parakeet_slam_tpu_torch.kernels import ekf_update
from parakeet_slam_tpu_torch.kernels import resample as resample_kernel


def _f32(x: float) -> float:
    """x rounded to float32, as the reference's float32 graph holds it."""
    return float(torch.tensor(x, dtype=torch.float32))


@dataclass
class StepMetrics:
    """Per-frame observability metrics (0-dim tensors)."""

    ess: torch.Tensor
    num_landmarks: torch.Tensor
    match_frac: torch.Tensor
    resampled: bool


class FastSLAM:
    """Config-specialized FastSLAM 1.0 filter on the 2-D models."""

    def __init__(self, cfg: FilterConfig):
        unported = {
            "weight_min_count": cfg.weight_min_count != 0,
            "weight_only_matched": cfg.weight_only_matched,
            "assoc_gate_px": cfg.assoc_gate_px != 0.0,
            "freeze_min_count": cfg.freeze_min_count != 0,
            "desc_words": cfg.desc_words != 0,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"FilterConfig {bad}: weight shaping, anchor freeze and descriptors "
                "belong to slice 2 of the port (ROADMAP Queue 1)"
            )
        self.cfg = cfg
        self.model = model_zoo.get_measurement_model(cfg)
        self.motion = model_zoo.get_motion_model(cfg.motion_model)
        if cfg.obs_dim != self.model.obs_dim or cfg.lm_dim != self.model.lm_dim:
            raise ValueError(
                f"config dims ({cfg.obs_dim},{cfg.lm_dim}) do not match model "
                f"{self.model.name} ({self.model.obs_dim},{self.model.lm_dim})"
            )
        # Measurement variances, held as float32 values so that the kernel
        # (float parameters) and the twin (scalars cast to float32) agree.
        self.r_var = tuple(_f32(float(x) ** 2) for x in cfg.meas_noise[:2])
        self.sig_var = _f32(float(cfg.sig_noise) ** 2)

    # -- state ------------------------------------------------------------

    def init_state(self, init_pose=None, *, device) -> ParticleState:
        c = self.cfg
        return make_particle_state(
            c.num_particles, c.max_landmarks, c.lm_dim, c.sig_dim,
            c.desc_words, c.pose_dim, init_pose, device=device,
        )

    # -- motion update ------------------------------------------------------

    def motion_update(self, state: ParticleState, u, noise) -> ParticleState:
        """noise [P, 3]: standard normal draws for the odometry model."""
        pose = self.motion(state.pose, u, self.cfg.motion_noise, noise)
        return state.replace(pose=pose)

    # -- measurement update -------------------------------------------------

    def measurement_core(
        self, state: ParticleState, obs: Observation, weight_matched: bool = True
    ) -> tuple[ParticleState, torch.Tensor]:
        """Association + EKF updates + map management WITHOUT resampling.
        Returns (state, mean associated-observation count)."""
        c = self.cfg
        # The fused update weights a new observation with new_landmark_loglik
        # and also uses it as the association threshold; the reference's
        # threshold (_log_p0_assoc) equals it only while assoc_gate_px == 0,
        # which __init__ enforces.
        log_p0 = float(c.new_landmark_loglik)
        out = ekf_update.measurement_update_2d(
            state.pose, state.log_w, state.lm_mean, state.lm_cov, state.lm_sig,
            state.lm_valid, state.lm_count, obs.z, obs.sig, obs.valid,
            sig_dim=c.sig_dim,
            r_var=self.r_var,
            sig_var=self.sig_var,
            log_p0=log_p0,
            init_infl=float(c.init_cov_inflation),
            max_range=float(c.max_range),
            fov_half=float(c.fov_half_angle),
            cull=c.cull_enabled,
            cull_unseen=c.cull_unseen,
            update_weights=weight_matched,
        )
        log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, n_match, _ = out
        state = state.replace(
            log_w=log_w, lm_mean=lm_mean, lm_cov=lm_cov, lm_sig=lm_sig,
            lm_valid=lm_valid, lm_count=lm_count,
        )
        return state, n_match.mean()

    def _temper(self, state: ParticleState, log_w0) -> ParticleState:
        """Likelihood tempering: divide the frame's log-weight increment."""
        T = self.cfg.likelihood_temper
        if T == 1.0:
            return state
        return state.replace(log_w=log_w0 + (state.log_w - log_w0) / T)

    def measurement_update(self, state: ParticleState, obs: Observation, u0):
        """Process a frame's observations; cull; adaptively resample with
        comb offset u0 in [0, 1/P)."""
        # the kernel updates log_w in place; only tempering needs the old one
        log_w0 = state.log_w.clone() if self.cfg.likelihood_temper != 1.0 else None
        state, mean_match = self.measurement_core(state, obs)
        state = self._temper(state, log_w0)
        return self._resample_and_metrics(state, obs, mean_match, u0)

    def _resample_and_metrics(self, state, obs, mean_match, u0):
        """Adaptive systematic resampling + per-frame metrics. The resample
        decision is read on the host (one device-to-host sync per frame)."""
        c = self.cfg
        P = state.num_particles
        ess = state.effective_sample_size()
        need = bool(ess < c.resample_frac * P)
        if need:
            idx = resample_kernel.systematic_resample_indices(state.log_w, u0)
            state = resample_kernel.gather_particles(state, idx)
        n_obs = torch.clamp(obs.valid.to(torch.float32).sum(), min=1.0)
        metrics = StepMetrics(
            ess=ess,
            num_landmarks=state.num_landmarks().to(torch.float32).mean(),
            match_frac=mean_match / n_obs,
            resampled=need,
        )
        return state, metrics

    # -- full step ------------------------------------------------------------

    def step(self, state: ParticleState, u, obs: Observation, noise, u0):
        """One SLAM frame: motion propagate + measurement update. `noise`
        [P, 3] standard normals and `u0` in [0, 1/P) are this frame's draws."""
        state = self.motion_update(state, u, noise)
        return self.measurement_update(state, obs, u0)

    # -- estimates ------------------------------------------------------------

    def estimate_pose(self, state: ParticleState) -> torch.Tensor:
        """Weighted-mean SE(2) pose (angle-aware)."""
        w = state.normalized_weights()
        xy = torch.sum(w[:, None] * state.pose[:, :2], dim=0)
        s = torch.sum(w * torch.sin(state.pose[:, 2]))
        cth = torch.sum(w * torch.cos(state.pose[:, 2]))
        return torch.cat([xy, wrap_angle(torch.atan2(s, cth))[None]])
