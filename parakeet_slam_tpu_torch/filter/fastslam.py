"""Dense-batched FastSLAM 1.0 engine (port of
`parakeet_slam_tpu.filter.fastslam`).

Sampled motion update, per-particle maximum-likelihood data association,
per-landmark EKF updates, importance weighting, adaptive systematic
resampling and counter-based map management, each one batched tensor
program over dense [P, L] arrays with validity masks.

The frame's measurement update goes through a fused kernel wrapper:
`kernels.ekf_update.measurement_update_2d` on the 2-D corridor model, and
`kernels.ekf_update_3d.measurement_update_3d` (with `score_3d` where the
weights are shaped) on the vision models. The resampling gather goes through
`kernels.resample_cuda.gather_state`. The state's device picks the route:
the hand-written CUDA kernels on CUDA tensors, their plain twins on CPU
tensors. The port always follows the reference's `use_pallas=True` routing;
the config key itself is ignored.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from parakeet_slam_tpu_torch.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu_torch.core.geometry import wrap_angle
from parakeet_slam_tpu_torch.core.state import Observation, ParticleState, make_particle_state
from parakeet_slam_tpu_torch.filter import models as model_zoo
from parakeet_slam_tpu_torch.kernels import ekf_update, ekf_update_3d
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
    """Config-specialized FastSLAM 1.0 filter."""

    def __init__(self, cfg: FilterConfig, fe_cfg: FrontendConfig | None = None):
        self.cfg = cfg
        self.fe_cfg = fe_cfg
        self.model = model_zoo.get_measurement_model(cfg, fe_cfg)
        self.motion = model_zoo.get_motion_model(cfg.motion_model)
        self.noise_dim = model_zoo.motion_noise_dim(cfg.motion_model)
        if cfg.obs_dim != self.model.obs_dim or cfg.lm_dim != self.model.lm_dim:
            raise ValueError(
                f"config dims ({cfg.obs_dim},{cfg.lm_dim}) do not match model "
                f"{self.model.name} ({self.model.obs_dim},{self.model.lm_dim})"
            )
        self.vision = self.model.name in model_zoo.VISION_MODELS
        if self.vision and cfg.sig_dim != 0:
            raise NotImplementedError(
                "3-D models with a float signature (sig_dim > 0) take the reference's "
                "XLA path, which is not ported (ROADMAP Queue 1)"
            )
        if not self.vision:
            # The fused 2-D kernel has none of these; the reference runs them
            # on its XLA path, which the port does not have.
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
                    f"FilterConfig {bad} on {self.model.name}: the 2-D path has no weight "
                    "shaping, anchor freeze or descriptors (ROADMAP Queue 1)"
                )
        # Measurement variances of the 2-D kernel, held as float32 values so
        # that the kernel (float parameters) and the twin agree.
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
        """noise [P, noise_dim]: standard normal draws for the motion model."""
        pose = self.motion(state.pose, u, self.cfg.motion_noise, noise)
        return state.replace(pose=pose)

    # -- scoring ------------------------------------------------------------

    def _meas_var(self, assoc: bool = False):
        """Measurement noise variances (diagonal of R); `assoc=True` adds
        config.assoc_gate_px in quadrature (the association/weight gates)."""
        c = self.cfg
        v = tuple(float(x) ** 2 for x in c.meas_noise[: c.obs_dim])
        if assoc and c.assoc_gate_px > 0.0:
            v = tuple(x + float(c.assoc_gate_px) ** 2 for x in v)
        return v

    def _log_p0_assoc(self) -> float:
        """New-landmark threshold in the association scoring's units: shifted
        by the normalisation change that the inflated R brings, so that the
        chi^2 margin it encodes does not depend on the gate."""
        c = self.cfg
        p0 = float(c.new_landmark_loglik)
        if c.assoc_gate_px <= 0.0:
            return p0
        vt, va = self._meas_var(False), self._meas_var(True)
        return p0 - 0.5 * sum(math.log(a / t) for a, t in zip(va, vt))

    def _vision_kernel_params(self):
        """Camera parameters of the 3-D kernels, as (name, value) pairs."""
        fe = self.fe_cfg
        fx, fy, cx, cy = fe.intrinsics[:4] if fe else (500.0, 500.0, 320.0, 240.0)
        H_img, W_img = fe.image_size if fe else (480, 640)
        return (
            ("fx", float(fx)), ("fy", float(fy)), ("cx", float(cx)), ("cy", float(cy)),
            ("baseline", float(fe.baseline if fe else 0.1)),
            ("img_w", float(W_img)), ("img_h", float(H_img)),
        )

    def _frame_scores(self, state: ParticleState, obs: Observation):
        """Association of the whole frame against the pre-frame map at the
        state's poses: (best lane [P, Z], best ll [P, Z]). `score_3d` on the
        vision models, the plain 2-D scoring otherwise."""
        c = self.cfg
        if self.vision:
            ll, ix = ekf_update_3d.score_3d(
                state.pose, state.lm_mean, state.lm_cov, state.lm_desc, state.lm_valid,
                obs.z, obs.desc, model=self.model.name, desc_words=c.desc_words,
                par=self._vision_kernel_params(), r_var=self._meas_var(assoc=True),
                desc_weight=float(c.desc_weight),
            )
            return ix, ll
        return ekf_update._score_frame(
            state.pose, state.lm_mean, state.lm_cov, state.lm_sig, state.lm_valid,
            obs.z, obs.sig, c.sig_dim, self.r_var, self.sig_var,
        )

    @property
    def _weight_shaping(self) -> bool:
        """True when the weights need the score_3d + apply split."""
        c = self.cfg
        return c.weight_min_count > 0 or c.weight_only_matched or c.assoc_gate_px > 0.0

    def _weight_delta(self, state: ParticleState, obs: Observation, scores):
        """Per-particle frame log-weight increment [P] from association scores
        (best lane [P, Z], best ll [P, Z]) with the weight-shaping config."""
        c = self.cfg
        best, best_ll = scores
        L = state.lm_valid.shape[1]
        is_new = best_ll < self._log_p0_assoc()
        new_w = 0.0 if c.weight_only_matched else c.new_landmark_loglik
        dw = torch.where(is_new, torch.full_like(best_ll, new_w), best_ll)
        if c.weight_min_count > 0:
            cnt = torch.gather(state.lm_count, 1, torch.clamp(best.long(), 0, L - 1))
            dw = torch.where(is_new | (cnt >= c.weight_min_count), dw, torch.zeros_like(dw))
        return torch.sum(torch.where(obs.valid[None, :], dw, torch.zeros_like(dw)), dim=1)

    # -- measurement update -------------------------------------------------

    def measurement_core(
        self, state: ParticleState, obs: Observation, weight_matched: bool = True,
        scores=None,
    ) -> tuple[ParticleState, torch.Tensor]:
        """Association + EKF updates + map management WITHOUT resampling.
        Returns (state, mean associated-observation count). `scores` (best,
        best_ll), when given, replaces the association sweep (FastSLAM 2.0's
        proposal already scored the frame)."""
        if not self.vision:
            if scores is not None:
                raise NotImplementedError(
                    "external scores on the 2-D model take the reference's XLA path, "
                    "which is not ported (ROADMAP Queue 1)"
                )
            return self._measurement_update_2d(state, obs, weight_matched)
        if weight_matched and self._weight_shaping:
            # Shaped weights are computed here from a score_3d sweep; the
            # update kernel then applies those scores with its own weight
            # update off.
            if scores is None:
                scores = self._frame_scores(state, obs)
            state = state.replace(log_w=state.log_w + self._weight_delta(state, obs, scores))
            return self._measurement_update_3d(state, obs, False, scores)
        return self._measurement_update_3d(state, obs, weight_matched, scores)

    def _measurement_update_2d(self, state, obs, weight_matched):
        c = self.cfg
        # The fused update weights a new observation with new_landmark_loglik
        # and also uses it as the association threshold; the reference's
        # threshold (_log_p0_assoc) equals it only while assoc_gate_px == 0,
        # which __init__ enforces on this model.
        out = ekf_update.measurement_update_2d(
            state.pose, state.log_w, state.lm_mean, state.lm_cov, state.lm_sig,
            state.lm_valid, state.lm_count, obs.z, obs.sig, obs.valid,
            sig_dim=c.sig_dim, r_var=self.r_var, sig_var=self.sig_var,
            log_p0=float(c.new_landmark_loglik), init_infl=float(c.init_cov_inflation),
            max_range=float(c.max_range), fov_half=float(c.fov_half_angle),
            cull=c.cull_enabled, cull_unseen=c.cull_unseen, update_weights=weight_matched,
        )
        log_w, lm_mean, lm_cov, lm_sig, lm_valid, lm_count, n_match, _ = out
        state = state.replace(
            log_w=log_w, lm_mean=lm_mean, lm_cov=lm_cov, lm_sig=lm_sig,
            lm_valid=lm_valid, lm_count=lm_count,
        )
        return state, n_match.mean()

    def _measurement_update_3d(self, state, obs, weight_matched, scores=None):
        """One frame through `measurement_update_3d`. Without `scores` the
        kernel scores the frame itself and weights it with log_p0 for a new
        observation; that equals the reference's weight only while
        assoc_gate_px == 0, and a gate > 0 always takes the shaped split."""
        c = self.cfg
        ext_ll = ext_ix = None
        if scores is not None:
            ext_ix, ext_ll = scores
        out = ekf_update_3d.measurement_update_3d(
            state.pose, state.log_w, state.lm_mean, state.lm_cov, state.lm_desc,
            state.lm_valid, state.lm_count, obs.z, obs.desc, obs.valid, ext_ll, ext_ix,
            model=self.model.name, desc_words=c.desc_words,
            par=self._vision_kernel_params(), r_var=self._meas_var(False),
            desc_weight=float(c.desc_weight), log_p0=self._log_p0_assoc(),
            init_infl=float(c.init_cov_inflation),
            init_range_prior=float(c.init_range_prior),
            init_range_sigma=float(c.init_range_sigma), max_range=float(c.max_range),
            cull=c.cull_enabled, cull_unseen=c.cull_unseen,
            update_weights=weight_matched, freeze=c.freeze_min_count,
        )
        log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count, n_match, _ = out
        state = state.replace(
            log_w=log_w, lm_mean=lm_mean, lm_cov=lm_cov, lm_desc=lm_desc,
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
        # the kernels update log_w in place; only tempering needs the old one
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
        [P, noise_dim] standard normals and `u0` in [0, 1/P) are this
        frame's draws."""
        state = self.motion_update(state, u, noise)
        return self.measurement_update(state, obs, u0)

    # -- estimates ------------------------------------------------------------

    def estimate_pose(self, state: ParticleState) -> torch.Tensor:
        """Weighted-mean pose: angle-aware for SE(2); for SE(3) the weighted
        translation and the weighted quaternion mean, sign-aligned to the best
        particle and renormalised (the first-order chordal mean)."""
        w = state.normalized_weights()
        if self.cfg.pose_dim == 3:
            xy = torch.sum(w[:, None] * state.pose[:, :2], dim=0)
            s = torch.sum(w * torch.sin(state.pose[:, 2]))
            cth = torch.sum(w * torch.cos(state.pose[:, 2]))
            return torch.cat([xy, wrap_angle(torch.atan2(s, cth))[None]])
        best = torch.argmax(state.log_w)
        t = torch.sum(w[:, None] * state.pose[:, :3], dim=0)
        q = state.pose[:, 3:]
        sign = torch.where(torch.sum(q * q[best][None, :], dim=1) < 0, -1.0, 1.0)
        qm = torch.sum((w * sign)[:, None] * q, dim=0)
        qm = qm / torch.clamp(torch.linalg.vector_norm(qm), min=1e-9)
        return torch.cat([t, qm])
