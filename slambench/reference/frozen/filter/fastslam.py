"""Dense-batched FastSLAM 1.0 engine (port of
`parakeet_slam_tpu.filter.fastslam`).

Sampled motion update, per-particle maximum-likelihood data association,
per-landmark EKF updates, importance weighting, adaptive systematic
resampling and counter-based map management, each one batched tensor
program over dense [P, L] arrays with validity masks.

The frame's measurement update goes through a fused kernel wrapper where
one covers the model and the options: `kernels.ekf_update.measurement_update_2d`
on `range_bearing_2d` with no external scores, anchor freeze, weight shaping
or descriptors, and `kernels.ekf_update_3d.measurement_update_3d` (with
`score_3d` where the weights are shaped) on the vision models without a float
signature. Everything else takes the reference's model-agnostic path
(`_measurement_generic`: `_score_frame`, `_associate_frame`,
`_apply_observation` once per observation in order, the cull), built from
each model's h / jac / residual / init / in_fov in plain torch. The
resampling gather goes through `kernels.resample_cuda.gather_state`. The
state's device picks kernel or twin inside each wrapper: the hand-written
CUDA kernels on CUDA tensors, their plain twins on CPU tensors. The config
key `use_pallas` is ignored: where the reference's `use_pallas=True` sends
2-D shaping or descriptor configs to its fused kernel, which drops those
options, the port honours them on the generic path, as the reference's
`use_pallas=False` route does.

The step reads nothing on the host and copies no host data to the device
once its constants exist (after one warm-up step): the resample decision
stays on the device, as the reference's `lax.cond`, so that
`filter/captured.py` can capture the step into one CUDA graph.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from slambench.reference.frozen.core import linalg
from slambench.reference.frozen.core.config import FilterConfig, FrontendConfig
from slambench.reference.frozen.core.geometry import wrap_angle
from slambench.reference.frozen.core.state import Observation, ParticleState, make_particle_state
from slambench.reference.frozen.filter import models as model_zoo
from slambench.reference.frozen.kernels import ekf_update, ekf_update_3d
from slambench.reference.frozen.kernels import match as match_kernel
from slambench.reference.frozen.kernels import resample as resample_kernel

_NEG_INF = -1e30


def _f32(x: float) -> float:
    """x rounded to float32, as the reference's float32 graph holds it."""
    return float(torch.tensor(x, dtype=torch.float32))


@dataclass
class StepMetrics:
    """Per-frame observability metrics (0-dim tensors; `resampled` bool)."""

    ess: torch.Tensor
    num_landmarks: torch.Tensor
    match_frac: torch.Tensor
    resampled: torch.Tensor


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
        # which fused kernel, if any, covers this model and these options
        self.kernel_3d = self.vision and cfg.sig_dim == 0
        self.kernel_2d = (
            self.model.name == "range_bearing_2d" and cfg.freeze_min_count == 0
            and not self._weight_shaping and cfg.desc_words == 0
        )
        # Measurement variances of the 2-D kernel, held as float32 values so
        # that the kernel (float parameters) and the twin agree.
        self.r_var = tuple(_f32(float(x) ** 2) for x in cfg.meas_noise[:2])
        self.sig_var = _f32(float(cfg.sig_noise) ** 2)
        self._R = {}  # diag(R) of the generic path, per (assoc, device, dtype)

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
        vision models without a float signature, the 2-D kernel's plain
        scoring on `range_bearing_2d` without descriptors or a gate, the
        generic scoring otherwise."""
        c = self.cfg
        if self.kernel_3d:
            ll, ix = ekf_update_3d.score_3d(
                state.pose, state.lm_mean, state.lm_cov, state.lm_desc, state.lm_valid,
                obs.z, obs.desc, model=self.model.name, desc_words=c.desc_words,
                par=self._vision_kernel_params(), r_var=self._meas_var(assoc=True),
                desc_weight=float(c.desc_weight),
            )
            return ix, ll
        if self.model.name == "range_bearing_2d" and c.desc_words == 0 and c.assoc_gate_px == 0:
            return ekf_update._score_frame(
                state.pose, state.lm_mean, state.lm_cov, state.lm_sig, state.lm_valid,
                obs.z, obs.sig, c.sig_dim, self.r_var, self.sig_var,
            )
        return self._score_frame(state, obs)

    # -- the generic path ---------------------------------------------------

    def _per_pair_stats(self, pose, lm_mean, lm_cov, assoc: bool = False):
        """The geometry of each (pose, landmark) pair, shared by every
        observation: (zhat [..., Dz], H [..., Dz, Dl], Q^-1, log det Q), with
        Q = H S H^T + R and the reference's clamps."""
        zhat = self.model.h(pose, lm_mean)
        H = self.model.jac(pose, lm_mean)
        Q = H @ lm_cov @ H.transpose(-1, -2) + self._r_matrix(assoc, lm_mean)
        inv, det = linalg.inv_psd(Q)
        return zhat, H, inv, torch.log(torch.clamp(det, min=1e-12))

    def _r_matrix(self, assoc: bool, like: torch.Tensor) -> torch.Tensor:
        """diag(R) (`_meas_var(assoc)`) on `like`'s device and dtype: one
        host-to-device copy per device, at its first use."""
        key = (assoc, like.device, like.dtype)
        if key not in self._R:
            self._R[key] = torch.diag(torch.tensor(self._meas_var(assoc), dtype=like.dtype,
                                                   device=like.device))
        return self._R[key]

    def _loglik(self, z, zhat, inv, logdet):
        """log N(z - zhat; 0, Q) from Q's inverse and log-determinant; the
        Mahalanobis term clamped at 0, as `linalg.gaussian_loglik`."""
        nu = self.model.residual(z, zhat)
        maha = torch.clamp(torch.einsum("...i,...ij,...j->...", nu, inv, nu), min=0.0)
        D = nu.shape[-1]
        return -0.5 * (maha + logdet + D * math.log(2.0 * math.pi))

    def _appearance_loglik(self, obs_sig, obs_desc, lm_sig, lm_desc):
        """Signature (float) and descriptor (Hamming) terms [P, L]."""
        c = self.cfg
        ll = torch.zeros(lm_sig.shape[:2], dtype=lm_sig.dtype, device=lm_sig.device)
        if c.sig_dim > 0:
            d2 = torch.sum((lm_sig - obs_sig[None, None, :]) ** 2, dim=-1)
            ll = ll - 0.5 * d2 / self.sig_var
        if c.desc_words > 0:
            x = torch.bitwise_xor(lm_desc, obs_desc[None, None, :])
            ham = match_kernel.popcount32(x).sum(dim=-1, dtype=torch.int32).to(ll.dtype)
            ll = ll - c.desc_weight * ham
        return ll

    def _score_frame(self, state: ParticleState, obs: Observation):
        """Every observation scored against every (particle, landmark) pair
        of the pre-frame map: (best lane [P, Z], best ll [P, Z]). Invalid
        lanes and non-finite scores count -1e30; the best lane is the first
        among equal maxima."""
        zhat, _, inv, logdet = self._per_pair_stats(state.pose[:, None, :], state.lm_mean,
                                                    state.lm_cov, assoc=True)
        best, best_ll = [], []
        for i in range(obs.capacity):
            ll = self._loglik(obs.z[i], zhat, inv, logdet)
            ll = ll + self._appearance_loglik(obs.sig[i], obs.desc[i], state.lm_sig,
                                              state.lm_desc)
            ll = torch.where(state.lm_valid & torch.isfinite(ll), ll, _NEG_INF)
            b = torch.argmax(ll, dim=1)
            best.append(b)
            best_ll.append(torch.gather(ll, 1, b[:, None])[:, 0])
        return torch.stack(best, 1), torch.stack(best_ll, 1)

    def _associate_frame(self, state: ParticleState, obs: Observation, scores=None):
        """Pre-frame association of the whole frame: (target [P, Z] lane or
        -1, is_new, do_upd, do_alloc, best_ll). New landmarks take the free
        lanes in ascending order, at most min(Z, 64) a frame."""
        best, best_ll = self._score_frame(state, obs) if scores is None else scores
        target, is_new, do_upd, do_alloc = ekf_update._associate(
            state.lm_valid, best.long(), best_ll, obs.valid, self._log_p0_assoc())
        return target, is_new, do_upd, do_alloc, best_ll

    def _apply_observation(self, state: ParticleState, matched, obs: Observation, i,
                           target, is_new):
        """Observation i applied at its pre-assigned lane target [P] of every
        particle, IN PLACE on the state's landmark tensors and `matched`: the
        EKF update (symmetrised covariance; mean and covariance left alone on
        a frozen anchor, whose count and appearance still move) where it
        matched, the model's landmark init where it is new and has a slot.
        Each particle writes one lane, so the writes are plain indexed
        stores, no accumulation."""
        c = self.cfg
        rows = torch.arange(state.num_particles, device=state.pose.device)
        act = target >= 0
        upd = act & ~is_new
        alloc = act & is_new
        tgt = torch.clamp(target, min=0)
        z = obs.z[i]
        mean_b, cov_b = state.lm_mean[rows, tgt], state.lm_cov[rows, tgt]
        cnt_b = state.lm_count[rows, tgt]
        frozen = (cnt_b >= c.freeze_min_count) if c.freeze_min_count > 0 else torch.zeros_like(upd)

        zhat, H, Qinv, _ = self._per_pair_stats(state.pose, mean_b, cov_b)
        nu = self.model.residual(z, zhat)
        K = cov_b @ H.transpose(-1, -2) @ Qinv
        mean_u = mean_b + (K @ nu[..., None])[..., 0]
        eye = torch.eye(c.lm_dim, dtype=cov_b.dtype, device=cov_b.device)
        cov_u = (eye - K @ H) @ cov_b
        cov_u = 0.5 * (cov_u + cov_u.transpose(-1, -2))
        mean0, cov0 = self.model.init(state.pose, z)

        move = upd & ~frozen
        m1 = lambda a: a[:, None]  # noqa: E731
        state.lm_mean[rows, tgt] = torch.where(m1(move), mean_u,
                                               torch.where(m1(alloc), mean0, mean_b))
        state.lm_cov[rows, tgt] = torch.where(m1(m1(move)), cov_u,
                                              torch.where(m1(m1(alloc)), cov0, cov_b))
        cnt_u = cnt_b + 2
        state.lm_count[rows, tgt] = torch.where(upd, cnt_u,
                                                torch.where(alloc, torch.ones_like(cnt_b), cnt_b))
        state.lm_valid[rows, tgt] = state.lm_valid[rows, tgt] | alloc
        if c.sig_dim > 0:
            # running-average appearance
            sig = obs.sig[i]
            sig_b = state.lm_sig[rows, tgt]
            cnt = torch.clamp(cnt_u.to(sig_b.dtype), min=1.0)
            sig_u = sig_b + (sig[None, :] - sig_b) / cnt[:, None]
            state.lm_sig[rows, tgt] = torch.where(
                m1(upd), sig_u, torch.where(m1(alloc), sig.expand_as(sig_b), sig_b))
        if c.desc_words > 0:
            # latest-wins descriptors
            desc_b = state.lm_desc[rows, tgt]
            state.lm_desc[rows, tgt] = torch.where(m1(act), obs.desc[i].expand_as(desc_b), desc_b)
        matched[rows, tgt] = matched[rows, tgt] | act

    def _cull(self, state: ParticleState, matched) -> ParticleState:
        """Unmatched lanes age (in the field of view, or everywhere with
        cull_unseen); a count below 0 frees the lane."""
        c = self.cfg
        if not c.cull_enabled:
            return state
        if c.cull_unseen:
            dec = state.lm_valid & ~matched
        else:
            in_fov = self.model.in_fov(state.pose[:, None, :], state.lm_mean)
            dec = state.lm_valid & in_fov & ~matched
        count = state.lm_count - dec.to(torch.int32)
        return state.replace(lm_count=count, lm_valid=state.lm_valid & (count >= 0))

    def _measurement_generic(self, state, obs, weight_matched, scores=None):
        """The reference's model-agnostic measurement update: pre-frame
        association, the shaped weight increment, the observations applied in
        order, the cull. Returns (state, mean associated-observation count)."""
        pre = state
        target, is_new, do_upd, do_alloc, best_ll = self._associate_frame(state, obs, scores)
        if weight_matched:
            # the lane is read only where the observation is not new
            best = torch.where(is_new, torch.zeros_like(target), torch.clamp(target, min=0))
            state = state.replace(log_w=state.log_w + self._weight_delta(pre, obs, (best, best_ll)))
        # the observations write into copies: the caller's state stays as it was
        state = state.replace(**{f: getattr(state, f).clone() for f in (
            "lm_mean", "lm_cov", "lm_count", "lm_valid", "lm_sig", "lm_desc")})
        matched = torch.zeros_like(state.lm_valid)
        for i in range(obs.capacity):
            self._apply_observation(state, matched, obs, i, target[:, i], is_new[:, i])
        n_match = (do_upd | do_alloc).to(torch.float32).sum(dim=1)
        return self._cull(state, matched), n_match.mean()

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
        if self.kernel_2d and scores is None:
            return self._measurement_update_2d(state, obs, weight_matched)
        if not self.kernel_3d:
            return self._measurement_generic(state, obs, weight_matched, scores)
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
        # which the routing (kernel_2d) ensures.
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
        """Adaptive systematic resampling + per-frame metrics, decided on the
        device (the reference's `lax.cond`): the gather runs every frame, at
        the identity indices where the ESS asks for no resample, and log_w
        is reset only where it does. A frame without a resample so leaves
        the state bit for bit as the cond's untouched branch does, at the
        cost of one copy of the state."""
        c = self.cfg
        P = state.num_particles
        ess = state.effective_sample_size()
        need = ess < c.resample_frac * P
        keep = torch.arange(P, device=state.log_w.device)
        idx = torch.where(need, resample_kernel.systematic_resample_indices(state.log_w, u0), keep)
        log_w = state.log_w
        state = resample_kernel.gather_particles(state, idx)
        state = state.replace(log_w=torch.where(need, state.log_w, log_w))
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
        best = torch.argmax(state.log_w).reshape(1)
        t = torch.sum(w[:, None] * state.pose[:, :3], dim=0)
        q = state.pose[:, 3:]
        # index_select: indexing with a 0-dim tensor reads it on the host
        sign = torch.where(torch.sum(q * q.index_select(0, best), dim=1) < 0, -1.0, 1.0)
        qm = torch.sum((w * sign)[:, None] * q, dim=0)
        qm = qm / torch.clamp(torch.linalg.vector_norm(qm), min=1e-9)
        return torch.cat([t, qm])

    def best_particle_map(self, state: ParticleState):
        """(means [L, Dl], valid [L]) of the highest-weight particle."""
        best = torch.argmax(state.log_w).reshape(1)
        return state.lm_mean.index_select(0, best)[0], state.lm_valid.index_select(0, best)[0]
