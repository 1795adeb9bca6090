"""The filter reference: one frame of the online system worked out again by
the frozen copy's plain paths (the frontend's FAST, BRIEF and SAD
disparity, the FastSLAM step with the update's, the score's and the
gather's plain twins, the estimate, the keyframe test and the keyframe's
map snapshot), in float32 with TF32 off.

The control: TF32 leaves the filter's arithmetic as it is (its products
are small batched matrices that run on the CUDA cores whatever the TF32
setting; measured on the card, the TF32 reference equals the float32 one
bit for bit), so the filter's control is the next precision below that a
change could take: the reference with the particle state held in
bfloat16 (every float leaf rounded to bfloat16 where the step reads it
and where it writes it), the arithmetic in float32.

A frame of the filter is a stochastic step. The reference follows the
program's own state: it is given the state the program held before a
checked frame, that frame's images or observations, odometry and draws,
and compares what it computes with what the program held after it. The
start (the first frame, from the initial state) is checked from the
reference's own initial state."""

from __future__ import annotations

import dataclasses

import torch

from slambench.harness.spec import dotted
from slambench.reference.frozen.core import config as fconfig
from slambench.reference.frozen.core import geometry
from slambench.reference.frozen.core.state import Observation, ParticleState
from slambench.reference.frozen.filter import make_filter
from slambench.reference.frozen.frontend.describe import describe, make_pattern
from slambench.reference.frozen.frontend.detect import detect, top_k_stable
from slambench.reference.frozen.frontend.stereo import keypoint_disparity

STATE_FIELDS = [f.name for f in dataclasses.fields(ParticleState)]


def frozen_config(run_section: dict):
    return fconfig.apply_overrides(fconfig.SLAMConfig(), dotted(run_section))


def as_state(tree) -> ParticleState:
    """The frozen copy's ParticleState of any object with its fields."""
    return ParticleState(**{f: getattr(tree, f) for f in STATE_FIELDS})


class Frame:
    """The reference's frame of a configuration (`run` section)."""

    def __init__(self, run_section: dict, device):
        self.cfg = frozen_config(run_section)
        self.slam = make_filter(self.cfg.filter, self.cfg.frontend)
        self.device = device
        self.pattern = torch.as_tensor(make_pattern(), device=device)

    def init_state(self) -> ParticleState:
        return self.slam.init_state(device=self.device)

    def stereo_observation(self, left, right) -> Observation:
        """The system's `_stereo_observation`: detect and describe on the
        left image, the SAD disparity of the first Z keypoints."""
        fe = self.cfg.frontend
        xy, _, valid = detect(left, max_features=fe.max_features, detector=fe.detector,
                              threshold=fe.fast_threshold, nms_radius=fe.nms_radius,
                              wrap_x=False)
        desc = describe(left, xy, valid, pattern=self.pattern, wrap_x=False)
        Z = self.cfg.filter.max_observations
        xy, desc, valid = xy[:Z], desc[:Z], valid[:Z]
        disp, dvalid = keypoint_disparity(left, right, xy, valid)
        z = torch.cat([xy, disp[:, None]], dim=1)
        return self.observation(z, desc, valid & dvalid)

    def observation(self, z, desc, valid) -> Observation:
        Z = self.cfg.filter.max_observations
        z, desc, valid = z[:Z], desc[:Z], valid[:Z]
        pad = Z - z.shape[0]
        if pad > 0:
            z = torch.nn.functional.pad(z, (0, 0, 0, pad))
            desc = torch.nn.functional.pad(desc, (0, 0, 0, pad))
            valid = torch.nn.functional.pad(valid, (0, pad))
        return Observation(z=z, sig=torch.zeros(Z, 0, device=z.device), desc=desc, valid=valid)

    def kf_test(self, est, last_kf, has_kf):
        xi = geometry.se3_log(geometry.se3_between(last_kf, est))
        be = self.cfg.backend
        moved = ((torch.linalg.vector_norm(xi[:3]) > be.keyframe_translation)
                 | (torch.linalg.vector_norm(xi[3:]) > be.keyframe_rotation))
        return moved | ~has_kf

    def snapshot(self, state, est_pose):
        """The system's `_kf_snapshot_impl` on one device."""
        best = torch.argmax(state.log_w).reshape(1)
        means, valid, desc, count = (t.index_select(0, best)[0] for t in (
            state.lm_mean, state.lm_valid, state.lm_desc, state.lm_count))
        F = min(self.cfg.frontend.max_features, means.shape[0])
        in_fov = self.slam.model.in_fov(est_pose, means)
        dist = torch.linalg.vector_norm(means - est_pose[:3], dim=-1)
        sane = torch.isfinite(dist) & (dist < 8.0 * self.cfg.filter.max_range)
        score = torch.where(valid & sane, torch.where(in_fov, 1e6, 0.0) + count.to(torch.float32),
                            torch.full_like(dist, -1.0))
        _, sel = top_k_stable(score, F)
        pts_kf = geometry.se3_apply_inverse(est_pose, means[sel])
        return pts_kf, desc[sel], valid[sel] & sane[sel]

    def step(self, state, u, obs, noise, u0, last_kf, has_kf, bf16_state: bool = False):
        """(state, est, flag, snapshot) after one frame: the system's `_frame`;
        with `bf16_state`, the control."""
        st = as_state(state)
        if bf16_state:
            st = _rounded(st)
        st, _ = self.slam.step(st, u, obs, noise, u0)
        if bf16_state:
            st = _rounded(st)
        est = self.slam.estimate_pose(st)
        flag = self.kf_test(est, last_kf, has_kf)
        return st, est, flag, self.snapshot(st, est)


def _rounded(st: ParticleState) -> ParticleState:
    """The state with every float leaf rounded to bfloat16."""
    return ParticleState(**{f: (t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t)
                            for f, t in ((f, getattr(st, f)) for f in STATE_FIELDS)})


def _pose_gap(a, b):
    """Per row, the largest gap of a pose [.., 7]: translation and the
    sign-aligned quaternion."""
    sign = torch.where((a[..., 3:] * b[..., 3:]).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return torch.maximum((a[..., :3] - b[..., :3]).abs().amax(-1),
                         (a[..., 3:] * sign - b[..., 3:]).abs().amax(-1))


def _lane_mismatch(v_a, m_a, d_a, v_b, m_b, d_b, tol_m: float):
    """Per lane: validity differs, or both valid and their descriptors
    differ, one mean is finite and the other not, or both finite and apart
    by more than tol_m."""
    fa = torch.isfinite(m_a).all(-1)
    fb = torch.isfinite(m_b).all(-1)
    both = v_a & v_b
    far = (m_a - m_b).abs().amax(-1) > tol_m
    desc = (d_a != d_b).any(-1) if d_a.shape[-1] else torch.zeros_like(both)
    return (v_a != v_b) | (both & ((fa != fb) | (fa & fb & far) | desc))


def _rel_apart(a, b, tol_rel: float):
    """Per lane of [P, L, ...] leaves: one is finite and the other not, or
    both finite and their largest gap is more than tol_rel of the larger
    of 1e-6 and the reference's largest entry."""
    a, b = a.flatten(2), b.flatten(2)
    if a.shape[-1] == 0:
        return torch.zeros(a.shape[:2], dtype=torch.bool, device=a.device)
    fa = torch.isfinite(a).all(-1)
    fb = torch.isfinite(b).all(-1)
    scale = b.abs().amax(-1).clamp_min(1e-6)
    far = (a - b).abs().amax(-1) > tol_rel * scale
    return (fa != fb) | (fa & fb & far)


def _state_lane_mismatch(a, b, tol_m: float, tol_rel: float):
    """Per lane of two particle states: `_lane_mismatch`, or both valid and
    their observation counts differ, or their covariances or appearance
    signatures are apart (`_rel_apart`)."""
    base = _lane_mismatch(a.lm_valid, a.lm_mean, a.lm_desc, b.lm_valid, b.lm_mean, b.lm_desc,
                          tol_m)
    both = a.lm_valid & b.lm_valid
    extra = ((a.lm_count != b.lm_count) | _rel_apart(a.lm_cov, b.lm_cov, tol_rel)
             | _rel_apart(a.lm_sig, b.lm_sig, tol_rel))
    return base | (both & extra)


def compare(post, est, flag, snap, ref, tol_m: float = 1e-3, tol_rel: float = 1e-3) -> dict:
    """The numbers compared for one frame: the program's state after it
    (`post`, with the fields of ParticleState), its estimate, keyframe
    flag and snapshot against the reference's `ref` = step(...).

    `pose_gap_max` is the worst particle's pose gap, so a fault in a few
    particles (one rank's rows) shows. `logw_gap_max` is the worst
    particle's log-weight gap over the larger of 1 and the reference's
    magnitude: a frame without a resample keeps its weights, a frame with
    one resets both sides alike. A lane mismatches where its validity,
    mean, descriptor, observation count, covariance or signature differs
    (`_state_lane_mismatch`)."""
    st, r_est, r_flag, r_snap = ref
    pg = _pose_gap(post.pose, st.pose)
    pg = torch.where(torch.isfinite(pg), pg, torch.full_like(pg, float("inf")))
    lw_a, lw_b = post.log_w, st.log_w
    fin = torch.isfinite(lw_a) & torch.isfinite(lw_b)
    rel = (lw_a - lw_b).abs() / lw_b.abs().clamp_min(1.0)
    lw_gap = torch.where(fin, rel,
                         torch.where(torch.isfinite(lw_a) == torch.isfinite(lw_b),
                                     torch.zeros_like(lw_a), torch.full_like(lw_a, float("inf"))))
    lanes = _state_lane_mismatch(post, st, tol_m, tol_rel)
    pts, desc, valid = snap
    r_pts, r_desc, r_valid = r_snap
    snap_bad = _lane_mismatch(valid, pts, desc, r_valid, r_pts, r_desc, tol_m)
    return {
        "pose_gap_max": float(pg.max()),
        "logw_gap_max": float(lw_gap.max()),
        "lane_mismatch_share": float(lanes.float().mean()),
        "est_gap": float(_pose_gap(est, r_est)),
        "flag_differs": float(bool(flag) != bool(r_flag)),
        "snapshot_mismatch_share": float(snap_bad.float().mean()),
    }
