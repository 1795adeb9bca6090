"""The sweep orders of the redesigned update-path kernels, emulated in plain
torch/numpy on the twins' own per-pair scores, against the twins and the
JAX package.

- `ekf_update_2d` (csrc/ekf_update_2d.cu) lists each window of 512 lanes'
  valid lanes in ascending order; thread t owns observation t % Z in group
  t // Z of G = 256 // Z groups and sweeps every G-th listed lane, keeping
  the first maximum; the groups merge by the first-lane rule; the smallest
  free lane enters the merge at -1e30 (invalid lanes score -1e30 in the
  twin, so an invalid lane below every valid one wins when no valid lane
  scores above -1e30).
- `score_3d` (csrc/ekf_update_3d.cu::score_3d_kernel) does the same below
  the high-watermark, in windows of 256.
- `measurement_update_3d` scores the frame itself by the same device
  function (`score_sweep`), whose hole ballot also lists the first min(Z,
  64) free lanes below the high-watermark; the lanes at or above it follow.
  Observation i then takes its slot by its exclusive rank among the new
  observations (ballot and prefix; emulated in order).
- The apply: one thread per distinct target lane walks that lane's
  observations in order; any order that keeps each lane's observations in
  observation order gives the serial apply's state bit for bit.

Every emulated (ll, lane) equals the twin's bit for bit (the best is the
largest score, ties to the smallest lane, whatever the reduction order), and
the association built on it equals JAX's XLA association.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.core.config import FrontendConfig as JFrontendConfig
from parakeet_slam_tpu.core.state import Observation as JObservation
from parakeet_slam_tpu.core.state import make_particle_state as j_make_state
from parakeet_slam_tpu.filter import FastSLAM as JFastSLAM
from parakeet_slam_tpu_torch.eval.kernel_inputs import (CAMERAS, camera_par, prefilled_frame,
                                                        prefilled_frame_3d)
from parakeet_slam_tpu_torch.kernels import ekf_update as E2
from parakeet_slam_tpu_torch.kernels import ekf_update_3d as E3

THREADS = 256
NEG = float(np.float32(-1e30))
R_VAR_2D, SIG_VAR, LOG_P0_2D = (0.01, 0.0009), 0.25, -8.0
NOISE_3D = {"pinhole_3d": (2.0, 2.0), "stereo_3d": (1.5, 1.5, 1.0), "equirect_3d": (3.0, 3.0)}


def _take_better(a, b):
    return b if (b[0] > a[0] or (b[0] == a[0] and b[1] < a[1])) else a


def _first_free(valid_row):
    free = np.flatnonzero(~valid_row)
    return int(free[0]) if free.size else None


def emulate_sweep(ll, valid, window, hwm=None, obs=None):
    """The kernels' sweep on per-pair scores ll [P, Z, L] (the twin's, with
    invalid lanes at -1e30) and valid [P, L]: (best ll [P, Z], lane [P, Z]).
    `hwm` [P] bounds the listed lanes (score_3d); `obs` limits the swept
    observations (ekf_update_2d skips invalid ones)."""
    P, Z, L = ll.shape
    G = THREADS // Z
    out_ll = np.full((P, Z), np.nan, np.float32)
    out_ix = np.full((P, Z), -1, np.int64)
    for p in range(P):
        lim = L if hwm is None else int(hwm[p])
        lists = [[l for l in range(l0, min(l0 + window, lim)) if valid[p, l]]
                 for l0 in range(0, lim, window)]
        free = _first_free(valid[p])
        for i in range(Z) if obs is None else obs:
            best = [(-np.inf, 2**31 - 1)] * G
            for listed in lists:
                for g in range(G):
                    for j in range(g, len(listed), G):
                        v = float(ll[p, i, listed[j]])
                        if v > best[g][0]:
                            best[g] = (v, listed[j])
            acc = best[0]
            for g in range(1, G):
                acc = _take_better(acc, best[g])
            if free is not None:
                acc = _take_better(acc, (NEG, free))
            out_ll[p, i], out_ix[p, i] = acc
    return out_ll, out_ix


# ---------------------------------------------------------------------------
# ekf_update_2d
# ---------------------------------------------------------------------------


def _frame_2d(P, L, Z, S, seed, case):
    fr = prefilled_frame(P, L, Z, S, seed, fill="full" if case == "full" else
                         "empty" if case == "empty" else "holes")
    v = fr["lm_valid"]
    if case == "ties":  # lane k + L/2 is an exact copy of lane k
        h = L // 2
        for k in ("lm_mean", "lm_cov", "lm_sig"):
            fr[k][:, h:] = fr[k][:, :h]
        v[:, h:] = v[:, :h]
    elif case == "nan_below":  # every valid lane scores NaN; lane 3 is invalid
        v[:] = True
        v[:, 3] = False
        fr["lm_cov"][:] = np.nan
    elif case == "invalid_below":  # lanes 0-2 invalid, every valid lane NaN
        v[:] = True
        v[:, :3] = False
        fr["lm_cov"][:] = np.nan
    elif case == "below_neg":  # valid scores finite but under -1e30; lane 5 invalid
        v[:] = True
        v[:, 5] = False
        fr["lm_sig"][:] = 1e17
    return fr


def _scores_2d(fr, S):
    T = {k: torch.as_tensor(a) for k, a in fr.items()}
    geom = E2._lane_geometry(T["pose"], T["lm_mean"], T["lm_cov"], R_VAR_2D)
    ll = torch.stack([E2._pair_scores(geom, T["lm_sig"], T["lm_valid"], T["z"][i], T["sig"][i],
                                      S, SIG_VAR) for i in range(len(fr["z"]))], 1)
    best, best_ll = E2._score_frame(T["pose"], T["lm_mean"], T["lm_cov"], T["lm_sig"],
                                    T["lm_valid"], T["z"], T["sig"], S, R_VAR_2D, SIG_VAR)
    return T, ll.numpy(), best.numpy(), best_ll.numpy()


CASES_2D = [  # (case, L, Z, S)
    ("holes", 700, 16, 3), ("ties", 600, 16, 3), ("nan_below", 40, 8, 3),
    ("invalid_below", 40, 8, 0), ("below_neg", 40, 8, 3), ("empty", 40, 8, 3),
    ("full", 530, 16, 2), ("holes", 300, 64, 4), ("holes", 90, 5, 3), ("holes", 50, 1, 1),
]


@pytest.mark.parametrize("case,L,Z,S", CASES_2D,
                         ids=[f"{c}-L{L}-Z{Z}-S{S}" for c, L, Z, S in CASES_2D])
def test_ekf_update_2d_sweep_equals_the_twin(case, L, Z, S):
    P = 3
    fr = _frame_2d(P, L, Z, S, seed=L + Z, case=case)
    _, ll, best, best_ll = _scores_2d(fr, S)
    obs = np.flatnonzero(fr["valid"])  # invalid observations are not swept
    e_ll, e_ix = emulate_sweep(ll, fr["lm_valid"], window=512, obs=obs)
    np.testing.assert_array_equal(e_ix[:, obs], best[:, obs])
    np.testing.assert_array_equal(e_ll[:, obs].view(np.int32), best_ll[:, obs].view(np.int32))
    if case == "ties":
        assert (best[:, obs] < L // 2).all()
    if case in ("nan_below", "invalid_below"):
        assert (best[:, obs] == 0).all() and (best_ll[:, obs] == NEG).all()
    if case == "below_neg":
        assert (best[:, obs] == 5).all()


def _jax_2d(fr, S, Z, L):
    P = fr["pose"].shape[0]
    jcfg = JFilterConfig(num_particles=P, max_landmarks=L, max_observations=Z, sig_dim=S,
                         meas_noise=(0.1, 0.03), sig_noise=0.5, max_range=6.5,
                         fov_half_angle=2.5, use_pallas=False, new_landmark_loglik=LOG_P0_2D)
    jst = j_make_state(P, L, 2, S).replace(
        **{k: jnp.asarray(fr[k]) for k in ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig",
                                            "lm_valid", "lm_count")})
    jobs = JObservation(z=jnp.asarray(fr["z"]), sig=jnp.asarray(fr["sig"]),
                        desc=jnp.zeros((Z, 0), jnp.uint32), valid=jnp.asarray(fr["valid"]))
    return JFastSLAM(jcfg), jst, jobs


@pytest.mark.parametrize("case,L,Z,S", [("holes", 700, 16, 3), ("ties", 600, 16, 3),
                                        ("nan_below", 40, 8, 3), ("empty", 40, 8, 3)])
def test_ekf_update_2d_association_matches_jax(case, L, Z, S):
    fr = _frame_2d(3, L, Z, S, seed=L + Z + 1, case=case)
    T, ll, _, _ = _scores_2d(fr, S)
    e_ll, e_ix = emulate_sweep(ll, fr["lm_valid"], window=512)
    target, *_ = E2._associate(T["lm_valid"], torch.as_tensor(e_ix), torch.as_tensor(e_ll),
                               T["valid"], LOG_P0_2D)
    jslam, jst, jobs = _jax_2d(fr, S, Z, L)
    np.testing.assert_array_equal(target.numpy(), np.asarray(jslam._associate_frame(jst, jobs)[0]))
    j_best, j_ll = (np.asarray(a) for a in jslam._score_frame(jst, jobs))
    obs = np.flatnonzero(fr["valid"])
    np.testing.assert_array_equal(e_ix[:, obs], j_best[:, obs])
    np.testing.assert_allclose(e_ll[:, obs], j_ll[:, obs], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ekf_update_2d_lane_parallel_apply_equals_the_serial_apply(seed):
    """One particle, pairs of observations on one lane: the twin's apply
    step run in the kernel's order (lanes in reverse order of their first
    observation, each lane's observations in order) against the twin, which
    applies in observation order."""
    fr = prefilled_frame(1, 64, 16, 3, seed, collide=True)
    T = {k: torch.as_tensor(a) for k, a in fr.items()}
    kw = dict(sig_dim=3, r_var=R_VAR_2D, sig_var=SIG_VAR, log_p0=LOG_P0_2D, init_infl=1.0,
              max_range=6.5, fov_half=2.5, cull=False)
    state = [T[k] for k in ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_valid",
                            "lm_count")]
    serial = E2.measurement_update_2d_reference(*state, T["z"], T["sig"], T["valid"], **kw)
    best, best_ll = E2._score_frame(T["pose"], T["lm_mean"], T["lm_cov"], T["lm_sig"],
                                    T["lm_valid"], T["z"], T["sig"], 3, R_VAR_2D, SIG_VAR)
    target, is_new, _, _ = E2._associate(T["lm_valid"], best, best_ll, T["valid"], LOG_P0_2D)
    tgt = target[0].tolist()
    heads = sorted({t: i for i, t in reversed(list(enumerate(tgt))) if t >= 0}.items(),
                   key=lambda kv: -kv[1])
    order = [i for lane, _ in heads for i in range(len(tgt)) if tgt[i] == lane]
    assert len(order) > len(heads)  # collisions: a lane with two observations
    lanes = [T[k].clone() for k in ("lm_mean", "lm_cov", "lm_sig", "lm_valid", "lm_count")]
    matched = torch.zeros_like(T["lm_valid"])
    for i in order:
        E2._apply_observation(i, target, is_new, T["pose"], T["z"], T["sig"], 3, R_VAR_2D, 1.0,
                              *lanes, matched)
    for a, b in zip(serial[1:6], lanes):
        assert torch.equal(a, b)
    assert torch.equal(serial[7], target.to(torch.int32))


# ---------------------------------------------------------------------------
# score_3d
# ---------------------------------------------------------------------------


def _frame_3d(model, P, L, Z, seed, case):
    fr = prefilled_frame_3d(P, L, Z, model, seed, fill="full" if case == "full" else
                            "empty" if case == "empty" else "holes")
    v = fr["lm_valid"]
    if case == "ties":
        h = L // 2
        for k in ("lm_mean", "lm_cov", "lm_desc"):
            fr[k][:, h:2 * h] = fr[k][:, :h]
        v[:, h:2 * h] = v[:, :h]
    elif case == "nan_below":  # lane 2 invalid below NaN-scoring valid lanes
        v[:, :200] = True
        v[:, 2] = False
        v[:, 200:] = False
        fr["lm_cov"][:] = np.nan
    elif case == "hwm_holes":  # valid lanes only in the middle: holes below, none above
        v[:] = False
        v[:, 300:520:3] = True
    return fr


def _scores_3d(fr, model, W):
    T = {k: torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a) for k, a in fr.items()}
    c = E3.Consts(model, camera_par(model), tuple(v * v for v in NOISE_3D[model]), 0.5)
    cam = E3.camera_rows(T["pose"])
    desc, lm_desc = T["desc"][:, :W], T["lm_desc"][..., :W]
    geom = E3._lane_geometry(c, cam, T["lm_mean"], T["lm_cov"], c.r_var)
    ll = torch.stack([E3._pair_scores(c, geom, lm_desc, T["lm_valid"], T["z"][i], desc[i], W)
                      for i in range(len(fr["z"]))], 1)
    best, best_ll = E3._score_frame(c, cam, T["lm_mean"], T["lm_cov"], lm_desc, T["lm_valid"],
                                    T["z"], desc, W, c.r_var)
    return ll.numpy(), best.numpy(), best_ll.numpy()


def _hwm(valid):
    return np.array([(np.flatnonzero(r)[-1] + 1) if r.any() else 0 for r in valid])


CASES_3D = [  # (model, case, L, Z, W)
    ("stereo_3d", "holes", 600, 32, 8), ("pinhole_3d", "holes", 600, 16, 0),
    ("equirect_3d", "holes", 300, 8, 1), ("stereo_3d", "holes", 300, 128, 3),
    ("pinhole_3d", "ties", 520, 16, 8), ("stereo_3d", "nan_below", 300, 8, 8),
    ("equirect_3d", "hwm_holes", 700, 16, 8), ("stereo_3d", "empty", 64, 8, 8),
    ("pinhole_3d", "full", 300, 24, 8),
]


@pytest.mark.parametrize("model,case,L,Z,W", CASES_3D,
                         ids=[f"{m}-{c}-L{L}-Z{Z}-W{W}" for m, c, L, Z, W in CASES_3D])
def test_score_3d_sweep_equals_the_twin(model, case, L, Z, W):
    fr = _frame_3d(model, 3, L, Z, seed=L + Z + W, case=case)
    ll, best, best_ll = _scores_3d(fr, model, W)
    e_ll, e_ix = emulate_sweep(ll, fr["lm_valid"], window=256, hwm=_hwm(fr["lm_valid"]))
    np.testing.assert_array_equal(e_ix, best)
    np.testing.assert_array_equal(e_ll.view(np.int32), best_ll.view(np.int32))
    if case == "nan_below":
        assert (best == 0).all() and (best_ll == NEG).all()
    if case == "empty":
        assert (best == 0).all()


@pytest.mark.parametrize("model", ["stereo_3d", "equirect_3d"])
def test_score_3d_sweep_matches_jax(model):
    """The emulated lanes against JAX's XLA scoring of the same frame."""
    L, Z = 600, 16
    fr = _frame_3d(model, 3, L, Z, seed=4, case="holes")
    ll, _, _ = _scores_3d(fr, model, 8)
    e_ll, e_ix = emulate_sweep(ll, fr["lm_valid"], window=256, hwm=_hwm(fr["lm_valid"]))
    fx, fy, cx, cy, b, w, h = CAMERAS[model]
    jcfg = JFilterConfig(num_particles=3, max_landmarks=L, max_observations=Z, lm_dim=3,
                         obs_dim=len(NOISE_3D[model]), pose_dim=7, sig_dim=0, desc_words=8,
                         desc_weight=0.5, measurement_model=model,
                         motion_model="se3_odometry", meas_noise=NOISE_3D[model],
                         new_landmark_loglik=-30.0, use_pallas=False)
    fe = dict(camera="stereo" if model == "stereo_3d" else "pinhole", baseline=b,
              intrinsics=(fx, fy, cx, cy), image_size=(int(h), int(w)))
    jslam = JFastSLAM(jcfg, JFrontendConfig(**fe))
    jst = j_make_state(3, L, 3, 0, 8, 7).replace(
        **{k: jnp.asarray(fr[k]) for k in ("pose", "log_w", "lm_mean", "lm_cov", "lm_desc",
                                            "lm_valid", "lm_count")})
    jobs = JObservation(z=jnp.asarray(fr["z"]), sig=jnp.zeros((Z, 0)),
                        desc=jnp.asarray(fr["desc"]), valid=jnp.asarray(fr["valid"]))
    j_best, j_ll = (np.asarray(a) for a in jslam._score_frame(jst, jobs))
    np.testing.assert_array_equal(e_ix, j_best)
    np.testing.assert_allclose(e_ll, j_ll, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# measurement_update_3d's own score pass: score_3d's sweep, with the free
# slots listed by the same hole ballot
# ---------------------------------------------------------------------------

MAX_FREE = 64
UPDATE_KW_3D = dict(log_p0=-30.0, init_infl=1.0, init_range_prior=8.0, init_range_sigma=3.0,
                    max_range=35.0, cull=True)


def emulate_free_slots(valid, Z, window=256):
    """The update kernel's free slots [P] of lists: each window of 256 lanes
    below the high-watermark lists its invalid lanes (ballot and prefix) in
    ascending order while fewer than min(Z, 64) are listed; the lanes at or
    above the high-watermark, all free, follow in order."""
    P, L = valid.shape
    n_fs = min(Z, MAX_FREE)
    hwm = _hwm(valid)
    out = []
    for p in range(P):
        free = []
        for l0 in range(0, int(hwm[p]), window):
            free += [l for l in range(l0, min(l0 + window, int(hwm[p]))) if not valid[p, l]]
        free = free[:n_fs]
        free += list(range(int(hwm[p]), min(L, int(hwm[p]) + n_fs - len(free))))
        out.append(free)
    return out


def emulate_association(valid, best_ll, best_ix, zvalid, free, log_p0):
    """The kernel's association: observation i's slot is its exclusive rank
    among the new observations (the kernel takes it by ballot and prefix;
    here in order). Returns (target [P, Z], n_match [P])."""
    P, Z = best_ll.shape
    target = np.full((P, Z), -1, np.int64)
    n_match = np.zeros(P, np.float32)
    for p in range(P):
        any_valid = bool(valid[p].any())
        arank = 0
        for i in range(Z):
            is_new = bool(best_ll[p, i] < np.float32(log_p0)) or not any_valid
            do_new = is_new and bool(zvalid[i])
            do_alloc = do_new and arank < len(free[p])
            do_upd = not is_new and bool(zvalid[i])
            target[p, i] = best_ix[p, i] if do_upd else (free[p][arank] if do_alloc else -1)
            arank += do_new
            n_match[p] += do_upd or do_alloc
    return target, n_match


def _update_reference_3d(fr, model, W):
    T = {k: torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a) for k, a in fr.items()}
    state = [T[k] for k in ("pose", "log_w", "lm_mean", "lm_cov")]
    state += [T["lm_desc"][..., :W].contiguous(), T["lm_valid"], T["lm_count"]]
    return E3.measurement_update_3d_reference(
        *state, T["z"], T["desc"][:, :W].contiguous(), T["valid"], model=model, desc_words=W,
        par=camera_par(model), r_var=tuple(v * v for v in NOISE_3D[model]), desc_weight=0.5,
        **UPDATE_KW_3D)


@pytest.mark.parametrize("model,case,L,Z,W", CASES_3D,
                         ids=[f"{m}-{c}-L{L}-Z{Z}-W{W}" for m, c, L, Z, W in CASES_3D])
def test_update_3d_own_sweep_equals_the_twin(model, case, L, Z, W):
    """The update's own score pass in the shared sweep's order, its free
    slots from the hole ballot and its association loop: targets and
    n_match equal to the twin's, bit for bit."""
    fr = _frame_3d(model, 3, L, Z, seed=L + Z + W + 1, case=case)
    ll, _, _ = _scores_3d(fr, model, W)
    e_ll, e_ix = emulate_sweep(ll, fr["lm_valid"], window=256, hwm=_hwm(fr["lm_valid"]))
    free = emulate_free_slots(fr["lm_valid"], Z)
    target, n_match = emulate_association(fr["lm_valid"], e_ll, e_ix, fr["valid"], free,
                                          UPDATE_KW_3D["log_p0"])
    ref = _update_reference_3d(fr, model, W)
    np.testing.assert_array_equal(target, ref[7].numpy())
    np.testing.assert_array_equal(n_match, ref[6].numpy())
    if case != "full":
        assert (target >= 0).any()


def test_update_3d_free_slots_cover_the_twin_s_free_lanes():
    """Holes far below the high-watermark, a high-watermark inside the first
    window and a full map: the listed slots are the first min(Z, 64) free
    lanes in ascending order, as the twin sorts them."""
    rng = np.random.default_rng(3)
    L = 1100
    valid = rng.random((6, L)) < 0.97
    valid[1, 700:] = False          # hwm 700, few holes below
    valid[2, 40:] = False           # hwm in the first window
    valid[3] = True                 # full: no slot
    valid[4] = False                # empty: lanes 0..n_fs-1
    valid[5, L - 1] = True          # hwm at L, holes only below
    for Z in (8, 64, 128):
        free = emulate_free_slots(valid, Z)
        for p in range(valid.shape[0]):
            np.testing.assert_array_equal(free[p], np.flatnonzero(~valid[p])[:min(Z, MAX_FREE)])


def test_update_3d_own_sweep_association_matches_jax():
    model, L, Z = "stereo_3d", 600, 32
    fr = _frame_3d(model, 3, L, Z, seed=11, case="holes")
    ll, _, _ = _scores_3d(fr, model, 8)
    e_ll, e_ix = emulate_sweep(ll, fr["lm_valid"], window=256, hwm=_hwm(fr["lm_valid"]))
    target, _ = emulate_association(fr["lm_valid"], e_ll, e_ix, fr["valid"],
                                    emulate_free_slots(fr["lm_valid"], Z), UPDATE_KW_3D["log_p0"])
    fx, fy, cx, cy, b, w, h = CAMERAS[model]
    jcfg = JFilterConfig(num_particles=3, max_landmarks=L, max_observations=Z, lm_dim=3,
                         obs_dim=3, pose_dim=7, sig_dim=0, desc_words=8, desc_weight=0.5,
                         measurement_model=model, motion_model="se3_odometry",
                         meas_noise=NOISE_3D[model], new_landmark_loglik=-30.0,
                         use_pallas=False)
    jslam = JFastSLAM(jcfg, JFrontendConfig(camera="stereo", baseline=b,
                                            intrinsics=(fx, fy, cx, cy),
                                            image_size=(int(h), int(w))))
    jst = j_make_state(3, L, 3, 0, 8, 7).replace(
        **{k: jnp.asarray(fr[k]) for k in ("pose", "log_w", "lm_mean", "lm_cov", "lm_desc",
                                            "lm_valid", "lm_count")})
    jobs = JObservation(z=jnp.asarray(fr["z"]), sig=jnp.zeros((Z, 0)),
                        desc=jnp.asarray(fr["desc"]), valid=jnp.asarray(fr["valid"]))
    np.testing.assert_array_equal(target, np.asarray(jslam._associate_frame(jst, jobs)[0]))
    assert (target >= 0).sum() > Z
