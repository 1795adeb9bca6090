"""Parity of the port's fused 3-D update and score twins with the JAX
package: the XLA path (`FastSLAM.measurement_core`, use_pallas=False, over
several frames) and the Pallas kernels (`ekf_update_3d.measurement_update_3d`
and `score_3d`, interpret mode), on the same numpy inputs.

Masks, counts, target lanes, n_match and descriptors must be equal.
Floats: means and covariances to rtol=atol=1e-4 (the stereo init inverts
with cofactors here and with an LU solve in the XLA path; R enters as
float32(sigma^2) here and float32(sigma)^2 there), log_w to atol=1e-3
(sums in another order). These are tighter than the reference's own
Pallas-vs-XLA bounds (tests/test_ekf3d_kernel.py: 1e-3 to 2e-3, log_w 1e-2).
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
from parakeet_slam_tpu.kernels import ekf_update_3d as j_ekf3d
from parakeet_slam_tpu_torch.core.config import FilterConfig, FrontendConfig
from parakeet_slam_tpu_torch.core.state import Observation, state_from_numpy, state_to_numpy
from parakeet_slam_tpu_torch.eval.kernel_inputs import CAMERAS, camera_par, prefilled_frame_3d
from parakeet_slam_tpu_torch.filter import FastSLAM
from parakeet_slam_tpu_torch.kernels import ekf_update_3d

P = 8
MODELS = ("pinhole_3d", "stereo_3d", "equirect_3d")
STATE_KEYS = ("pose", "log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid", "lm_count")
OUT_KEYS = STATE_KEYS[1:]
NOISE = {"pinhole_3d": (2.0, 2.0), "stereo_3d": (1.5, 1.5, 1.0), "equirect_3d": (3.0, 3.0)}


def _cfgs(model, L, Z, **overrides):
    Dz = len(NOISE[model])
    fx, fy, cx, cy, b, W, H = CAMERAS[model]
    kw = dict(
        num_particles=P, max_landmarks=L, max_observations=Z, lm_dim=3, obs_dim=Dz,
        pose_dim=7, sig_dim=0, desc_words=8, desc_weight=0.5,
        measurement_model=model, motion_model="se3_odometry", motion_noise=(0.02, 0.01),
        meas_noise=NOISE[model], new_landmark_loglik=-30.0, max_range=35.0,
        init_range_prior=8.0, init_range_sigma=3.0, **overrides,
    )
    fe = dict(camera="stereo" if model == "stereo_3d" else "pinhole", baseline=b,
              intrinsics=(fx, fy, cx, cy), image_size=(int(H), int(W)))
    return (FilterConfig(**kw), FrontendConfig(**fe),
            JFilterConfig(**{**kw, "use_pallas": False}), JFrontendConfig(**fe))


def _jstate(fr):
    P_, L = fr["lm_valid"].shape
    return j_make_state(P_, L, 3, 0, 8, 7).replace(
        **{k: jnp.asarray(fr[k]) for k in STATE_KEYS}
    )


def _obs(fr):
    j = JObservation(z=jnp.asarray(fr["z"]), sig=jnp.zeros((len(fr["z"]), 0)),
                     desc=jnp.asarray(fr["desc"]), valid=jnp.asarray(fr["valid"]))
    t = Observation(z=torch.as_tensor(fr["z"]), sig=torch.zeros(len(fr["z"]), 0),
                    desc=torch.as_tensor(fr["desc"].view(np.int32)),
                    valid=torch.as_tensor(fr["valid"]))
    return j, t


def _kw(slam):
    c = slam.cfg
    return dict(
        model=c.measurement_model, desc_words=c.desc_words,
        par=slam._vision_kernel_params(), r_var=slam._meas_var(False),
        desc_weight=float(c.desc_weight), log_p0=slam._log_p0_assoc(),
        init_infl=float(c.init_cov_inflation), init_range_prior=float(c.init_range_prior),
        init_range_sigma=float(c.init_range_sigma), max_range=float(c.max_range),
        cull=c.cull_enabled, cull_unseen=c.cull_unseen, freeze=c.freeze_min_count,
    )


def _assert_state(got, want, what, vm=None):
    for k in ("lm_valid", "lm_count"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{what} {k}")
    vm = np.asarray(want["lm_valid"]) if vm is None else vm
    np.testing.assert_array_equal(got["lm_desc"][vm], np.asarray(want["lm_desc"])[vm],
                                  err_msg=f"{what} lm_desc")
    for k in ("lm_mean", "lm_cov"):
        np.testing.assert_allclose(got[k][vm], np.asarray(want[k])[vm], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["log_w"], np.asarray(want["log_w"]), atol=1e-3,
                               err_msg=f"{what} log_w")


# (id, L, Z, frames, fill, config overrides, weight_matched)
XLA_CASES = [
    ("holes_4frames", 32, 4, 4, "holes", {}, True),
    ("full_map", 32, 8, 1, "full", {}, True),
    ("empty_map", 32, 8, 1, "empty", {}, True),
    ("cull_unseen_3frames", 32, 8, 3, "holes", {"cull_unseen": True}, True),
    ("freeze_3frames", 32, 8, 3, "holes", {"freeze_min_count": 4}, True),
    ("no_cull", 32, 4, 1, "holes", {"cull_enabled": False}, True),
    ("no_weights", 32, 8, 1, "holes", {}, False),
    ("beyond_slot_cap", 80, 72, 1, "empty", {}, True),
]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("L,Z,frames,fill,overrides,weight_matched",
                         [c[1:] for c in XLA_CASES], ids=[c[0] for c in XLA_CASES])
def test_twin_matches_xla_path(model, L, Z, frames, fill, overrides, weight_matched):
    cfg, fe, jcfg, jfe = _cfgs(model, L, Z, **overrides)
    slam, jslam = FastSLAM(cfg, fe), JFastSLAM(jcfg, jfe)
    seed = 7 * L + Z + MODELS.index(model)
    first = prefilled_frame_3d(P, L, Z, model, seed, fill=fill)
    st_x, st_t = _jstate(first), state_from_numpy(_jstate(first), device="cpu")
    for f in range(frames):
        fr = first if f == 0 else prefilled_frame_3d(P, L, Z, model, seed + f)
        if f:  # each later frame: new poses, the map carried over
            pose = fr["pose"]
            st_x, st_t = st_x.replace(pose=jnp.asarray(pose)), st_t.replace(pose=torch.as_tensor(pose))
        jobs, tobs = _obs(fr)
        j_target = np.asarray(jslam._associate_frame(st_x, jobs)[0])
        out = ekf_update_3d.measurement_update_3d(
            *(getattr(st_t, k) for k in STATE_KEYS), tobs.z, tobs.desc, tobs.valid,
            update_weights=weight_matched, **_kw(slam),
        )
        np.testing.assert_array_equal(out[7].numpy(), j_target, err_msg=f"frame {f} target")
        via_slam, mean_match = slam.measurement_core(st_t, tobs, weight_matched)
        st_t = st_t.replace(**dict(zip(OUT_KEYS, out[:6])))
        got = state_to_numpy(st_t)
        for k in STATE_KEYS:  # the filter's routing gives the same state
            np.testing.assert_array_equal(state_to_numpy(via_slam)[k], got[k], err_msg=k)
        st_x, x_match = jslam.measurement_core(st_x, jobs, weight_matched)
        _assert_state(got, st_x.__dict__, f"{model} frame {f}")
        np.testing.assert_allclose(float(mean_match), float(x_match), rtol=1e-6)
        if f == 0 and fill == "empty":
            assert int(st_t.lm_valid[0].sum()) == min(Z - 1, 64)


def _pallas(slam, st, obs, ext=None, **flags):
    kw = _kw(slam)
    kw.pop("freeze")
    kw.update(flags)
    ext_ll, ext_ix = (None, None) if ext is None else (jnp.asarray(ext[0]), jnp.asarray(ext[1]))
    return j_ekf3d.measurement_update_3d(
        st.pose, st.log_w, st.lm_mean, st.lm_cov, st.lm_desc, st.lm_valid, st.lm_count,
        obs.z, obs.desc, obs.valid, ext_ll, ext_ix, interpret=True, **kw,
    )


# (id, model, L, Z, fill, flags, use external scores)
PALLAS_CASES = [
    ("pinhole", "pinhole_3d", 32, 4, "holes", {}, False),
    ("stereo", "stereo_3d", 32, 4, "holes", {}, False),
    ("equirect_full", "equirect_3d", 32, 4, "full", {}, False),
    ("ext_scores", "stereo_3d", 32, 4, "holes", {}, True),
    ("no_weights", "pinhole_3d", 32, 4, "holes", {"update_weights": False}, False),
    ("freeze", "stereo_3d", 32, 4, "holes", {"freeze": 4}, False),
    ("cull_unseen", "equirect_3d", 32, 4, "holes", {"cull_unseen": True}, False),
    ("L1100", "pinhole_3d", 1100, 4, "holes", {}, False),
]


@pytest.mark.parametrize("model,L,Z,fill,flags,ext", [c[1:] for c in PALLAS_CASES],
                         ids=[c[0] for c in PALLAS_CASES])
def test_twin_matches_pallas_kernel(model, L, Z, fill, flags, ext):
    cfg, fe, _, _ = _cfgs(model, L, Z)
    slam = FastSLAM(cfg, fe)
    fr = prefilled_frame_3d(P, L, Z, model, seed=L + Z, fill=fill)
    jst, (jobs, tobs) = _jstate(fr), _obs(fr)
    st = state_from_numpy(jst, device="cpu")
    kw = {**_kw(slam), **flags}
    scores = None
    if ext:  # scores at other poses, as FastSLAM 2.0's proposal makes them
        moved = st.pose.clone()
        moved[:, :3] += 0.01
        ll, ix = ekf_update_3d.score_3d(
            moved, st.lm_mean, st.lm_cov, st.lm_desc, st.lm_valid, tobs.z, tobs.desc,
            model=model, desc_words=8, par=kw["par"], r_var=kw["r_var"],
            desc_weight=kw["desc_weight"],
        )
        scores = (ll.numpy(), ix.numpy())
    out = ekf_update_3d.measurement_update_3d(
        *(getattr(st, k) for k in STATE_KEYS), tobs.z, tobs.desc, tobs.valid,
        *((torch.as_tensor(scores[0]), torch.as_tensor(scores[1])) if ext else ()), **kw,
    )
    p_out = _pallas(slam, jst, jobs, scores,
                    **{k: v for k, v in flags.items() if k != "freeze"},
                    **({"freeze": flags["freeze"]} if "freeze" in flags else {}))
    got = state_to_numpy(st.replace(**dict(zip(OUT_KEYS, out[:6]))))
    want = dict(zip(OUT_KEYS, p_out[:6]))
    _assert_state(got, want, model)
    np.testing.assert_array_equal(out[6].numpy(), np.asarray(p_out[6]))
    assert int((out[7] >= 0).sum()) > 0


@pytest.mark.parametrize("model", MODELS)
def test_score_twin_matches_pallas_score_3d(model):
    cfg, fe, _, _ = _cfgs(model, 32, 6)
    slam = FastSLAM(cfg, fe)
    fr = prefilled_frame_3d(P, 32, 6, model, seed=3, fill="holes")
    jst, (jobs, tobs) = _jstate(fr), _obs(fr)
    st = state_from_numpy(jst, device="cpu")
    kw = dict(model=model, desc_words=8, par=slam._vision_kernel_params(),
              r_var=slam._meas_var(True), desc_weight=0.5)
    ll, ix = ekf_update_3d.score_3d(st.pose, st.lm_mean, st.lm_cov, st.lm_desc,
                                    st.lm_valid, tobs.z, tobs.desc, **kw)
    j_ll, j_ix = j_ekf3d.score_3d(jst.pose, jst.lm_mean, jst.lm_cov, jst.lm_desc,
                                  jst.lm_valid, jobs.z, jobs.desc, interpret=True, **kw)
    np.testing.assert_array_equal(ix.numpy(), np.asarray(j_ix))
    np.testing.assert_allclose(ll.numpy(), np.asarray(j_ll), rtol=1e-5, atol=1e-4)
    # the filter's sweep returns the same scores as (lane, ll)
    best, best_ll = slam._frame_scores(st, tobs)
    assert torch.equal(best, ix) and torch.equal(best_ll, ll)


def test_nonfinite_lanes_follow_the_xla_association():
    """A particle whose valid lanes all score non-finite: the XLA path (and
    so the port) still treats the particle as having candidates, and every
    observation becomes new."""
    model = "pinhole_3d"
    cfg, fe, jcfg, jfe = _cfgs(model, 32, 4)
    slam, jslam = FastSLAM(cfg, fe), JFastSLAM(jcfg, jfe)
    fr = prefilled_frame_3d(P, 32, 4, model, seed=5)
    fr["lm_cov"][2] = np.nan  # particle 2: every lane scores NaN
    fr["lm_mean"][3, :5] = np.inf  # particle 3: a few lanes with inf means
    jst, (jobs, tobs) = _jstate(fr), _obs(fr)
    st = state_from_numpy(jst, device="cpu")
    out = ekf_update_3d.measurement_update_3d(
        *(getattr(st, k) for k in STATE_KEYS), tobs.z, tobs.desc, tobs.valid, **_kw(slam),
    )
    j_target = np.asarray(jslam._associate_frame(jst, jobs)[0])
    np.testing.assert_array_equal(out[7].numpy(), j_target)
    jx, _ = jslam.measurement_core(jst, jobs)
    for k in ("lm_valid", "lm_count"):
        np.testing.assert_array_equal(out[OUT_KEYS.index(k)].numpy(), np.asarray(getattr(jx, k)))
    free = np.flatnonzero(~fr["lm_valid"][2])
    np.testing.assert_array_equal(out[7][2, :3].numpy(), free[:3])  # all new


def test_cpu_wrappers_take_the_twins_without_launching():
    model = "stereo_3d"
    cfg, fe, _, _ = _cfgs(model, 32, 4)
    slam = FastSLAM(cfg, fe)
    fr = prefilled_frame_3d(P, 32, 4, model, seed=9)
    st = state_from_numpy(_jstate(fr), device="cpu")
    _, tobs = _obs(fr)
    before = (ekf_update_3d.measurement_update_3d.launches, ekf_update_3d.score_3d.launches)
    args = [getattr(st, k) for k in STATE_KEYS] + [tobs.z, tobs.desc, tobs.valid]
    a = ekf_update_3d.measurement_update_3d(*args, **_kw(slam))
    b = ekf_update_3d.measurement_update_3d_reference(*args, **_kw(slam))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    score_kw = dict(model=model, desc_words=8, par=slam._vision_kernel_params(),
                    r_var=slam._meas_var(True), desc_weight=0.5)
    ekf_update_3d.score_3d(st.pose, st.lm_mean, st.lm_cov, st.lm_desc, st.lm_valid,
                           tobs.z, tobs.desc, **score_kw)
    after = (ekf_update_3d.measurement_update_3d.launches, ekf_update_3d.score_3d.launches)
    assert after == before
    np.testing.assert_array_equal(st.lm_mean.numpy(), fr["lm_mean"])  # inputs unchanged


def test_popcount_is_exact():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.array([bin(int(w)).count("1") for w in words])
    got = ekf_update_3d._popcount32(torch.as_tensor(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_check_devices_and_shapes():
    st = state_from_numpy(_jstate(prefilled_frame_3d(2, 8, 2, "pinhole_3d", 1)), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ekf_update_3d._check_map("score_3d", st.pose, st.lm_mean, st.lm_cov, st.lm_desc,
                                 st.lm_valid, torch.zeros(2, 2), st.lm_desc[0, :2],
                                 "pinhole_3d", 8)
    with pytest.raises(ValueError, match="r_var"):
        ekf_update_3d.Consts("stereo_3d", camera_par("stereo_3d"), (1.0, 1.0))
