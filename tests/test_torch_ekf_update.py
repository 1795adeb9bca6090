"""Parity of the port's fused 2-D update twin with the JAX package: the XLA
path (`FastSLAM.measurement_core`, use_pallas=False) and the Pallas kernel
(`ekf_update.measurement_update_2d`, interpret mode), on the same numpy
inputs. Masks, counts and target lanes must be equal; floats agree to
rtol=atol=1e-5 and log_w to atol=1e-4 (sums in another order; the Pallas
kernel's polynomial atan2 is ~1e-7 rad off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core.config import FilterConfig as JFilterConfig
from parakeet_slam_tpu.core.state import Observation as JObservation
from parakeet_slam_tpu.core.state import make_particle_state as j_make_state
from parakeet_slam_tpu.filter import FastSLAM as JFastSLAM
from parakeet_slam_tpu.kernels import ekf_update as j_ekf
from parakeet_slam_tpu_torch.core.config import FilterConfig
from parakeet_slam_tpu_torch.core.state import Observation, state_from_numpy, state_to_numpy
from parakeet_slam_tpu_torch.eval.kernel_inputs import prefilled_frame
from parakeet_slam_tpu_torch.filter import FastSLAM
from parakeet_slam_tpu_torch.kernels import ekf_update

P = 8
STATE_KEYS = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_valid", "lm_count")

# (id, L, Z, S, frames, fill, collide, config overrides, weight_matched)
CASES = [
    ("holes", 16, 4, 3, 1, "holes", False, {}, True),
    ("holes_L130_3frames", 130, 8, 3, 3, "holes", True, {}, True),
    ("sig0", 130, 8, 0, 1, "holes", True, {}, True),
    ("collide", 16, 8, 3, 1, "holes", True, {}, True),
    ("full_map", 16, 4, 3, 1, "full", False, {}, True),
    ("empty_map", 16, 8, 3, 1, "empty", True, {}, True),
    ("cull_unseen_3frames", 130, 4, 3, 3, "holes", True, {"cull_unseen": True}, True),
    ("no_cull", 16, 8, 0, 1, "holes", True, {"cull_enabled": False}, True),
    ("no_weights", 130, 8, 3, 1, "holes", True, {}, False),
]


def _cfgs(L, Z, S, overrides):
    kw = dict(
        num_particles=P, max_landmarks=L, max_observations=Z, sig_dim=S,
        meas_noise=(0.1, 0.03), sig_noise=0.5, max_range=6.5, fov_half_angle=2.5,
        init_cov_inflation=1.0, use_pallas=True, **overrides,
    )
    return FilterConfig(**kw), JFilterConfig(**{**kw, "use_pallas": False})


def _frames(L, Z, S, frames, fill, collide, seed):
    """Frame 0's pre-filled state, and every frame's (pose, observations)."""
    first = prefilled_frame(P, L, Z, S, seed, fill=fill, collide=collide)
    rng = np.random.default_rng(seed + 100)
    out = []
    pose = first["pose"]
    for f in range(frames):
        fr = first if f == 0 else prefilled_frame(P, L, Z, S, seed + f, collide=collide)
        if f:
            pose = (pose + rng.normal(scale=0.02, size=pose.shape)).astype(np.float32)
        out.append((pose, {k: fr[k] for k in ("z", "sig", "valid")}))
    return first, out


def _assert_state(got, want, what):
    for k in ("lm_valid", "lm_count"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{what} {k}")
    for k in ("lm_mean", "lm_cov", "lm_sig"):
        np.testing.assert_allclose(
            got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-5, err_msg=f"{what} {k}"
        )
    np.testing.assert_allclose(got["log_w"], np.asarray(want["log_w"]), atol=1e-4, err_msg=what)


@pytest.mark.parametrize(
    "L,Z,S,frames,fill,collide,overrides,weight_matched",
    [c[1:] for c in CASES], ids=[c[0] for c in CASES],
)
def test_twin_matches_xla_path_and_pallas_kernel(
    L, Z, S, frames, fill, collide, overrides, weight_matched
):
    cfg, jcfg = _cfgs(L, Z, S, overrides)
    slam, jslam = FastSLAM(cfg), JFastSLAM(jcfg)
    first, frame_list = _frames(L, Z, S, frames, fill, collide, seed=L + Z + S)
    j0 = j_make_state(P, L, 2, S).replace(
        **{k: jnp.asarray(first[k]) for k in STATE_KEYS}
    )
    st_x, st_p, st_t = j0, j0, state_from_numpy(j0, device="cpu")
    for f, (pose, ob) in enumerate(frame_list):
        what = f"frame {f}"
        st_x = st_x.replace(pose=jnp.asarray(pose))
        st_p = st_p.replace(pose=jnp.asarray(pose))
        st_t = st_t.replace(pose=torch.as_tensor(pose))
        jobs = JObservation(
            z=jnp.asarray(ob["z"]), sig=jnp.asarray(ob["sig"]),
            desc=jnp.zeros((Z, 0), jnp.uint32), valid=jnp.asarray(ob["valid"]),
        )
        tobs = Observation(
            z=torch.as_tensor(ob["z"]), sig=torch.as_tensor(ob["sig"]),
            desc=torch.zeros(Z, 0, dtype=torch.int32), valid=torch.as_tensor(ob["valid"]),
        )

        # targets against the XLA association (pre-frame map)
        j_target = np.asarray(jslam._associate_frame(st_x, jobs)[0])
        out = ekf_update.measurement_update_2d(
            st_t.pose, st_t.log_w, st_t.lm_mean, st_t.lm_cov, st_t.lm_sig,
            st_t.lm_valid, st_t.lm_count, tobs.z, tobs.sig, tobs.valid,
            sig_dim=S, r_var=slam.r_var, sig_var=slam.sig_var,
            log_p0=cfg.new_landmark_loglik, init_infl=cfg.init_cov_inflation,
            max_range=cfg.max_range, fov_half=cfg.fov_half_angle,
            cull=cfg.cull_enabled, cull_unseen=cfg.cull_unseen,
            update_weights=weight_matched,
        )
        np.testing.assert_array_equal(out[7].numpy(), j_target, err_msg=what)
        via_slam, mean_match = slam.measurement_core(st_t, tobs, weight_matched)
        st_t = st_t.replace(**dict(zip(STATE_KEYS[1:], out[:6])))
        got = state_to_numpy(st_t)
        for k in STATE_KEYS:  # the filter's routing gives the same state
            np.testing.assert_array_equal(state_to_numpy(via_slam)[k], got[k], err_msg=k)

        st_x, x_match = jslam.measurement_core(st_x, jobs, weight_matched)
        _assert_state(got, st_x.__dict__, f"{what} vs XLA")
        np.testing.assert_allclose(float(mean_match), float(x_match), rtol=1e-6)

        p_out = j_ekf.measurement_update_2d(
            st_p.pose, st_p.log_w, st_p.lm_mean, st_p.lm_cov, st_p.lm_sig,
            st_p.lm_valid, st_p.lm_count, jobs.z, jobs.sig, jobs.valid,
            sig_dim=S, r_var=(jcfg.meas_noise[0] ** 2, jcfg.meas_noise[1] ** 2),
            sig_var=jcfg.sig_noise**2, log_p0=jcfg.new_landmark_loglik,
            init_infl=jcfg.init_cov_inflation, max_range=jcfg.max_range,
            fov_half=jcfg.fov_half_angle, cull=jcfg.cull_enabled,
            cull_unseen=jcfg.cull_unseen, interpret=True,
            update_weights=weight_matched,
        )
        st_p = st_p.replace(**dict(zip(STATE_KEYS[1:], p_out[:6])))
        _assert_state(got, st_p.__dict__, f"{what} vs Pallas")
        np.testing.assert_array_equal(out[6].numpy(), np.asarray(p_out[6]), err_msg=what)


def test_cpu_wrapper_takes_the_twin_without_launching():
    fr = prefilled_frame(P, 16, 4, 3, seed=5)
    T = {k: torch.as_tensor(v) for k, v in fr.items()}
    before = ekf_update.measurement_update_2d.launches
    kw = dict(
        sig_dim=3, r_var=(0.01, 0.0009), sig_var=0.25, log_p0=-8.0, init_infl=1.0,
        max_range=6.5, fov_half=2.5, cull=True,
    )
    args = [T[k] for k in STATE_KEYS] + [T["z"], T["sig"], T["valid"]]
    a = ekf_update.measurement_update_2d(*args, **kw)
    b = ekf_update.measurement_update_2d_reference(*args, **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert ekf_update.measurement_update_2d.launches == before
    # the twin leaves its inputs unchanged
    np.testing.assert_array_equal(T["lm_mean"].numpy(), fr["lm_mean"])
