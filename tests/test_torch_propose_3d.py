"""The FastSLAM 2.0 proposal's wrapper `kernels/propose_3d.propose_3d` on the
CPU: its route there is the plain twin, which must be the refinement loop
FastSLAM 2.0 ran before the kernel existed, bit for bit, at config 2's and
kitti00's shapes and on the crafted edge frame; and it refuses inputs the
kernel does not take. The kernel itself is held to the twin on the card
(`python -m parakeet_slam_tpu_torch.eval.propose_check`, `chip_smoke.py`)."""

import dataclasses

import pytest
import torch

from parakeet_slam_tpu_torch.core import linalg
from parakeet_slam_tpu_torch.eval import propose_check
from parakeet_slam_tpu_torch.kernels import propose_3d


def _loop_before_the_kernel(slam, pose, P_cov, log_w, best_all, best_ll_all, lm_mean, lm_cov,
                            lm_count, any_valid, z, valid_all, unmatched_w, weight_min_count):
    """`FastSLAM2._propose`'s refinement loop as it was before the kernel
    (hoisted association), kept here as the twin's witness; the unmatched
    weight and weight_min_count come from the frame."""
    P, dt = pose.shape[0], slam.tangent_dim
    rows = torch.arange(P)
    R = slam._r_matrix(True, pose)
    eye_t = torch.eye(dt, dtype=pose.dtype)
    log_p0 = slam._log_p0_assoc()
    for i in range(z.shape[0]):
        best, best_ll = best_all[:, i].long(), best_ll_all[:, i]
        valid = valid_all[i]
        matched = valid & any_valid & (best_ll >= log_p0)
        mu, cv = lm_mean[rows, best], lm_cov[rows, best]
        if weight_min_count > 0:
            matched = matched & (lm_count[rows, best] >= weight_min_count)
        zhat = slam.model.h(pose, mu)
        Hm = slam.model.jac(pose, mu)
        Hx = slam._pose_jacobian(pose, mu)
        nu = slam.model.residual(z[i], zhat)
        Q = Hm @ cv @ Hm.transpose(-1, -2) + R
        S = Hx @ P_cov @ Hx.transpose(-1, -2) + Q
        Sinv, _ = linalg.inv_psd(S)
        K = P_cov @ Hx.transpose(-1, -2) @ Sinv
        delta = (K @ nu[..., None])[..., 0]
        IKH = eye_t - K @ Hx
        P_new = IKH @ P_cov @ IKH.transpose(-1, -2) + K @ Q @ K.transpose(-1, -2)
        P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
        ll_s = linalg.gaussian_loglik(S, nu)
        ok = (
            torch.isfinite(delta).all(dim=-1)
            & torch.isfinite(P_new).all(dim=-1).all(dim=-1)
            & torch.isfinite(ll_s)
            & (torch.linalg.vector_norm(delta, dim=-1) < 1.0)
        )
        matched = matched & ok
        pose = torch.where(matched[:, None], slam.retract(pose, delta), pose)
        P_cov = torch.where(matched[:, None, None], P_new, P_cov)
        log_w = log_w + torch.where(
            matched, ll_s,
            torch.where(valid, torch.full_like(ll_s, unmatched_w), torch.zeros_like(ll_s)),
        )
    return pose, P_cov, log_w


def _frame(case):
    if case == "edges":
        return propose_check.edge_frame("cpu")
    shape, P, L, Z = {"config2": ("config2", 512, 1024, 64),
                      "kitti00": ("kitti00", 2048, 512, 128)}[case]
    return propose_check.random_frame(shape, P, L, Z, seed=11)


@pytest.mark.parametrize("case", ["config2", "kitti00", "edges"])
def test_wrapper_on_the_cpu_is_the_loop_bit_for_bit(case):
    slam, args, kw = _frame(case)
    got = propose_3d.propose_3d(*args, **kw)
    ref = _loop_before_the_kernel(slam, *args, kw["unmatched_w"], kw["weight_min_count"])
    for name, a, b in zip(("pose", "P_cov", "log_w"), got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    # the frame exercises the update: matched steps moved poses and weights
    m = propose_check._matched_steps(args, kw)
    assert int(m.sum()) > 0
    assert not torch.equal(got[0], args[0]) and not torch.equal(got[2], args[2])


def _refusal_cases():
    def f(**change):
        return change

    return {
        "pose_float64": f(pose=lambda a: a.double()),
        "P_cov_shape": f(P_cov=lambda a: a[:, :3, :3]),
        "best_float": f(best=lambda a: a.float()),
        "z_width": f(z=lambda a: a[:, :2]),
        "valid_int": f(valid=lambda a: a.int()),
        "lm_count_int64": f(lm_count=lambda a: a.long()),
        "model_equirect": f(model="equirect_3d"),
        "r_var_length": f(r_var=lambda v: v[:2]),
    }


NAMES = ("pose", "P_cov", "log_w", "best", "best_ll", "lm_mean", "lm_cov", "lm_count",
         "any_valid", "z", "valid")


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_wrapper_refuses_unsupported_inputs(case):
    slam, args, kw = propose_check.random_frame("kitti00", 8, 16, 4, seed=2)
    change = _refusal_cases()[case]
    args = list(args)
    for k, fn in change.items():
        if k in NAMES:
            args[NAMES.index(k)] = fn(args[NAMES.index(k)])
        elif k == "model":
            kw["measurement"] = dataclasses.replace(kw["measurement"], name=fn)
        else:
            kw[k] = fn(kw[k])
    with pytest.raises(ValueError, match="propose_3d"):
        propose_3d.propose_3d(*args, **kw)
