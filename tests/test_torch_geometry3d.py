"""Parity of the port's SE(3) geometry, 3x3 linear algebra and SE(3) state
with the JAX package, on the same numpy inputs. Tolerance rtol=atol=1e-5
(float32; the exp/log maps chain a dozen ops, so a few ulps apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core import geometry as jgeo
from parakeet_slam_tpu.core import linalg as jlin
from parakeet_slam_tpu.core import state as jstate
from parakeet_slam_tpu_torch.core import geometry as tgeo
from parakeet_slam_tpu_torch.core import linalg as tlin
from parakeet_slam_tpu_torch.core import state as tstate

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(11)


def _t(a):
    return torch.as_tensor(np.array(a))


def _quats(n, small=False):
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    if small:
        q[:, :3] *= 1e-5
    q[: n // 4, 3] *= -1.0  # both hemispheres
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _poses(n):
    return np.concatenate([RNG.normal(size=(n, 3)) * 3, _quats(n)], 1).astype(np.float32)


def _twists(n):
    xi = RNG.normal(size=(n, 6)).astype(np.float32)
    xi[: n // 4, 3:] *= 1e-7  # the small-angle branches
    xi[n // 4 : n // 2, 3:] *= 0.5
    return xi


@pytest.mark.parametrize("fn", ["quat_multiply", "quat_conjugate", "quat_normalize",
                                "quat_to_matrix", "so3_log_quat"])
def test_quaternion_ops(fn):
    a, b = _quats(64), _quats(64, small=True)
    args = {"quat_multiply": (a, b), "quat_normalize": (a * 3.0,)}.get(fn, (a,))
    want = getattr(jgeo, fn)(*map(jnp.asarray, args))
    got = getattr(tgeo, fn)(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rotation_and_matrix_round_trip():
    q, v = _quats(64), RNG.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeo.quat_rotate(_t(q), _t(v)).numpy(),
                               jgeo.quat_rotate(q, v), **TOL)
    m = np.asarray(jgeo.quat_to_matrix(q))
    np.testing.assert_allclose(tgeo.matrix_to_quat(_t(m)).numpy(), jgeo.matrix_to_quat(m), **TOL)


def test_so3_and_se3_maps():
    xi = _twists(64)
    w = xi[:, 3:]
    for fn, arg in (("so3_exp_quat", w), ("_so3_hat", w), ("_se3_V", w), ("_se3_V_inv", w),
                    ("se3_exp", xi)):
        np.testing.assert_allclose(getattr(tgeo, fn)(_t(arg)).numpy(),
                                   np.asarray(getattr(jgeo, fn)(arg)), err_msg=fn, **TOL)
    p = _poses(64)
    np.testing.assert_allclose(tgeo.se3_log(_t(p)).numpy(), jgeo.se3_log(p), **TOL)


def test_se3_group_ops():
    a, b, pts = _poses(64), _poses(64), RNG.normal(size=(64, 3)).astype(np.float32) * 5
    for fn, args in (("se3_compose", (a, b)), ("se3_inverse", (a,)), ("se3_between", (a, b)),
                     ("se3_apply", (a, pts)), ("se3_apply_inverse", (a, pts))):
        np.testing.assert_allclose(getattr(tgeo, fn)(*map(_t, args)).numpy(),
                                   np.asarray(getattr(jgeo, fn)(*args)), err_msg=fn, **TOL)
    se2 = (RNG.normal(size=(64, 3)) * [5, 5, 3]).astype(np.float32)
    np.testing.assert_allclose(tgeo.se2_to_se3(_t(se2)).numpy(), jgeo.se2_to_se3(se2), **TOL)
    # broadcast one pose against a batch, as the motion models do
    np.testing.assert_allclose(tgeo.se3_compose(_t(a), _t(b[0])).numpy(),
                               jgeo.se3_compose(a, b[0]), **TOL)


def test_linalg_3x3_matches_jax():
    A = RNG.normal(size=(200, 3, 3)).astype(np.float32)
    Q = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    Q[0] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])  # singular: the det clamp
    Q[1] = np.diag([1.0, -1.0, 2.0])                     # indefinite: the maha clamp
    nu = RNG.normal(size=(200, 3)).astype(np.float32)
    np.testing.assert_allclose(tlin.det3(_t(Q)).numpy(), jlin.det3(Q), rtol=1e-5, atol=1e-5)
    for fn in (tlin.inv3, tlin.inv_psd):
        for tv, jv in zip(fn(_t(Q)), getattr(jlin, fn.__name__)(Q)):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlin.gaussian_loglik(_t(Q), _t(nu)).numpy(),
                               jlin.gaussian_loglik(Q, nu), rtol=1e-5, atol=1e-4)


def test_se3_state_defaults_and_round_trip():
    P, L, W = 4, 6, 8
    tst = tstate.make_particle_state(P, L, 3, 0, W, 7, device="cpu")
    jst = jstate.make_particle_state(P, L, 3, 0, W, 7)
    got = tstate.state_to_numpy(tst)
    for f in got:
        ref = np.asarray(getattr(jst, f))
        assert got[f].dtype == ref.dtype and got[f].shape == ref.shape, f
        np.testing.assert_array_equal(got[f], ref)
    np.testing.assert_array_equal(got["pose"][:, 3:], np.tile([0, 0, 0, 1], (P, 1)))
    # a filled JAX vision state (uint32 descriptor words with the top bit
    # set) carries across and back bit for bit
    filled = jst.replace(
        pose=jnp.asarray(_poses(P)), log_w=jnp.asarray(RNG.normal(size=P), jnp.float32),
        lm_mean=jnp.asarray(RNG.normal(size=(P, L, 3)), jnp.float32),
        lm_cov=jnp.asarray(RNG.normal(size=(P, L, 3, 3)), jnp.float32),
        lm_desc=jnp.asarray(RNG.integers(2**31, 2**32, size=(P, L, W), dtype=np.uint32)),
        lm_valid=jnp.asarray(RNG.random((P, L)) < 0.5),
        lm_count=jnp.asarray(RNG.integers(-1, 9, size=(P, L)), jnp.int32),
    )
    t = tstate.state_from_numpy(filled, device="cpu")
    assert t.lm_desc.dtype == torch.int32 and bool((t.lm_desc < 0).all())
    back = filled.replace(**tstate.state_to_numpy(t))
    for a, b in zip(jax.tree_util.tree_leaves(filled), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
