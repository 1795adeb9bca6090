"""Parity of the port's core modules (config, corridor sim, state, geometry,
linalg, metrics) with the JAX package, on the same numpy inputs."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core import config as jcfg
from parakeet_slam_tpu.core import geometry as jgeo
from parakeet_slam_tpu.core import linalg as jlin
from parakeet_slam_tpu.core import state as jstate
from parakeet_slam_tpu.data import make_corridor as j_make_corridor
from parakeet_slam_tpu.eval import metrics as jmetrics
from parakeet_slam_tpu_torch.core import config as tcfg
from parakeet_slam_tpu_torch.core import geometry as tgeo
from parakeet_slam_tpu_torch.core import linalg as tlin
from parakeet_slam_tpu_torch.core import state as tstate
from parakeet_slam_tpu_torch.data import make_corridor as t_make_corridor
from parakeet_slam_tpu_torch.eval import metrics as tmetrics

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path):
    assert len(CONFIGS) == 5
    overrides = {"filter.num_particles": 32, "data.num_steps": 11}
    for ov in (None, overrides):
        assert dataclasses.asdict(tcfg.load_config(path, ov)) == dataclasses.asdict(
            jcfg.load_config(path, ov)
        )


@pytest.mark.parametrize("kw", [{}, dict(num_landmarks=30, num_steps=40, max_obs=8, seed=3)])
def test_make_corridor_matches_jax(kw):
    a, b = t_make_corridor(**kw), j_make_corridor(**kw)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


def test_wrap_and_compose():
    rng = np.random.default_rng(0)
    th = rng.uniform(-12, 12, 257).astype(np.float32)
    np.testing.assert_allclose(tgeo.wrap_angle(_t(th)).numpy(), jgeo.wrap_angle(th), **TOL)
    a = (rng.normal(size=(64, 3)) * [3, 3, 2]).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.se2_compose(_t(a), _t(b)).numpy(), jgeo.se2_compose(a, b), **TOL
    )


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_and_metrics(with_scale):
    rng = np.random.default_rng(1)
    gt = (rng.normal(size=(80, 3)) * [5, 5, 1]).astype(np.float32)
    est = gt + rng.normal(scale=0.1, size=gt.shape).astype(np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    est[:, :2] = est[:, :2] @ np.array([[c, -s], [s, c]], np.float32) + [1.0, -2.0]
    for tv, jv in zip(
        tgeo.umeyama(_t(est[:, :2]), _t(gt[:, :2]), with_scale),
        jgeo.umeyama(est[:, :2], gt[:, :2], with_scale),
    ):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(tmetrics.ate_rmse(est[:, :2], gt[:, :2], with_scale)),
        float(jmetrics.ate_rmse(est[:, :2], gt[:, :2], with_scale)), **TOL,
    )
    np.testing.assert_allclose(
        float(tmetrics.rpe_rmse(est, gt, delta=3)),
        float(jmetrics.rpe_rmse(est, gt, delta=3)), **TOL,
    )


def test_linalg_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(200, 2, 2)).astype(np.float32)
    Q = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(2, dtype=np.float32)
    Q[0] = [[1.0, 2.0], [2.0, 4.0]]     # singular: exercises the det clamp
    Q[1] = [[1.0, 0.0], [0.0, -1.0]]    # indefinite: exercises the maha clamp
    nu = rng.normal(size=(200, 2)).astype(np.float32)
    for tv, jv in zip(tlin.inv2(_t(Q)), jlin.inv2(Q)):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    for tv, jv in zip(tlin.inv_psd(_t(Q[:, :1, :1])), jlin.inv_psd(Q[:, :1, :1])):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    for tv, jv in zip(tlin.mahalanobis_and_logdet(_t(Q), _t(nu)), jlin.mahalanobis_and_logdet(Q, nu)):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tlin.gaussian_loglik(_t(Q), _t(nu)).numpy(), jlin.gaussian_loglik(Q, nu),
        rtol=1e-5, atol=1e-5,
    )


def test_state_layout_and_round_trip():
    P, L, S = 5, 7, 3
    init = np.array([1.0, -2.0, 0.5], np.float32)
    tst = tstate.make_particle_state(P, L, 2, S, 0, 3, init, device="cpu")
    jst = jstate.make_particle_state(P, L, 2, S, 0, 3, jnp.asarray(init))
    ref = {f.name: np.asarray(getattr(jst, f.name)) for f in dataclasses.fields(jst)}
    got = tstate.state_to_numpy(tst)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k])

    rng = np.random.default_rng(3)
    filled = jst.replace(
        pose=jnp.asarray(rng.normal(size=(P, 3)), jnp.float32),
        log_w=jnp.asarray(rng.normal(size=P), jnp.float32),
        lm_mean=jnp.asarray(rng.normal(size=(P, L, 2)), jnp.float32),
        lm_cov=jnp.asarray(rng.normal(size=(P, L, 2, 2)), jnp.float32),
        lm_sig=jnp.asarray(rng.normal(size=(P, L, S)), jnp.float32),
        lm_desc=jnp.asarray(rng.integers(0, 2**32, size=(P, L, 2), dtype=np.uint32)),
        lm_valid=jnp.asarray(rng.random((P, L)) < 0.5),
        lm_count=jnp.asarray(rng.integers(-1, 9, size=(P, L)), jnp.int32),
    )
    back = filled.replace(**tstate.state_to_numpy(tstate.state_from_numpy(filled, device="cpu")))
    for a, b in zip(jax.tree_util.tree_leaves(filled), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    clone = tstate.state_from_numpy(filled, device="cpu").clone()
    assert clone.lm_desc.dtype == torch.int32 and clone.num_particles == P


def test_make_observation_matches_jax():
    z = np.array([[1.0, 0.5], [2.0, -0.3], [4.0, 3.0]], np.float32)
    sig = np.arange(9, dtype=np.float32).reshape(3, 3)
    for kw in ({}, {"sig": sig, "valid": np.array([True, False, True])}):
        t = tstate.make_observation(z, device="cpu", **kw)
        j = jstate.make_observation(jnp.asarray(z), **{k: jnp.asarray(v) for k, v in kw.items()})
        assert t.capacity == j.capacity == 3
        for f in ("z", "sig", "desc", "valid"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
        assert t.desc.dtype == torch.int32 and t.valid.dtype == torch.bool
