"""Parity of the port's resampling (indices with JAX's own u0, the gather
twin) with `kernels/resample.py` and `resample_pallas.gather_state` run in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.core import state as jstate
from parakeet_slam_tpu.kernels import resample as jres
from parakeet_slam_tpu.kernels import resample_pallas
from parakeet_slam_tpu_torch.core.state import state_from_numpy, state_to_numpy
from parakeet_slam_tpu_torch.kernels import resample as tres
from parakeet_slam_tpu_torch.kernels import resample_cuda


@pytest.mark.parametrize("P,seed,spread", [(16, 0, 1.0), (64, 1, 4.0), (64, 2, 0.1), (257, 3, 8.0)])
def test_systematic_indices_equal_with_jax_u0(P, seed, spread):
    key = jax.random.PRNGKey(seed)
    log_w = (np.random.default_rng(seed).normal(size=P) * spread).astype(np.float32)
    ref = np.asarray(jres.systematic_resample_indices(key, jnp.asarray(log_w)))
    u0 = float(jax.random.uniform(key, (), minval=0.0, maxval=1.0 / P))
    got = tres.systematic_resample_indices(torch.as_tensor(log_w), u0)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(
        float(tres.effective_sample_size(torch.as_tensor(log_w))),
        float(jres.effective_sample_size(jnp.asarray(log_w))), rtol=1e-5,
    )


def _random_jax_state(P, L, S, seed):
    rng = np.random.default_rng(seed)
    st = jstate.make_particle_state(P, L, 2, S)
    return st.replace(
        pose=jnp.asarray(rng.normal(size=(P, 3)), jnp.float32),
        log_w=jnp.asarray(rng.normal(size=P), jnp.float32),
        lm_mean=jnp.asarray(rng.normal(size=(P, L, 2)), jnp.float32),
        lm_cov=jnp.asarray(rng.normal(size=(P, L, 2, 2)), jnp.float32),
        lm_sig=jnp.asarray(rng.normal(size=(P, L, S)), jnp.float32),
        lm_valid=jnp.asarray(rng.random((P, L)) < 0.5),
        lm_count=jnp.asarray(rng.integers(-1, 9, size=(P, L)), jnp.int32),
    )


@pytest.mark.parametrize("S", [0, 3])
def test_gather_matches_pallas_gather_state(S):
    P, L = 8, 130
    jst = _random_jax_state(P, L, S, seed=S)
    idx = np.array([0, 0, 3, 3, 3, 5, 7, 7], np.int32)
    ref = jres.gather_particles(jst, jnp.asarray(idx), use_pallas=True)  # interpret on CPU
    ref_rows = resample_pallas.gather_state(jst, jnp.asarray(idx), interpret=True)
    tst = state_from_numpy(jst, device="cpu")
    before = resample_cuda.gather_state.launches
    got = state_to_numpy(tres.gather_particles(tst, torch.as_tensor(idx)))  # twin on CPU
    for name, want in ref.__dict__.items():
        np.testing.assert_array_equal(got[name], np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(got["lm_mean"], np.asarray(ref_rows.lm_mean))
    assert not got["log_w"].any()
    assert resample_cuda.gather_state.launches == before
    # the input state is left as it was
    np.testing.assert_array_equal(tst.lm_mean.numpy(), np.asarray(jst.lm_mean))
