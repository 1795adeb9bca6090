"""The port's all-to-all reshard (`dist/reshard.py`) against the JAX
package's: `bucket_by` in one process (tests/test_reshard.py's case and a
random one with overflow), and `reshard_landmark_to_camera` at 2 gloo ranks
on the CPU against JAX's under `shard_map` on a 2-device mesh. Every output
equal, the overflow counts included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from parakeet_slam_tpu.dist import reshard as j_reshard
from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist import reshard
from tests import torch_dist_worker as W

try:
    from jax import shard_map as shard_map_fn
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as shard_map_fn

S, O_L, CAP, N_CAMS = 2, 16, 12, 16


def _bucket_both(dest, rows, n_buckets, capacity):
    j_out, j_valid, j_ovf = j_reshard.bucket_by(
        jnp.asarray(dest), {k: jnp.asarray(v) for k, v in rows.items()}, n_buckets, capacity)
    t_out, t_valid, t_ovf = reshard.bucket_by(
        torch.as_tensor(dest), {k: torch.as_tensor(v) for k, v in rows.items()}, n_buckets,
        capacity)
    return (j_out, j_valid, j_ovf), (t_out, t_valid, t_ovf)


def test_bucket_by_reference_case():
    dest = np.array([0, 1, 0, 2, 1, 0, 0], np.int32)
    (j_out, j_valid, j_ovf), (t_out, t_valid, t_ovf) = _bucket_both(
        dest, {"x": np.arange(7, dtype=np.float32)}, 3, 3)
    assert int(t_ovf) == int(j_ovf) == 1
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_out["x"].numpy(), np.asarray(j_out["x"]))
    np.testing.assert_array_equal(t_out["x"][1].numpy()[t_valid[1].numpy()], [1.0, 4.0])


@pytest.mark.parametrize("capacity", [4, 9, 40])
def test_bucket_by_random_rows(capacity):
    rng = np.random.default_rng(capacity)
    dest = rng.integers(0, 5, 60).astype(np.int32)
    rows = {"a": rng.normal(size=(60, 3)).astype(np.float32),
            "b": rng.integers(0, 100, 60).astype(np.int32)}
    (j_out, j_valid, j_ovf), (t_out, t_valid, t_ovf) = _bucket_both(dest, rows, 5, capacity)
    assert int(t_ovf) == int(j_ovf) == int(np.maximum(np.bincount(dest, minlength=5) - capacity,
                                                      0).sum())
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    for k in rows:
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_reshard")
    key = jax.random.PRNGKey(0)
    inp = {
        "obs_cam": np.asarray(jax.random.randint(key, (S * O_L,), 0, N_CAMS, jnp.int32)),
        "obs_pt": np.arange(S * O_L, dtype=np.int32),
        "obs_uv": np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (S * O_L, 2))),
        "obs_valid": np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 2), 0.9, (S * O_L,))),
        "cams_per_shard": N_CAMS // S, "capacity": CAP,
    }
    np.savez(out / "inputs.npz", **inp)
    W.spawn("reshard", out)
    return inp, [W.load(out, "reshard", r) for r in (0, 1)]


def test_landmark_to_camera_equals_jax(run):
    inp, got = run
    mesh = Mesh(np.array(jax.devices()[:S]), ("m",))

    def body(cam_l, pt_l, uv_l, valid_l):
        c, p, uv, v, ovf = j_reshard.reshard_landmark_to_camera(
            cam_l, pt_l, uv_l, valid_l, n_shards=S, cams_per_shard=N_CAMS // S,
            capacity=CAP, axis_name="m")
        return c, p, uv, v, ovf[None]

    fn = jax.jit(shard_map_fn(body, mesh=mesh, in_specs=(P("m"),) * 4, out_specs=(P("m"),) * 5,
                              check_vma=False))
    jc, jp, juv, jv, jovf = (np.asarray(x) for x in fn(
        *(jnp.asarray(inp[k]) for k in ("obs_cam", "obs_pt", "obs_uv", "obs_valid"))))
    cat = lambda k: np.concatenate([g[k] for g in got])  # noqa: E731
    np.testing.assert_array_equal(cat("cam"), jc)
    np.testing.assert_array_equal(cat("pt"), jp)
    np.testing.assert_array_equal(cat("uv"), juv)
    np.testing.assert_array_equal(cat("valid"), jv)
    np.testing.assert_array_equal([int(g["overflow"]) for g in got], jovf)


def test_landmark_to_camera_keeps_every_row_once(run):
    """Every valid row lands exactly once, on the rank owning its camera,
    with its payload (tests/test_reshard.py's checks)."""
    inp, got = run
    n = S * CAP
    seen = {}
    for r, g in enumerate(got):
        assert int(g["overflow"]) == 0 and g["cam"].shape == (n,)
        for i in np.flatnonzero(g["valid"]):
            assert g["cam"][i] // (N_CAMS // S) == r
            seen[int(g["pt"][i])] = (int(g["cam"][i]), tuple(g["uv"][i]))
    valid = np.flatnonzero(inp["obs_valid"])
    assert sorted(seen) == sorted(int(inp["obs_pt"][i]) for i in valid)
    for i in valid:
        assert seen[int(inp["obs_pt"][i])] == (int(inp["obs_cam"][i]), tuple(inp["obs_uv"][i]))


def test_one_rank_all_to_all_is_the_identity():
    mesh = mesh_mod.make_mesh()
    b = {"x": torch.arange(6).reshape(1, 6)}
    assert torch.equal(reshard.all_to_all_rows(b, mesh, mesh_mod.MAP_AXIS)["x"], b["x"])
