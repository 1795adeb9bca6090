"""The port's distributed layer (`parakeet_slam_tpu_torch.dist`): the mesh,
`ring_gather_rows`, the sharded filter, the scaling harness and `cli run`
at 2 gloo ranks on the CPU (one spawn of `tests/torch_dist_worker.py`
serves the file), held to the JAX package's `ring_gather_rows` under
`shard_map` on a 2-device mesh (tests/test_dist.py's cases) and, bit for
bit, to the port's one-device filter on the same draws."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parakeet_slam_tpu.dist.mesh import PARTICLE_AXIS
from parakeet_slam_tpu.dist.mesh import make_mesh as j_make_mesh
from parakeet_slam_tpu.dist.sharded_filter import ring_gather_rows as j_ring_gather_rows
from parakeet_slam_tpu_torch.core.state import ParticleState
from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.sharded_filter import ring_gather_rows
from parakeet_slam_tpu_torch.kernels import resample_cuda
from tests import torch_dist_worker as W

try:
    from jax import shard_map as shard_map_fn
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as shard_map_fn

STATE_FIELDS = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_desc", "lm_valid", "lm_count")


def _state_inputs(rng, P=16, L=8):
    return {
        "state_pose": rng.normal(size=(P, 7)).astype(np.float32),
        "state_log_w": rng.normal(size=P).astype(np.float32),
        "state_lm_mean": rng.normal(size=(P, L, 3)).astype(np.float32),
        "state_lm_cov": rng.normal(size=(P, L, 3, 3)).astype(np.float32),
        "state_lm_sig": np.zeros((P, L, 0), np.float32),
        "state_lm_desc": rng.integers(-2**31, 2**31, (P, L, 8)).astype(np.int32),
        "state_lm_valid": rng.random((P, L)) > 0.5,
        "state_lm_count": rng.integers(0, 9, (P, L)).astype(np.int32),
        "state_idx": rng.integers(0, P, P),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dist")
    rng = np.random.default_rng(0)
    inp = dict(
        array_payload=np.arange(64 * 16, dtype=np.float32).reshape(64, 16),
        array_idx=np.asarray(jax.random.randint(jax.random.PRNGKey(0), (64,), 0, 64)),
        tree_a=np.arange(32, dtype=np.float32),
        tree_b=np.ones((32, 3, 2), np.float32) * np.arange(32, dtype=np.float32)[:, None, None],
        tree_idx=np.arange(32)[::-1].copy(),
        **_state_inputs(rng),
    )
    np.savez(out / "inputs.npz", **inp)
    stdout = W.spawn("dist", out)
    return out, inp, stdout


def _both(out, case):
    return [W.load(out, case, r) for r in (0, 1)]


def _jax_ring_gather(payload, idx):
    fn = shard_map_fn(lambda pl, ix: j_ring_gather_rows(pl, ix, PARTICLE_AXIS),
                      mesh=j_make_mesh(n_devices=2), in_specs=(P(PARTICLE_AXIS), P(PARTICLE_AXIS)),
                      out_specs=P(PARTICLE_AXIS))
    return jax.tree_util.tree_map(np.asarray, fn(payload, jnp.asarray(idx)))


def test_mesh_layout_groups_and_row_blocks(run):
    out, _, _ = run
    for r in (0, 1):
        rec = json.loads((out / f"mesh_r{r}.json").read_text())
        ici, dcn = rec["ici2"], rec["dcn2"]
        assert ici["shape"] == {"dcn": 1, "ici": 2} and dcn["shape"] == {"dcn": 2, "ici": 1}
        assert ici["index"] == {"dcn": 0, "ici": r} and dcn["index"] == {"dcn": r, "ici": 0}
        assert ici["line"] == {"dcn": [r], "ici": [0, 1]}
        assert dcn["line"] == {"dcn": [0, 1], "ici": [r]}
        # sums of rank + 1 over each axis's group
        assert ici["sum"] == {"dcn": r + 1.0, "ici": 3.0}
        assert dcn["sum"] == {"dcn": 3.0, "ici": r + 1.0}
        assert ici["gather"] == [0, 0, 1, 1] and dcn["gather"] == [r, r]
        assert ici["rows"] == [4 * r, 0] and dcn["rows"] == [0, 4 * r]


def test_ring_gather_matches_global_take_and_jax(run):
    out, inp, _ = run
    got = np.concatenate([g["array"] for g in _both(out, "ring_gather")])
    want = inp["array_payload"][inp["array_idx"]]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_ring_gather(jnp.asarray(inp["array_payload"]),
                                                        inp["array_idx"]))


def test_ring_gather_pytree_payload(run):
    out, inp, _ = run
    parts = _both(out, "ring_gather")
    ref = _jax_ring_gather({"a": jnp.asarray(inp["tree_a"]), "b": jnp.asarray(inp["tree_b"])},
                           inp["tree_idx"])
    for k in ("a", "b"):
        got = np.concatenate([g[f"tree_{k}"] for g in parts])
        np.testing.assert_array_equal(got, ref[k])
        np.testing.assert_array_equal(got, inp[f"tree_{k}"][inp["tree_idx"]])


def test_ring_gather_of_a_state_through_the_gather(run):
    """A ParticleState payload: every leaf gathered (through gather_state's
    twin), log_w reset to 0, as the resample leaves it."""
    out, inp, _ = run
    parts = _both(out, "ring_gather")
    idx = inp["state_idx"]
    for f in STATE_FIELDS:
        got = np.concatenate([g[f"state_{f}"] for g in parts])
        want = np.zeros(16, np.float32) if f == "log_w" else inp[f"state_{f}"][idx]
        if f == "lm_desc":
            want = want.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("case", ["corridor", "equirect_fs1", "pinhole_fs2"])
def test_sharded_step_equals_one_device(run, case):
    """2 ranks against one device on the same draws: every state leaf, every
    estimate, the ESS and the resample decisions bit-equal; at least one
    resample went round the ring."""
    out, _, _ = run
    d = W.load(out, case)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(d[f"s_{f}"], d[f"o_{f}"], err_msg=f)
    np.testing.assert_array_equal(d["est"], d["est1"])
    np.testing.assert_array_equal(d["ess"], d["ess1"])
    np.testing.assert_array_equal(d["resampled"], d["resampled1"])
    assert d["resampled"].sum() >= 1
    np.testing.assert_allclose(d["match_frac"], d["match_frac1"], rtol=1e-6)
    assert d["o_lm_valid"].sum() > 0


def test_resampling_preserves_global_semantics(run):
    """tests/test_dist.py's case: degenerate weights on particle 5 (rank 0's
    rows); after the sharded resample every particle on both ranks carries
    its map, with log_w 0."""
    out, _, _ = run
    for d in _both(out, "resample_semantics"):
        assert bool(d["resampled"])
        np.testing.assert_array_equal(d["marker"], np.full(16, 5.0, np.float32))
        np.testing.assert_array_equal(d["log_w"], np.zeros(16, np.float32))


def test_cli_run_under_a_process_group(run):
    """`cli run` on 2 ranks from COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID: rank 0 prints the one-device run's line (the sharded filter
    on the same draws), rank 1 prints nothing."""
    out, _, _ = run
    r0 = json.loads((out / "cli_r0.json").read_text())
    r1 = json.loads((out / "cli_r1.json").read_text())
    assert r0["sharded"].startswith("frames=5 keyframes="), r0
    assert r0["sharded"] == r0["one_device"]
    assert r1["sharded"] == ""


def test_scaling_harness_rows(run):
    """`eval/scaling.measure_scaling` over the meshes of 1 and 2 ranks:
    rank 0 prints and returns one row each."""
    out, _, stdout = run
    rows = json.loads((out / "scaling_r0.json").read_text())
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["steps_per_s"] > 0 for r in rows) and rows[0]["efficiency"] == 1.0
    assert rows[0]["ring_shift_ms"] == 0.0 and rows[1]["ring_shift_ms"] > 0.0
    assert all(r["all_reduce_ms"] > 0.0 and len(r["warmup_frame_ms"]) == 3 for r in rows)
    assert json.loads((out / "scaling_r1.json").read_text()) == []
    assert [json.loads(line) for line in stdout[0].splitlines()] == rows


# -- one process: the 1 x 1 mesh ---------------------------------------------


def test_one_rank_mesh_is_the_identity():
    mesh = mesh_mod.make_mesh()
    assert mesh.shape == {"dcn": 1, "ici": 1} and mesh.size == 1 and mesh.is_member
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh_mod.all_gather_rows(t, mesh) is t
    assert mesh_mod.all_reduce_sum(t, mesh, mesh_mod.BOTH_AXES) is t
    assert mesh_mod.particle_sharding(mesh).rows(8) == slice(0, 8)
    with pytest.raises(ValueError, match="not divisible by map_axis=2"):
        mesh_mod.make_mesh(map_axis=2)


def test_one_rank_ring_gather_is_the_one_device_gather():
    rng = np.random.default_rng(1)
    inp = _state_inputs(rng)
    st = ParticleState(**{f: torch.as_tensor(inp[f"state_{f}"]) for f in STATE_FIELDS})
    idx = torch.as_tensor(inp["state_idx"])
    before = resample_cuda.gather_state.launches
    got = ring_gather_rows(st, idx, mesh_mod.make_mesh())
    want = resample_cuda.gather_state_reference(st, idx)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert resample_cuda.gather_state.launches == before  # the CPU runs the twin


def test_gather_state_takes_fewer_rows_than_it_holds():
    """The ring gather's local take: N output rows from P source rows."""
    rng = np.random.default_rng(2)
    inp = _state_inputs(rng)
    st = ParticleState(**{f: torch.as_tensor(inp[f"state_{f}"]) for f in STATE_FIELDS})
    idx = torch.tensor([15, 0, 7])
    got = resample_cuda.gather_state(st, idx)
    assert got.log_w.shape == (3,) and not got.log_w.any()
    for f in STATE_FIELDS[2:]:
        assert torch.equal(getattr(got, f), getattr(st, f)[idx]), f


def test_pack_bytes_round_trip():
    ts = [torch.arange(5, dtype=torch.float32), torch.tensor([True, False, True]),
          torch.zeros(4, 0), torch.arange(6, dtype=torch.int32).reshape(2, 3)]
    buf, layout = mesh_mod.pack_bytes(ts)
    assert buf.dtype == torch.uint8 and all(o % 16 == 0 for o, _, _, _ in layout)
    for a, b in zip(ts, mesh_mod.unpack_bytes(buf, layout)):
        assert a.dtype == b.dtype and torch.equal(a, b)
