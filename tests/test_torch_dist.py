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


def _lanes_inputs(rng, P=16, L=8):
    """States for `best_particle_lanes`: maps with -0.0 lanes, and weights
    whose top value ties within rank 0, within rank 1 and across ranks."""
    mean = rng.normal(size=(P, L, 2)).astype(np.float32)
    mean[:, ::3] = -0.0
    inp = {"lanes_lm_mean": mean, "lanes_lm_valid": rng.random((P, L)) > 0.5,
           "lanes_lm_desc": rng.integers(-2**31, 2**31, (P, L, 3)).astype(np.int32),
           "lanes_lm_count": rng.integers(0, 9, (P, L)).astype(np.int32)}
    for case, top in (("tie_rank0", (5, 2)), ("tie_rank1", (14, 12)), ("tie_across", (11, 6))):
        lw = rng.normal(size=P).astype(np.float32) - 10.0
        lw[list(top)] = 3.0
        inp[f"lanes_log_w_{case}"] = lw
    return inp


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
        **_lanes_inputs(rng),
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
    """The ring gather in the reference's form (fixed shapes, each output
    row taken at the ring step whose block holds its source): an array
    payload and a ParticleState payload, whose leaves travel through the
    source-window gather's twin, equal the global take and JAX's
    `ring_gather_rows` under `shard_map` on the same indices."""
    out, inp, _ = run
    parts = _both(out, "ring_gather")
    got = np.concatenate([g["array"] for g in parts])
    want = inp["array_payload"][inp["array_idx"]]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_ring_gather(jnp.asarray(inp["array_payload"]),
                                                        inp["array_idx"]))
    # (the zero-width lm_sig leaf is held to the global take below)
    leaves = [f for f in STATE_FIELDS if f != "log_w" and inp[f"state_{f}"].size]
    ref = _jax_ring_gather({f: jnp.asarray(inp[f"state_{f}"]) for f in leaves}, inp["state_idx"])
    for f in leaves:
        got = np.concatenate([g[f"state_{f}"] for g in parts])
        np.testing.assert_array_equal(got.view(ref[f].dtype) if f == "lm_desc" else got, ref[f],
                                      err_msg=f)


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


@pytest.mark.parametrize("case", ["corridor", "equirect_fs1", "pinhole_fs2"])
def test_sharded_step_captured_equals_eager_and_one_device(run, case):
    """2 ranks: the sharded step through `CapturedStep(graph=False)` (the
    captured path's buffer rules), frame by frame, against the eager
    sharded step and `FastSLAM.step` on the same draws: the global state
    after every frame (its digest), every estimate, ESS, resample decision
    and match fraction bit-equal; `run_sequence` over the sharded filter
    with capture=True ends in the same state and estimates. The corridor
    has frames without a resample, where the ring gather runs at the
    identity indices and must leave the state as it was."""
    out, _, _ = run
    d = W.load(out, case)
    np.testing.assert_array_equal(d["digests_c"], d["digests"])
    np.testing.assert_array_equal(d["digests"], d["digests1"])
    for k in ("est", "ess", "resampled", "match_frac"):
        np.testing.assert_array_equal(d[f"{k}_c"], d[k], err_msg=k)
    np.testing.assert_array_equal(d["est_seq"], d["est"])
    np.testing.assert_array_equal(d["resampled_seq"], d["resampled"])
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(d[f"c_{f}"], d[f"o_{f}"], err_msg=f)
        np.testing.assert_array_equal(d[f"q_{f}"], d[f"o_{f}"], err_msg=f)
    np.testing.assert_array_equal(W.load(out, case, 1)["digests_c"], d["digests"])
    if case == "corridor":
        assert (~d["resampled"]).sum() >= 2 and d["resampled"].sum() >= 2


def test_sharded_step_reads_nothing_on_the_host(run):
    """An eager sharded step with a resample and one without (the ring
    gather and its transfers run in both), the estimate and
    `best_particle_lanes`, on 2 ranks with `Tensor.__bool__`, `item`,
    `tolist`, `cpu`, `__int__` (and the other host reads of
    tests/test_torch_capture.py's guard) made to raise."""
    out, _, _ = run
    for r in (0, 1):
        rec = json.loads((out / f"guard_r{r}.json").read_text())
        for name in ("frame_1", "frame_2", "estimate", "best_particle_lanes"):
            assert rec[name] == "ok", (r, name, rec[name])
        assert rec["frame_1_resampled"] and not rec["frame_2_resampled"], rec


@pytest.mark.parametrize("case", ["tie_rank0", "tie_rank1", "tie_across"])
def test_best_particle_lanes_on_a_tie_across_ranks(run, case):
    """The best particle's lanes on every rank bit for bit as the
    one-device argmax row (the first of the tied weights), -0.0 lanes
    kept: each rank offers its row and keeps the owner's, no sum."""
    out, inp, _ = run
    b = int(np.argmax(inp[f"lanes_log_w_{case}"]))
    for r in (0, 1):
        d = W.load(out, "lanes", r)
        for k, f in (("mean", "lm_mean"), ("valid", "lm_valid"), ("desc", "lm_desc"),
                     ("count", "lm_count")):
            want = inp[f"lanes_{f}"][b]
            got = d[f"{case}_{k}"]
            assert got.dtype == want.dtype or f == "lm_desc", f
            np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=f)
    assert (np.signbit(inp["lanes_lm_mean"][b]) & (inp["lanes_lm_mean"][b] == 0)).any()


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
    # the eager step's A/B beside the default (on the CPU both are eager)
    assert all(r["steps_per_s_eager"] > 0 for r in rows) and rows[0]["efficiency_eager"] == 1.0
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
