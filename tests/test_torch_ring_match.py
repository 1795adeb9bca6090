"""The port's ring match (`dist/ring_match.py`) at 2 gloo ranks on the CPU
against the JAX package's `ring_hamming_top2` under `shard_map` on a
2-device mesh and the dense `hamming_top2` (tests/test_ring_match.py's
cases), plus a tie-heavy database: b1 and b2 equal everywhere, idx equal to
the dense match's everywhere (the global first-index rule) and to JAX's
ring off ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parakeet_slam_tpu.dist.mesh import PARTICLE_AXIS
from parakeet_slam_tpu.dist.mesh import make_mesh as j_make_mesh
from parakeet_slam_tpu.dist.ring_match import ring_hamming_top2 as j_ring_hamming_top2
from parakeet_slam_tpu.kernels import match as j_match
from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.ring_match import _fold, ring_hamming_top2, ring_match
from parakeet_slam_tpu_torch.eval.kernel_inputs import descriptors
from parakeet_slam_tpu_torch.kernels import match
from tests import torch_dist_worker as W

try:
    from jax import shard_map as shard_map_fn
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as shard_map_fn


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_ring")
    rng = np.random.default_rng(0)
    inp = {
        "random_qd": descriptors(rng, (32, 8)), "random_db": descriptors(rng, (256, 8)),
        "random_dbv": np.arange(256) % 7 != 3,
        # a pool of 40 rows: most queries tie across both blocks
        "ties_qd": descriptors(rng, (48, 8), 40), "ties_db": descriptors(rng, (256, 8), 40),
        "ties_dbv": rng.random(256) > 0.1,
        "hit_db": descriptors(rng, (128, 8)),
    }
    np.savez(out / "inputs.npz", **inp)
    W.spawn("ring", out)
    return inp, [W.load(out, "ring", r) for r in (0, 1)]


def _jax_ring(qd, db, dbv):
    fn = shard_map_fn(
        lambda q, d, v: j_ring_hamming_top2(q, jnp.ones((q.shape[0],), bool), d, v, PARTICLE_AXIS),
        mesh=j_make_mesh(n_devices=2), in_specs=(P(), P(PARTICLE_AXIS), P(PARTICLE_AXIS)),
        out_specs=P(), check_vma=False)
    u = lambda a: jnp.asarray(a.view(np.uint32))  # noqa: E731
    return [np.asarray(x) for x in fn(u(qd), u(db), jnp.asarray(dbv))]


@pytest.mark.parametrize("case", ["random", "ties"])
def test_ring_top2_matches_jax_and_dense(run, case):
    inp, got = run
    qd, db, dbv = inp[f"{case}_qd"], inp[f"{case}_db"], inp[f"{case}_dbv"]
    jbi, jb1, jb2 = _jax_ring(qd, db, dbv)
    dbi, db1, db2 = (np.asarray(x) for x in j_match.hamming_top2_xla(
        jnp.asarray(qd.view(np.uint32)), jnp.asarray(db.view(np.uint32)), jnp.asarray(dbv)))
    ties = db1 == db2
    for g in got:  # both ranks hold the whole result
        np.testing.assert_array_equal(g[f"{case}_b1"], db1)
        np.testing.assert_array_equal(g[f"{case}_b2"], db2)
        np.testing.assert_array_equal(g[f"{case}_b1"], jb1)
        np.testing.assert_array_equal(g[f"{case}_b2"], jb2)
        # the global first-index rule: the dense match's index everywhere
        np.testing.assert_array_equal(g[f"{case}_bi"], dbi)
        np.testing.assert_array_equal(g[f"{case}_bi"][~ties], jbi[~ties])
    if case == "ties":
        assert ties.sum() >= 10


@pytest.mark.parametrize("case", ["random", "ties"])
def test_captured_ring_equals_eager_and_jax(run, case):
    """The ring under its CapturedStep (the captured path's buffer rules,
    the batched sends and receives inside; called twice, the second time
    over the same step's static buffers) equals the eager ring bit for bit,
    and so the dense match and JAX's ring as above; `ring_match` with its
    ratio test in the same step finds the exact hits."""
    inp, got = run
    qd, db, dbv = inp[f"{case}_qd"], inp[f"{case}_db"], inp[f"{case}_dbv"]
    _, jb1, jb2 = _jax_ring(qd, db, dbv)
    for g in got:
        for k in (0, 1):
            for n in ("bi", "b1", "b2"):
                np.testing.assert_array_equal(g[f"cap{k}_{case}_{n}"], g[f"{case}_{n}"])
            np.testing.assert_array_equal(g[f"cap{k}_{case}_b1"], jb1)
            np.testing.assert_array_equal(g[f"cap{k}_{case}_b2"], jb2)
            np.testing.assert_array_equal(g[f"cap{k}_hit_idx"], [77, 78])
            np.testing.assert_array_equal(g[f"cap{k}_hit_dist"], [0, 0])
        # one step for each query shape's top-2 (32 and 48 queries), one for the match
        assert int(g["programs"]) == 3


def test_ring_match_exact_hit(run):
    """tests/test_ring_match.py::test_ring_match_exact_hit: copies of global
    rows 77 and 78 (rank 1's block) match them at distance 0."""
    _, got = run
    for g in got:
        np.testing.assert_array_equal(g["hit_idx"], [77, 78])
        np.testing.assert_array_equal(g["hit_dist"], [0, 0])


def test_fold_keeps_the_lower_global_index():
    acc = (torch.tensor([300, 5, 7]), torch.tensor([4, 4, 9]), torch.tensor([6, 8, 9]))
    part = (torch.tensor([10, 200, 100]), torch.tensor([4, 4, 3]), torch.tensor([4, 5, 12]))
    bi, b1, b2 = _fold(acc, part)
    assert bi.tolist() == [10, 5, 100]
    assert b1.tolist() == [4, 4, 3] and b2.tolist() == [4, 4, 9]


def test_one_rank_ring_match_is_the_dense_match():
    rng = np.random.default_rng(3)
    qd = torch.as_tensor(descriptors(rng, (16, 8), 30))
    db = torch.as_tensor(descriptors(rng, (64, 8), 30))
    dbv = torch.as_tensor(rng.random(64) > 0.2)
    qv = torch.ones(16, dtype=torch.bool)
    mesh = mesh_mod.make_mesh()
    for a, b in zip(ring_hamming_top2(qd, qv, db, dbv, mesh), match.hamming_top2(qd, db, dbv)):
        assert torch.equal(a, b)
    for a, b in zip(ring_match(qd, qv, db, dbv, mesh), match.match(qd, qv, db, dbv)):
        assert torch.equal(a, b)
