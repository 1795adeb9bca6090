"""The port's descriptor matcher against the JAX package: the plain twins
`hamming_top2_reference` / `l2_top2_reference` against the XLA twins and
the Pallas kernels (interpret mode), the sentinels and tie rules, the
Lowe-ratio front doors, and the batched keyframe-store match of the
system.

Tolerances: Hamming results (index, best, second) are integers and must be
equal, ties included. L2 best and second within rtol=1e-5 + atol=1e-4 of
JAX (fp32 norms and dot products summed in another order); the index equal
wherever JAX's second - best gap exceeds 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.kernels import match as jm
from parakeet_slam_tpu.system import _batched_kf_match as j_batched_kf_match
from parakeet_slam_tpu_torch.kernels import match as tm
from parakeet_slam_tpu_torch.system import _batched_kf_match


def _desc(rng, n, w=8):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint32)


def _t(a):
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _equal(got, ref):
    for name, g, r in zip(("idx", "best", "second"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("n,m", [(5, 7), (128, 128), (200, 300), (272, 4224)])
def test_hamming_twin_matches_xla_and_pallas(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    qd, db = _desc(rng, n), _desc(rng, m)
    valid = np.arange(m) % 5 != 3
    # plant exact duplicates so that ties occur
    db[7 % m] = db[3 % m]
    qd[0] = db[3 % m]
    got = tm.hamming_top2_reference(_t(qd), _t(db), torch.as_tensor(valid))
    _equal(got, jm.hamming_top2_xla(jnp.asarray(qd), jnp.asarray(db), jnp.asarray(valid)))
    _equal(got, jm.hamming_top2(jnp.asarray(qd), jnp.asarray(db), jnp.asarray(valid),
                                interpret=True))
    # the wrapper takes the twin on CPU tensors
    _equal(tm.hamming_top2(_t(qd), _t(db), torch.as_tensor(valid)),
           [g.numpy() for g in got])


def test_hamming_twin_chunks_like_one_pass(monkeypatch):
    """The twin bounds its memory by chunking over the database; a chunk of
    a few rows must give the same answer, ties across chunks included."""
    rng = np.random.default_rng(0)
    qd, db = _desc(rng, 40), _desc(rng, 97)
    db[50:60] = db[5]
    qd[:3] = db[5]
    valid = np.arange(97) % 4 != 1
    whole = tm.hamming_top2_reference(_t(qd), _t(db), torch.as_tensor(valid))
    monkeypatch.setattr(tm, "_TWIN_BYTES", 40 * 8 * 4 * 3)  # 3 rows per chunk
    _equal(tm.hamming_top2_reference(_t(qd), _t(db), torch.as_tensor(valid)),
           [w.numpy() for w in whole])


def test_hamming_sentinels_and_ties():
    rng = np.random.default_rng(1)
    qd, db = _desc(rng, 4), _desc(rng, 6)
    big = tm.BIG
    # no valid row: (0, BIG, BIG)
    bi, b1, b2 = tm.hamming_top2_reference(_t(qd), _t(db), torch.zeros(6, dtype=torch.bool))
    assert bi.tolist() == [0] * 4 and b1.tolist() == [big] * 4 and b2.tolist() == [big] * 4
    # one valid row: second is the sentinel
    one = torch.zeros(6, dtype=torch.bool)
    one[4] = True
    bi, b1, b2 = tm.hamming_top2_reference(_t(qd), _t(db), one)
    assert bi.tolist() == [4] * 4 and b2.tolist() == [big] * 4
    # exact duplicates: smallest index, second equals best
    db[2] = db[5] = qd[1]
    bi, b1, b2 = tm.hamming_top2_reference(_t(qd), _t(db), torch.ones(6, dtype=torch.bool))
    assert int(bi[1]) == 2 and int(b1[1]) == 0 and int(b2[1]) == 0
    ref = jm.hamming_top2_xla(jnp.asarray(qd), jnp.asarray(db), jnp.ones(6, bool))
    _equal((bi, b1, b2), ref)


def test_popcount_covers_the_sign_bit():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA], np.uint32)
    got = tm.popcount32(_t(words)).numpy()
    np.testing.assert_array_equal(got, [bin(int(w)).count("1") for w in words])


@pytest.mark.parametrize("n,m,d", [(10, 20, 32), (64, 700, 128), (3, 5, 7)])
def test_l2_twin_matches_jax(n, m, d):
    rng = np.random.default_rng(n + m + d)
    q = rng.normal(size=(n, d)).astype(np.float32)
    db = rng.normal(size=(m, d)).astype(np.float32)
    valid = np.arange(m) % 6 != 2
    bi, b1, b2 = tm.l2_top2_reference(torch.as_tensor(q), torch.as_tensor(db),
                                      torch.as_tensor(valid))
    for ref in (jm.l2_top2_xla(jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid)),
                jm.l2_top2(jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid), interpret=True)):
        r_i, r_1, r_2 = (np.asarray(a) for a in ref)
        np.testing.assert_allclose(b1.numpy(), r_1, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(b2.numpy(), r_2, rtol=1e-5, atol=1e-4)
        clear = (r_2 - r_1) > 1e-3
        np.testing.assert_array_equal(bi.numpy()[clear], r_i[clear])


def test_l2_sentinel_and_clamp():
    q = torch.ones(2, 4)
    bi, b1, b2 = tm.l2_top2_reference(q, torch.ones(3, 4), torch.zeros(3, dtype=torch.bool))
    assert bi.tolist() == [0, 0] and (b1 == tm.BIG_F).all() and (b2 == tm.BIG_F).all()
    # identical vectors: the matmul form may go slightly negative; clamped at 0
    bi, b1, b2 = tm.l2_top2_reference(q, torch.ones(3, 4), torch.ones(3, dtype=torch.bool))
    assert bi.tolist() == [0, 0] and (b1 >= 0).all() and (b2 >= 0).all()


def test_match_front_doors_match_jax():
    rng = np.random.default_rng(2)
    db = _desc(rng, 64)
    qd = db[[3, 9, 9, 20]].copy()
    qd[3, 0] ^= 0xF  # 4 bits off
    db[40] = db[9]   # a duplicate: ambiguous, the strict Lowe test rejects it
    qv = np.array([True, True, False, True])
    dv = np.ones(64, bool)
    got = tm.match(_t(qd), torch.as_tensor(qv), _t(db), torch.as_tensor(dv))
    ref = jm.match(jnp.asarray(qd), jnp.asarray(qv), jnp.asarray(db), jnp.asarray(dv),
                   use_pallas=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[0].tolist() == [3, -1, -1, 20]

    q = rng.normal(size=(6, 16)).astype(np.float32)
    d = rng.normal(size=(30, 16)).astype(np.float32)
    d[11] = q[2] + 0.01
    qv = np.ones(6, bool)
    got = tm.match_l2(torch.as_tensor(q), torch.as_tensor(qv), torch.as_tensor(d),
                      torch.ones(30, dtype=torch.bool))
    ref = jm.match_l2(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(d), jnp.ones(30, bool),
                      use_pallas=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-4)
    assert int(got[0][2]) == 11


def test_batched_kf_match_matches_jax():
    """Forward (shared queries, batched store) and reverse (batched queries,
    shared database) tables of the keyframe-store match."""
    rng = np.random.default_rng(3)
    K, F = 5, 48
    store = np.stack([_desc(rng, F) for _ in range(K)])
    sv = rng.uniform(size=(K, F)) > 0.2
    sv[4] = False  # an ineligible (masked) keyframe
    qd = store[1].copy()
    qd[::3] = _desc(rng, len(qd[::3]))
    qv = rng.uniform(size=F) > 0.1
    fwd, rev = _batched_kf_match(_t(qd), torch.as_tensor(qv), _t(store), torch.as_tensor(sv),
                                 ratio=0.8)
    j_fwd, j_rev = j_batched_kf_match(jnp.asarray(qd), jnp.asarray(qv), jnp.asarray(store),
                                      jnp.asarray(sv), ratio=0.8, use_pallas=False)
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(j_fwd))
    np.testing.assert_array_equal(rev.numpy(), np.asarray(j_rev))
    assert (fwd[1] >= 0).sum() > F // 3 and (fwd[4] < 0).all()
    # the batched call equals one unbatched match per keyframe
    for k in range(K):
        one = tm.match(_t(qd), torch.as_tensor(qv), _t(store[k]), torch.as_tensor(sv[k]))[0]
        assert torch.equal(one, fwd[k])
        back = tm.match(_t(store[k]), torch.as_tensor(sv[k]), _t(qd), torch.as_tensor(qv))[0]
        assert torch.equal(back, rev[k])


def test_wrappers_refuse_mismatched_shapes():
    with pytest.raises(ValueError):
        tm.hamming_top2_reference(torch.zeros(3, 8, dtype=torch.int32),
                                  torch.zeros(4, 7, dtype=torch.int32), torch.ones(4, dtype=bool))
    with pytest.raises(ValueError):
        tm.hamming_top2_reference(torch.zeros(2, 3, 8, dtype=torch.int32),
                                  torch.zeros(4, 5, 8, dtype=torch.int32),
                                  torch.ones(5, dtype=bool))
