"""What surrounds the tensor-core `l2_top2` kernel and the chunked gather
kernel of the port, on the CPU: the kernels themselves run only on the card.

- The 3xTF32 arithmetic of `csrc/match.cu`, emulated in torch on the bit
  patterns, through the top-2: against the port's float32 twin and the JAX
  package's `l2_top2` (XLA twin and Pallas kernel in interpret mode). Best
  and second within atol=1e-3 + rtol=1e-5 (the tolerance the kernel is held
  to on the card), the index equal wherever the reference's second - best
  gap exceeds 1e-2. One TF32 product instead of three breaks that tolerance.
- The index-aware merge of partial top-2 results over interleaved column
  sets, as the kernel's lanes merge their accumulator fragments.
- `plan_gather`, the gather kernel's work lists, and `_split`, the matchers'
  split of the database over the grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.kernels import match as jm
from parakeet_slam_tpu_torch.kernels import match as tm
from parakeet_slam_tpu_torch.kernels import resample_cuda

ATOL, RTOL, GAP = 1e-3, 1e-5, 1e-2


# ---------------------------------------------------------------------------
# 3xTF32
# ---------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to 10 mantissa bits, ties away from zero, on the bit
    pattern: what the kernel's `tf32_round` and `cvt.rna.tf32.f32` give."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32_round(x)
    return big, tf32_round(x - big)


def l2_top2_tensor_core_model(qd, db, valid, terms=3):
    """The kernel's arithmetic: the planes of -2 q and of the database, the
    big.big sum and the cross terms accumulated apart in float32, then
    (qn + dn) + cross, invalid rows at 1e30, the one-pass top-2 and the
    clamp. `terms=1` keeps the big.big product alone: plain TF32."""
    qb, qs = split(-2.0 * qd)
    dbb, dbs = split(db)
    cross = qb @ dbb.T
    if terms == 3:
        cross = cross + (qs @ dbb.T + qb @ dbs.T)
    qn, dn = torch.sum(qd * qd, dim=-1), torch.sum(db * db, dim=-1)
    dist = (qn[:, None] + dn[None, :]) + cross
    bi, b1, b2 = tm._chunk_top2(dist, valid, tm.BIG_F, 0)
    return bi, tm._l2_finish(b1), tm._l2_finish(b2)


def _l2_inputs(n, m, d):
    """Random descriptors; a quarter of the queries are noisy copies of
    valid database rows, 1 row in 6 is invalid."""
    rng = np.random.default_rng(n + m + d)
    q = rng.normal(size=(n, d)).astype(np.float32)
    db = rng.normal(size=(m, d)).astype(np.float32)
    valid = np.arange(m) % 6 != 2
    k = min(n // 4, int(valid.sum()))
    if k:
        rows = rng.choice(np.flatnonzero(valid), k, replace=False)
        q[:k] = db[rows] + 0.05 * q[:k]
    return q, db, valid


def _assert_close(got, ref, what):
    gi, g1, g2 = (np.asarray(a) for a in got)
    ri, r1, r2 = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(g1, r1, rtol=RTOL, atol=ATOL, err_msg=f"{what}: best")
    np.testing.assert_allclose(g2, r2, rtol=RTOL, atol=ATOL, err_msg=f"{what}: second")
    clear = (r2 - r1) > GAP
    np.testing.assert_array_equal(gi[clear], ri[clear], err_msg=f"{what}: idx")


@pytest.mark.parametrize("n,m,d", [(64, 4096, 128), (10, 20, 32), (3, 5, 7)])
def test_3xtf32_top2_matches_twin_and_jax(n, m, d):
    q, db, valid = _l2_inputs(n, m, d)
    got = l2_top2_tensor_core_model(torch.as_tensor(q), torch.as_tensor(db),
                                    torch.as_tensor(valid))
    _assert_close(got, tm.l2_top2_reference(torch.as_tensor(q), torch.as_tensor(db),
                                            torch.as_tensor(valid)), "float32 twin")
    jq, jdb, jv = jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid)
    _assert_close(got, jm.l2_top2_xla(jq, jdb, jv), "JAX XLA twin")
    _assert_close(got, jm.l2_top2(jq, jdb, jv, interpret=True), "JAX kernel, interpret mode")


def test_one_tf32_product_breaks_the_tolerance():
    """Why the split: with the big.big product alone the distances of the
    planted pairs move by more than ten times the tolerance."""
    q, db, valid = (torch.as_tensor(a) for a in _l2_inputs(64, 4096, 128))
    _, r1, _ = tm.l2_top2_reference(q, db, valid)
    _, one, _ = l2_top2_tensor_core_model(q, db, valid, terms=1)
    _, three, _ = l2_top2_tensor_core_model(q, db, valid, terms=3)
    assert float((one - r1).abs().max()) > 10 * ATOL
    assert float((three - r1).abs().max()) < ATOL


def test_tf32_round_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-11 - 2**-23, -1.0 - 2**-11, 3.14159274, 0.0])
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, -1.0 - 2**-10, 3.140625, 0.0])
    assert torch.equal(tf32_round(x), want)
    big, small = split(x)
    # the split loses at most 2^-22 of the value
    assert float(((big + small) - x).abs().max()) <= 2**-21


# ---------------------------------------------------------------------------
# The merge of partial top-2 results by index
# ---------------------------------------------------------------------------


def merge_by_index(a, b):
    """The kernel's `merge_by_index` on tensors: partial (idx, best, second)
    over disjoint column sets, in any order."""
    ai, a1, a2 = a
    bi, b1, b2 = b
    take = (b1 < a1) | ((b1 == a1) & (bi < ai))
    return (torch.where(take, bi, ai), torch.minimum(a1, b1),
            torch.minimum(torch.maximum(a1, b1), torch.minimum(a2, b2)))


def _partial(dist, cols):
    """One thread's fold over its columns `cols` (ascending): global index
    of the first minimum, the minimum, the minimum of the rest."""
    bi, b1, b2 = tm._chunk_top2(dist[:, cols], torch.ones(len(cols), dtype=torch.bool),
                                tm.BIG_F, 0)
    return torch.as_tensor(cols)[bi.long()].to(torch.int32), b1, b2


@pytest.mark.parametrize("interleaving", ["fragment", "stride 3", "random"])
def test_merge_by_index_equals_one_pass(interleaving):
    rng = np.random.default_rng(5)
    n, m = 40, 128
    # distances from a pool of 6 values: ties everywhere, duplicates of the best
    dist = torch.as_tensor(rng.integers(0, 6, (n, m)).astype(np.float32))
    if interleaving == "fragment":  # a wgmma accumulator: columns 8 j + 2 q + {0, 1} to lane q
        owner = (np.arange(m) % 8) // 2
    elif interleaving == "stride 3":
        owner = np.arange(m) % 3
    else:
        owner = rng.integers(0, 5, m)
    parts = [_partial(dist, np.flatnonzero(owner == o)) for o in np.unique(owner)]
    want = tm._chunk_top2(dist, torch.ones(m, dtype=torch.bool), tm.BIG_F, 0)
    for order in (parts, parts[::-1], [parts[i] for i in rng.permutation(len(parts))]):
        acc = order[0]
        for p in order[1:]:
            acc = merge_by_index(acc, p)
        for name, g, w in zip(("idx", "best", "second"), acc, want):
            assert torch.equal(g, w), f"{interleaving}: {name}"
    # a duplicate of the best in another part: second == best, smallest index
    assert bool((want[1] == want[2]).any())


# ---------------------------------------------------------------------------
# The gather's work lists
# ---------------------------------------------------------------------------

WIDTHS = (12, 10240, 81920, 163840, 0, 4, 48)
SHAPED = (False, True, True, True, True, False, False)  # 48: a base address off 16 bytes


def _run_plan(srcs, idx, plan, chunk):
    """The kernel's walk over both lists, in numpy: returns the gathered
    leaves and, per leaf, how often each byte of each row was written."""
    bulk, small, n_bulk_items, n_small_items = plan
    P = len(idx)
    outs = [np.zeros_like(s) for s in srcs]
    hits = [np.zeros(s.shape, np.int32) for s in srcs]

    def leaf_of(leaves, item):
        at = 0
        while at + 1 < len(leaves) and item >= leaves[at + 1][2]:
            at += 1
        return leaves[at]

    for item in range(n_bulk_items):
        k, per, first = leaf_of(bulk, item)
        r, c = divmod(item - first, per)
        lo, hi = c * chunk, min((c + 1) * chunk, srcs[k].shape[1])
        assert lo % 16 == 0 and (hi - lo) % 16 == 0 and hi > lo  # a bulk copy's shape
        outs[k][r, lo:hi] = srcs[k][idx[r], lo:hi]
        hits[k][r, lo:hi] += 1
    for item in range(n_small_items):
        k, per, first = leaf_of(small, item)
        r0 = (item - first) * per
        r1 = min(P, r0 + per)
        assert r1 > r0
        outs[k][r0:r1] = srcs[k][idx[r0:r1]]
        hits[k][r0:r1] += 1
    return outs, hits


@pytest.mark.parametrize("chunk", [16384, 32768])
@pytest.mark.parametrize("P", [7, 64])
def test_plan_gather_covers_every_byte_once(P, chunk):
    rng = np.random.default_rng(P + chunk)
    plan = resample_cuda.plan_gather(WIDTHS, SHAPED, P, chunk)
    bulk, small, n_bulk_items, n_small_items = plan
    # routing: 16-byte shaped leaves in chunks, the others by rows, none of zero width
    assert [k for k, _, _ in bulk] == [1, 2, 3]
    assert [k for k, _, _ in small] == [0, 5, 6]
    assert [per for _, per, _ in bulk] == [-(-WIDTHS[k] // chunk) for k in (1, 2, 3)]
    assert all(per >= 1 and per * WIDTHS[k] <= max(chunk // 16, WIDTHS[k]) for k, per, _ in small)
    assert n_bulk_items == sum(P * per for _, per, _ in bulk)
    assert n_small_items == sum(-(-P // per) for _, per, _ in small)
    srcs = [rng.integers(0, 256, (P, w), dtype=np.uint8) for w in WIDTHS]
    idx = rng.integers(0, P, P)
    outs, hits = _run_plan(srcs, idx, plan, chunk)
    for k, w in enumerate(WIDTHS):
        assert (hits[k] == 1).all(), f"leaf {k} ({w} bytes)"
        np.testing.assert_array_equal(outs[k], srcs[k][idx])


def test_plan_gather_rejects_a_chunk_off_16_bytes():
    with pytest.raises(ValueError):
        resample_cuda.plan_gather((32,), (True,), 4, 1000)
    with pytest.raises(ValueError):
        resample_cuda.plan_gather((32, 16), (True,), 4, 16384)


# ---------------------------------------------------------------------------
# The split of the database over the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 37, 999, 131072, 131073])
def test_split_covers_the_database(M):
    for n in (1, 100, 1024, 5000):
        blocks = -(-n // tm._L2_QUERIES)
        S, chunk = tm._split(M, blocks, tm._L2_TILE, tm._L2_BLOCKS, over=False)
        assert S * chunk >= M > (S - 1) * chunk
        assert chunk % tm._L2_TILE == 0 and S >= 1
        # one block per SM: no second wave unless the queries alone need one
        assert S * blocks <= max(tm._L2_BLOCKS, blocks)
        blocks = -(-n // tm._HAM_QUERIES)
        S, chunk = tm._split(M, blocks, tm._HAM_TILE, tm._HAM_BLOCKS, over=True)
        assert S * chunk >= M > (S - 1) * chunk
        assert chunk % tm._HAM_TILE == 0 and S >= 1
    # the bench shape: 8 query tiles x 16 chunks on 132 SMs
    if M == 131072:
        assert tm._split(M, 8, tm._L2_TILE, tm._L2_BLOCKS, over=False) == (16, 8192)
