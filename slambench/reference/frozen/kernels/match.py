"""Brute-force descriptor matching: per-query top-2 over a masked database,
Hamming on packed binary descriptors and squared L2 on float descriptors
(port of `parakeet_slam_tpu/kernels/match.py`).

`hamming_top2` and `l2_top2` launch the hand-written kernels of
`csrc/match.cu` on CUDA tensors and run their plain twins
`hamming_top2_reference` / `l2_top2_reference` on CPU tensors. `match` and
`match_l2` are the Lowe-ratio front doors.

Descriptors are int32 words carrying the reference's uint32 bits. The
Hamming functions take an optional leading batch axis on either operand:
qd [N, W] or [B, N, W], db [M, W] or [B, M, W], db_valid [M] or [B, M]; a
missing batch axis is shared by every batch entry (the kernel reads it with
a batch stride of 0). That replaces the reference's `jax.vmap` over a
`pallas_call` in the keyframe-store match.

Semantics, as the reference's XLA twins define them: invalid database rows
count as 2^30 (Hamming) or 1e30 (L2); the best index is the smallest among
equal distances and the second-best equals the best on a tie; with one
valid row the second is the sentinel; with none the result is
(0, sentinel, sentinel). On the card a Hamming distance is (256 - dot) / 2
of the descriptors' bits as +-1 int8, on the int8 tensor cores (exact in
int32). L2 is ||a||^2 + ||b||^2 - 2 a.b with float32
accumulation, best and second clamped at >= 0 after the top-2, as the
reference's kernel does. On the card the cross product a.b runs on the
tensor cores as 3xTF32: every float is split into big = tf32(x) and
small = tf32(x - big), and big.big + big.small + small.big is summed in
float32, which keeps the distances within 4e-4 of the float32 twin at
D=128. One TF32 product alone moves them by up to 4e-2 and with them the
argmins.
"""

from __future__ import annotations

import torch

from slambench.reference.frozen.kernels import _build

BIG = 2**30
BIG_F = 1e30
# The twins bound the [.., N, chunk, W] XOR block to this many bytes.
_TWIN_BYTES = 1 << 28
# Split the database into chunks until about this many blocks are in flight:
# one per SM of an H100 for both kernels, whose blocks hold most of an SM's
# shared memory, and never more than the 132 SMs, so that no block waits for
# a second wave.
_HAM_BLOCKS, _L2_BLOCKS = 132, 132
_HAM_QUERIES, _HAM_TILE = 128, 128
# The Hamming kernel keeps a row's index within its chunk in 22 bits of the
# fold key.
_HAM_MAX_CHUNK = 1 << 22
_L2_QUERIES, _L2_TILE = 128, 128


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 word (torch has no popcount). The arithmetic right
    shift's sign bits are masked away at the first step."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def hamming_distance_reference(qd: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[.., N, W] x [.., M, W] int32 words -> [.., N, M] int32 distances."""
    x = torch.bitwise_xor(qd[..., :, None, :], db[..., None, :, :])
    return popcount32(x).sum(dim=-1, dtype=torch.int32)


def _l2_from_norms(qd, db, qn, dn):
    """[N, M] squared L2 distances in the matmul form, unclamped (the top-2
    clamps its results)."""
    return qn[:, None] + dn[None, :] - 2.0 * (qd @ db.T)


def _chunk_top2(dist, valid, big, m0):
    """Top-2 of one database chunk [.., N, m] with invalid rows at `big`:
    (first index of the minimum + m0, minimum, minimum of the rest)."""
    dist = torch.where(valid[..., None, :], dist, torch.full_like(dist, big))
    b1, bi = torch.min(dist, dim=-1)  # the first minimal index
    rest = dist.scatter(-1, bi[..., None], big)
    return bi.to(torch.int32) + m0, b1, torch.min(rest, dim=-1).values


def _merge(acc, part):
    """The reference's cross-tile rule; `acc` holds the earlier rows."""
    if acc is None:
        return part
    bi, b1, b2 = acc
    ti, t1, t2 = part
    return (
        torch.where(t1 < b1, ti, bi),
        torch.minimum(b1, t1),
        torch.minimum(torch.maximum(b1, t1), torch.minimum(b2, t2)),
    )


def _batch_shapes(qd, db, db_valid):
    """(B, N, M, W) of a possibly batched Hamming call (B = 0: unbatched)."""
    N, W = qd.shape[-2:]
    M = db.shape[-2]
    if db.shape[-1] != W or db_valid.shape[-1] != M:
        raise ValueError(f"hamming_top2: qd {tuple(qd.shape)}, db {tuple(db.shape)}, "
                         f"db_valid {tuple(db_valid.shape)} do not agree")
    bs = {t.shape[0] for t, nd in ((qd, 3), (db, 3), (db_valid, 2)) if t.dim() == nd}
    if len(bs) > 1:
        raise ValueError(f"hamming_top2: batch sizes differ: {bs}")
    return (bs.pop() if bs else 0), N, M, W


def hamming_top2_reference(qd, db, db_valid):
    """Per-query (best_idx, best, second), int32, chunked over the database
    so the XOR block stays under ~256 MB."""
    B, N, M, W = _batch_shapes(qd, db, db_valid)
    db_valid = db_valid.bool()
    if B:
        qd = qd.expand(B, N, W) if qd.dim() == 2 else qd
    step = max(1, _TWIN_BYTES // (max(B, 1) * N * W * 4))
    acc = None
    for m0 in range(0, M, step):
        d = hamming_distance_reference(qd, db[..., m0:m0 + step, :])
        acc = _merge(acc, _chunk_top2(d, db_valid[..., m0:m0 + step], BIG, m0))
    return acc


def _l2_finish(d):
    return torch.where(d >= BIG_F / 2, torch.full_like(d, BIG_F), torch.clamp(d, min=0.0))


def l2_top2_reference(qd, db, db_valid):
    """Per-query (best_idx int32, best_d2, second_d2) float32, chunked over
    the database. Uses a float32 matmul (TF32 stays off, as the package
    sets it)."""
    qd, db = qd.float(), db.float()
    qn = torch.sum(qd * qd, dim=-1)
    dn = torch.sum(db * db, dim=-1)
    N, M = qd.shape[0], db.shape[0]
    step = max(1, _TWIN_BYTES // (N * 4))
    acc = None
    for m0 in range(0, M, step):
        sl = slice(m0, m0 + step)
        d = _l2_from_norms(qd, db[sl], qn, dn[sl])
        acc = _merge(acc, _chunk_top2(d, db_valid[sl].bool(), BIG_F, m0))
    bi, b1, b2 = acc
    return bi, _l2_finish(b1), _l2_finish(b2)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _split(M: int, blocks: int, tile: int, target: int,
           max_chunk: int | None = None) -> tuple[int, int]:
    """(S, chunk): S contiguous database chunks of `chunk` rows (a multiple
    of the tile, at most `max_chunk`), S * chunk >= M > (S - 1) * chunk, so
    that `blocks` blocks per chunk make the last count of blocks at or below
    `target`, or one chunk when `blocks` alone exceed it."""
    n_tiles = -(-M // tile)
    s = max(1, min(n_tiles, target // blocks))
    chunk = -(-n_tiles // s) * tile
    if max_chunk is not None:
        chunk = min(chunk, max_chunk)
    return -(-M // chunk), chunk


def _on_card(name, tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    return dev


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned base (the kernel's uint4 loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def hamming_top2(qd, db, db_valid):
    """Per-query (best_idx, best, second) int32 Hamming top-2; see the module
    docstring for the shapes and the contract. W must be 8 on the card."""
    if True:  # frozen reference: the plain twin on every device
        return hamming_top2_reference(qd, db, db_valid)
    dev = _on_card("hamming_top2", (qd, db, db_valid))
    B, N, M, W = _batch_shapes(qd, db, db_valid)
    if W != 8 or qd.dtype != torch.int32 or db.dtype != torch.int32:
        raise ValueError(f"hamming_top2: needs int32 words, W=8; got {qd.dtype}, {db.dtype}, W={W}")
    if N < 1 or M < 1:
        raise ValueError(f"hamming_top2: empty operand N={N}, M={M}")
    qd, db = _aligned(qd), _aligned(db)
    valid = db_valid.to(torch.bool).contiguous()
    nb = max(B, 1)
    S, chunk = _split(M, -(-N // _HAM_QUERIES) * nb, _HAM_TILE, _HAM_BLOCKS, _HAM_MAX_CHUNK)
    i32 = dict(dtype=torch.int32, device=dev)
    out = [torch.empty(nb, N, **i32) for _ in range(3)]
    # the chunks' partial results; one chunk writes the results directly
    part = [torch.empty(nb, S, N, **i32) for _ in range(3)] if S > 1 else out
    err = _build.library().hamming_top2_launch(
        qd.data_ptr(), db.data_ptr(), valid.data_ptr(), *(t.data_ptr() for t in out),
        *(t.data_ptr() for t in part), nb, N, M,
        N * W if qd.dim() == 3 else 0, M * W if db.dim() == 3 else 0,
        M if valid.dim() == 2 else 0, S, chunk, _build.stream_ptr(qd),
    )
    _build.check(err, "hamming_top2")
    hamming_top2.launches += 1
    return tuple(t if B else t[0] for t in out)


hamming_top2.launches = 0


def l2_top2(qd, db, db_valid):
    """Per-query (best_idx int32, best_d2, second_d2 float32) squared-L2
    top-2; qd [N, D], db [M, D] float, db_valid [M]."""
    if True:  # frozen reference: the plain twin on every device
        return l2_top2_reference(qd, db, db_valid)
    dev = _on_card("l2_top2", (qd, db, db_valid))
    N, D = qd.shape
    M = db.shape[0]
    if db.shape != (M, D) or db_valid.shape != (M,) or N < 1 or M < 1:
        raise ValueError(f"l2_top2: qd {tuple(qd.shape)}, db {tuple(db.shape)}, "
                         f"db_valid {tuple(db_valid.shape)}")
    qd, db = qd.float().contiguous(), db.float().contiguous()
    valid = db_valid.to(torch.bool).contiguous()
    S, chunk = _split(M, -(-N // _L2_QUERIES), _L2_TILE, _L2_BLOCKS)
    # rows: the results, then S partial results of each, then scratch for
    # the queries' squared norms; dn is scratch for the database's
    ints = torch.empty(1 + S, N, dtype=torch.int32, device=dev)
    floats = torch.empty(2 * (1 + S) + 1, N, dtype=torch.float32, device=dev)
    dn = torch.empty(M, dtype=torch.float32, device=dev)
    idx, b1, b2 = ints[0], floats[0], floats[1]
    err = _build.library().l2_top2_launch(
        qd.data_ptr(), db.data_ptr(), floats[-1].data_ptr(), dn.data_ptr(), valid.data_ptr(),
        idx.data_ptr(), b1.data_ptr(), b2.data_ptr(), ints[1].data_ptr(),
        floats[2].data_ptr(), floats[2 + S].data_ptr(), N, M, D, S, chunk, _build.stream_ptr(qd),
    )
    _build.check(err, "l2_top2")
    l2_top2.launches += 1
    return idx, b1, b2


l2_top2.launches = 0


# ---------------------------------------------------------------------------
# Matching front doors
# ---------------------------------------------------------------------------


def match(qd, q_valid, db, db_valid, ratio: float = 0.8, max_distance: int = 80):
    """Lowe-ratio-tested nearest-neighbour matches: (match_idx int32, index
    into db or -1, distance). The test is strict, so exact-duplicate ties
    (best == second) are rejected."""
    bi, b1, b2 = hamming_top2(qd, db, db_valid)
    good = q_valid.bool() & (b1 <= max_distance) & (b1.float() < ratio * b2.float())
    return torch.where(good, bi, torch.full_like(bi, -1)), b1


def match_l2(qd, q_valid, db, db_valid, ratio: float = 0.8, max_distance: float = 1e6):
    """Lowe-ratio-tested matches for float descriptors; the ratio test runs
    on squared distances with the ratio squared. Returns (match_idx, d2)."""
    bi, b1, b2 = l2_top2(qd, db, db_valid)
    good = q_valid.bool() & (b1 <= max_distance) & (b1 < (ratio * ratio) * b2)
    return torch.where(good, bi, torch.full_like(bi, -1)), b1
