"""Descriptor matching against a database sharded over ranks, streamed round
a ring (port of `parakeet_slam_tpu.dist.ring_match`).

When the keyframe / landmark descriptor database is split over ranks, a
match against the whole of it keeps each rank's queries resident and
passes the database blocks round the ring: at every step each rank runs the
`hamming_top2` kernel of its queries against the block it holds and folds
the result into a running (best index, best, second). S - 1 transfers of
one block: the bytes of an all-gather, with two blocks in memory.

The fold keeps the **global first-index rule** of `csrc/match.cu`'s merge
and of the dense `hamming_top2`: on equal distance the lower global index
wins, so idx equals the dense match's everywhere. The reference keeps the
block it visited first instead (a strict `<`, blocks visited from its own
downwards); the two differ only where best == second, which the ratio test
rejects.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.mesh import PARTICLE_AXIS, Mesh
from parakeet_slam_tpu_torch.kernels import match as match_mod


def _fold(acc, part):
    """Merge top-2 partials of disjoint database rows; the lower global
    index wins a tie of the best distance."""
    if acc is None:
        return part
    bi, b1, b2 = acc
    ti, t1, t2 = part
    take = (t1 < b1) | ((t1 == b1) & (ti < bi))
    return (torch.where(take, ti, bi), torch.minimum(b1, t1),
            torch.minimum(torch.maximum(b1, t1), torch.minimum(b2, t2)))


def ring_hamming_top2(qd, q_valid, db_shard, db_valid_shard, mesh: Mesh,
                      axis: str = PARTICLE_AXIS):
    """Per-query global (best_idx, best, second), int32, over a database
    sharded along `axis`: qd [N, W] this rank's queries (int32 words),
    db_shard [Ml, W] and db_valid_shard [Ml] this rank's block; rank s of
    the axis holds global rows [s * Ml, (s + 1) * Ml). `q_valid` is left to
    the caller's ratio test, as in the reference."""
    del q_valid
    S = mesh.axis_size(axis)
    Ml = db_shard.shape[0]
    if S == 1:
        return match_mod.hamming_top2(qd, db_shard, db_valid_shard)
    me = mesh.axis_index(axis)
    ring = mesh.axis_ranks(axis)
    group = mesh.axis_group(axis)
    buf, layout = mesh_mod.pack_bytes([db_shard.to(torch.int32),
                                       db_valid_shard.to(torch.bool)])
    acc = None
    for s in range(S):
        reqs = None
        if s < S - 1:
            nxt = torch.empty_like(buf)
            reqs = tdist.batch_isend_irecv([
                tdist.P2POp(tdist.isend, buf, ring[(me + 1) % S], group=group),
                tdist.P2POp(tdist.irecv, nxt, ring[(me - 1) % S], group=group),
            ])
        src = (me - s) % S  # whose block is resident after s rotations
        db, dbv = mesh_mod.unpack_bytes(buf, layout)
        ti, t1, t2 = match_mod.hamming_top2(qd, db, dbv)
        acc = _fold(acc, (ti + src * Ml, t1, t2))
        if reqs is not None:
            for r in reqs:
                r.wait()
            buf = nxt
    return acc


def ring_match(qd, q_valid, db_shard, db_valid_shard, mesh: Mesh, axis: str = PARTICLE_AXIS,
               ratio: float = 0.8, max_distance: int = 80):
    """Lowe-ratio-tested ring match: `kernels.match.match`'s contract with
    the database sharded along `axis`. Returns (match_idx or -1, best)."""
    bi, b1, b2 = ring_hamming_top2(qd, q_valid, db_shard, db_valid_shard, mesh, axis)
    good = (q_valid.bool() & (b1 <= max_distance)
            & (b1.to(torch.float32) < ratio * b2.to(torch.float32)))
    return torch.where(good, bi, torch.full_like(bi, -1)), b1
