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

On CUDA tensors the ring runs as one CUDA graph with its batched sends and
receives inside (the reference's `jax.jit` of the `shard_map`ped loop,
`parakeet_slam_tpu/eval/config5_demo.py:113-120`): one
`captured.CapturedStep` per (N, Ml, W) and mesh axis, kept with the mesh
(`Mesh.programs`), its first call eager (NCCL sets the ring's connections
up), its second captured, replayed from then on; `ring_match` adds the
ratio test in the same graph. The query and the block are copied into the
step's static inputs before each call, and the outputs out of it in one
copy. `capture=False` runs the loop eagerly; `capture=True` on the CPU runs
the captured path's buffer rules eagerly.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.mesh import PARTICLE_AXIS, Mesh
from parakeet_slam_tpu_torch.filter import captured
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


def _ring_top2(qd, db_shard, db_valid_shard, mesh: Mesh, axis: str):
    """The ring's loop (see `ring_hamming_top2`), eager."""
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


def _ratio_test(top2, q_valid, ratio: float, max_distance: int):
    bi, b1, b2 = top2
    good = (q_valid.bool() & (b1 <= max_distance)
            & (b1.to(torch.float32) < ratio * b2.to(torch.float32)))
    return torch.where(good, bi, torch.full_like(bi, -1)), b1


def _captured(name, fn, x, mesh: Mesh, axis: str, extra=()):
    """fn(x) through the CapturedStep of (name, axis, the inputs' device,
    shapes and dtypes, extra) kept in `mesh.programs`: the inputs copied in,
    the outputs copied out."""
    dev = x["qd"].device
    key = (name, axis, dev, tuple((tuple(t.shape), t.dtype) for t in captured.leaves(x)), extra)
    step = mesh.programs.get(key)
    if step is None:
        step = mesh.programs[key] = captured.CapturedStep(
            lambda state, inputs: (state, fn(inputs)), (), captured.clone(x),
            graph=dev.type == "cuda")
    captured.copy_into(step.inputs, x)
    step()
    return step.take()


def ring_hamming_top2(qd, q_valid, db_shard, db_valid_shard, mesh: Mesh,
                      axis: str = PARTICLE_AXIS, capture=None):
    """Per-query global (best_idx, best, second), int32, over a database
    sharded along `axis`: qd [N, W] this rank's queries (int32 words),
    db_shard [Ml, W] and db_valid_shard [Ml] this rank's block; rank s of
    the axis holds global rows [s * Ml, (s + 1) * Ml). `q_valid` is left to
    the caller's ratio test, as in the reference. `capture`: None for the
    CUDA graph on CUDA tensors and the eager loop on CPU tensors, False for
    the eager loop, True for the captured path (the module docstring)."""
    del q_valid
    if capture is None:
        capture = qd.device.type == "cuda"
    if not capture:
        return _ring_top2(qd, db_shard, db_valid_shard, mesh, axis)
    return _captured("ring_top2", lambda x: _ring_top2(x["qd"], x["db"], x["dbv"], mesh, axis),
                     {"qd": qd, "db": db_shard, "dbv": db_valid_shard}, mesh, axis)


def ring_match(qd, q_valid, db_shard, db_valid_shard, mesh: Mesh, axis: str = PARTICLE_AXIS,
               ratio: float = 0.8, max_distance: int = 80, capture=None):
    """Lowe-ratio-tested ring match: `kernels.match.match`'s contract with
    the database sharded along `axis`. Returns (match_idx or -1, best).
    `capture` as in `ring_hamming_top2`: captured, the ratio test runs in
    the ring's graph."""
    if capture is None:
        capture = qd.device.type == "cuda"
    if not capture:
        return _ratio_test(_ring_top2(qd, db_shard, db_valid_shard, mesh, axis), q_valid, ratio,
                           max_distance)
    return _captured(
        "ring_match",
        lambda x: _ratio_test(_ring_top2(x["qd"], x["db"], x["dbv"], mesh, axis), x["qv"], ratio,
                              max_distance),
        {"qd": qd, "qv": q_valid, "db": db_shard, "dbv": db_valid_shard}, mesh, axis,
        (float(ratio), int(max_distance)))
