"""All-to-all resharding between landmark-major and camera-major observation
layouts (port of `parakeet_slam_tpu.dist.reshard`).

The distributed BA keeps its observations landmark-major: rank s owns point
block s and every observation of those points. Some phases want them
camera-major instead (rank s owns camera block s and every observation of
those cameras). Moving between the two is one `all_to_all_single` over a
[S, capacity] bucketed layout: every rank splits its rows by destination,
and the collective transposes rank and bucket.

`bucket_by` buckets with a fixed capacity: each row keeps its stable rank
within its bucket, a row past the capacity is dropped and *counted* in the
overflow (callers size the capacity so that it is 0; it is reported, never
silent). Rows are placed by one scatter in which every slot is written at
most once (`index_copy_`; a dropped row goes to a spare slot of its own).
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from parakeet_slam_tpu_torch.dist.mesh import Mesh


def bucket_by(dest: torch.Tensor, rows: dict, n_buckets: int, capacity: int):
    """Scatter rows into [n_buckets, capacity] by destination.

    dest [N] integer in [0, n_buckets); rows: a dict of [N, ...] tensors.
    Returns (dict of [n_buckets, capacity, ...], valid [n_buckets, capacity]
    bool, overflow: a 0-d int64 count of the rows dropped)."""
    N = dest.shape[0]
    dev = dest.device
    dest = dest.long()
    order = torch.sort(dest, stable=True).indices
    sorted_dest = dest[order]
    start = torch.searchsorted(sorted_dest, torch.arange(n_buckets, device=dev))
    rank_sorted = torch.arange(N, device=dev) - start[sorted_dest]
    rank = torch.empty_like(rank_sorted).index_copy_(0, order, rank_sorted)
    keep = rank < capacity
    overflow = torch.sum(~keep)
    n_slots = n_buckets * capacity
    # a dropped row gets a spare slot of its own past the buckets
    slot = torch.where(keep, dest * capacity + rank, n_slots + torch.arange(N, device=dev))

    def scatter(a):
        out = a.new_zeros((n_slots + N,) + tuple(a.shape[1:]))
        return out.index_copy_(0, slot, a)[:n_slots].reshape((n_buckets, capacity) + a.shape[1:])

    bucketed = {k: scatter(v) for k, v in rows.items()}
    valid = scatter(torch.ones(N, dtype=torch.bool, device=dev))
    return bucketed, valid, overflow


def all_to_all_rows(bucketed: dict, mesh: Mesh, axis) -> dict:
    """Transpose bucket and rank along `axis`: every [S, C, ...] entry
    becomes out[s, c] = (the bucketed entry of rank s)[me, c]."""
    g = mesh.axis_group(axis)
    if g is None:
        return dict(bucketed)
    out = {}
    for k, a in bucketed.items():
        src = a.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bool else src
        got = torch.empty_like(wire)
        tdist.all_to_all_single(got, wire, group=g)
        out[k] = got.view(torch.bool) if src.dtype == torch.bool else got
    return out


def reshard_landmark_to_camera(obs_cam, obs_pt, obs_uv, obs_valid, *, mesh: Mesh, axis,
                               cams_per_shard: int, capacity: int):
    """This rank's landmark-major observation rows in, the camera-major rows
    it owns out (cameras [me * cams_per_shard, (me + 1) * cams_per_shard)
    along `axis`). Returns (obs_cam, obs_pt, obs_uv, valid), each [S * C]
    rows, and the overflow of the bucketing."""
    S = mesh.axis_size(axis)
    dest = torch.clamp(obs_cam.long() // cams_per_shard, 0, S - 1)
    # invalid rows go to bucket 0 and carry valid=False through
    rows = {"cam": obs_cam, "pt": obs_pt, "uv": obs_uv, "v": obs_valid.to(torch.int32)}
    bucketed, slot_valid, overflow = bucket_by(
        torch.where(obs_valid.bool(), dest, torch.zeros_like(dest)), rows, S, capacity)
    bucketed["keep"] = slot_valid & (bucketed.pop("v") > 0)
    out = all_to_all_rows(bucketed, mesh, axis)
    C = capacity
    return (out["cam"].reshape(S * C), out["pt"].reshape(S * C),
            out["uv"].reshape(S * C, -1), out["keep"].reshape(S * C), overflow)
