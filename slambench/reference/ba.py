"""The bundle-adjustment reference: the frozen copy's eager solve
(`frozen/backend/ba.py`, the LM iteration as a Python loop with the
plain twin of `apply_cinv`) of the same problem, from the same arrays, in
float32 with TF32 off; with `tf32=True` the control, the same solve in
TF32. `reorder` gives the same problem with its observations in another
order: solved in float32 it adds the per-camera sums in another order at
the same precision, the reading that a reordered summation (sorted segment
sums in place of the dense selector products) may give."""

from __future__ import annotations

import torch

from slambench.reference import frozen
from slambench.reference.frozen.backend import ba, graph
from slambench.reference.frozen.frontend.camera import Pinhole


def solve(camera, raw: dict, kw: dict, device, tf32: bool = False):
    """(poses [C, 7], points [N, 3], costs [iters]) on the host."""
    frozen.set_tf32(tf32)
    try:
        prob = graph.make_ba_problem(**raw, device=device)
        res = ba.optimize_ba(Pinhole(*camera), prob, capture=False, **kw)
        return res.problem.cam_pose.cpu(), res.problem.points.cpu(), res.costs.cpu()
    finally:
        frozen.set_tf32(False)


def reorder(raw: dict, seed: int) -> dict:
    """`raw` with its observations permuted by a permutation drawn from
    `seed`. The pack sorts by point with a stable sort, so the permutation
    survives inside each point's slots, and each camera's terms land in other
    columns of the flattened selector products."""
    n = raw["obs_cam"].shape[0]
    dev = raw["obs_cam"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(n, generator=g, device=dev)
    return {**raw, **{k: raw[k][perm] for k in ("obs_cam", "obs_pt", "obs_uv")}}


def compare(finals, poses, points, ref) -> dict:
    """The numbers compared: the largest relative gap of a solve's final
    cost to the reference's; of the checked solve, the largest gap of a
    camera's pose (translation in m, quaternion components, sign-aligned),
    and the largest and the median gap of a point's position (m)."""
    r_poses, r_points, r_costs = ref
    c = float(r_costs[-1])
    cost_gap = max(abs(f - c) for f in finals) / abs(c)
    q, rq = poses[:, 3:], r_poses[:, 3:]
    sign = torch.where((q * rq).sum(dim=1, keepdim=True) < 0, -1.0, 1.0)
    pose_gap = max(float((poses[:, :3] - r_poses[:, :3]).abs().max()),
                   float((q * sign - rq).abs().max()))
    d = torch.linalg.vector_norm(points - r_points, dim=1)
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    return {"ba_cost_rel_gap": cost_gap, "ba_pose_gap": pose_gap,
            "ba_point_max_gap_m": float(d.max()), "ba_point_median_gap_m": float(d.median())}


def cost_gaps(costs, ref) -> list:
    """The relative gap of each LM iteration's cost to the reference's, in
    order: how far the two solves have drifted apart by each iteration."""
    r = ref[2]
    return [float(abs(c - q) / abs(q)) for c, q in zip(costs.tolist(), r.tolist())]
