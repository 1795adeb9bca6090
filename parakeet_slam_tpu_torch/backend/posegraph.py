"""Pose-graph optimization: Levenberg-Marquardt on SE(3) (port of
`parakeet_slam_tpu.backend.posegraph`).

Minimizes sum_e || log(Z_e^-1 T_i^-1 T_j) ||^2_{Lambda_e} over the keyframe
poses, with right-multiplied tangent perturbations (T <- T exp(delta)), the
first valid node fixed as the gauge, IRLS-Huber edge weights, adaptive
damping and step acceptance. The residual Jacobians of all edges come from
one `torch.func.jacfwd` over the shared 12-dim (delta_i, delta_j)
perturbation (each edge's residual depends only on its own two poses); the
normal system is assembled into a dense [K*6, K*6] matrix and solved in
float32. Every step stays on the device: acceptance and damping are
tensors.

The assembly sums each edge's 6x6 blocks (Hii, Hjj, Hij, Hij^T) and 6-vectors
into the graph's blocks and nodes by a sorted segment sum: the contributions
are sorted by destination once per solve, summed within runs of equal keys
by a segmented scan, and each run's total is written once. On the card
`index_put_(accumulate=True)` and `index_add_` add with atomics in arrival
order, and the rounding of the solve then differed from run to run; the scan
adds in a fixed order, at O(E log E) cost per iteration.
"""

from __future__ import annotations

import torch

from parakeet_slam_tpu_torch.backend.graph import PoseGraph
from parakeet_slam_tpu_torch.core import geometry


def edge_residual(pose_i, pose_j, rel):
    """r = log(rel^-1 . pose_i^-1 . pose_j) in R^6, over leading dims."""
    between = geometry.se3_between(pose_i, pose_j)
    return geometry.se3_log(geometry.se3_compose(geometry.se3_inverse(rel), between))


def _edge_residual_perturbed(delta, pose_i, pose_j, rel):
    """Residuals [E, 6] with the tangent perturbation delta [12] applied to
    both ends of every edge: T exp(delta). The twists keep a leading axis of
    one: under `jacfwd` a 0-d float32 norm plus a Python float comes out
    float64 in PyTorch's forward-mode AD."""
    pi = geometry.se3_compose(pose_i, geometry.se3_exp(delta[None, :6]))
    pj = geometry.se3_compose(pose_j, geometry.se3_exp(delta[None, 6:]))
    return edge_residual(pi, pj, rel)


def graph_cost(g: PoseGraph) -> torch.Tensor:
    ij = g.edge_ij.long()
    r = edge_residual(g.poses[ij[:, 0]], g.poses[ij[:, 1]], g.edge_rel)
    w = g.edge_valid[:, None] * g.edge_info
    return 0.5 * torch.sum(w * r * r)


def _segment_plan(keys, n):
    """The fixed part of a segment sum over keys [N] into n rows, made once
    per solve: the stable sort of the keys, for each step d of the scan the
    mask of rows whose row d before has the same key, and each sorted row's
    destination (its key if it ends its run, else the spare row n)."""
    keys, order = torch.sort(keys, stable=True)
    steps, d = [], 1
    while d < keys.shape[0]:
        steps.append((d, (keys[d:] == keys[:-d])[:, None]))
        d *= 2
    last = torch.ones_like(keys, dtype=torch.bool)
    last[:-1] = keys[1:] != keys[:-1]
    return order, steps, torch.where(last, keys, n), n


def _segment_sum(plan, values):
    """out[k] = sum of the rows of values [N, C] whose key is k, [n, C], in a
    fixed order: the rows sorted by key, an inclusive scan within runs of
    equal keys (Hillis-Steele, log2 N steps), and each run's last row
    written once (index_put_ at distinct keys; the rest go to the spare
    row)."""
    order, steps, dest, n = plan
    v = values[order]
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    for d, same in steps:
        v[d:] += torch.where(same, v[:-d], zero)  # the right side is read before the add
    out = torch.zeros((n + 1, v.shape[1]), dtype=v.dtype, device=v.device)
    out[dest] = v
    return out[:n]


def assembly_plan(ii, jj, K):
    """The segment-sum plan of `normal_equations` for edges ii -> jj [E] on
    K nodes: rows 0..K*K-1 are H's 6x6 blocks (the (i, i), (j, j), (i, j)
    and (j, i) block of every edge), rows K*K.. are b's 6-vectors (i, j)."""
    return _segment_plan(torch.cat([ii * K + ii, jj * K + jj, ii * K + jj, jj * K + ii,
                                    K * K + ii, K * K + jj]), K * K + K)


def normal_equations(r, Ji, Jj, w, plan, K):
    """(H [K*6, K*6], b [K, 6]) of the weighted edge residuals r [E, 6] with
    Jacobians Ji, Jj [E, 6, 6] and weights w [E, 6]: H = A^T (W A) and
    b = A^T (W r) for the edge Jacobian A whose row block e holds Ji at node
    i's columns and Jj at node j's, summed per block and node in one pass of
    `_segment_sum` over `plan` (`assembly_plan`)."""
    E = r.shape[0]
    JiW, JjW = Ji * w[:, :, None], Jj * w[:, :, None]
    Hij = torch.einsum("eki,ekj->eij", Ji, JjW)
    wr = w * r
    pad = lambda x: torch.nn.functional.pad(x, (0, 30))  # noqa: E731  6-vectors as rows of 36
    out = _segment_sum(plan, torch.cat([
        torch.einsum("eki,ekj->eij", Ji, JiW).reshape(E, 36),
        torch.einsum("eki,ekj->eij", Jj, JjW).reshape(E, 36),
        Hij.reshape(E, 36), Hij.transpose(-1, -2).reshape(E, 36),
        pad(torch.einsum("eki,ek->ei", Ji, wr)), pad(torch.einsum("eki,ek->ei", Jj, wr))]))
    H = out[:K * K].reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    return H, out[K * K:, :6]


def optimize_pose_graph(
    g: PoseGraph, iters: int = 10, damping: float = 1e-4, huber: float = 3.0,
) -> tuple[PoseGraph, torch.Tensor]:
    """Levenberg-Marquardt with adaptive damping and step acceptance; returns
    (graph with optimized poses, per-iteration costs [iters]). `huber` is
    the robust kernel width in information-weighted sigma units (0 = off)."""
    K = g.max_nodes
    dev = g.poses.device
    first = torch.argmax(g.node_valid.to(torch.int32))
    free = g.node_valid & (torch.arange(K, device=dev) != first)
    w = g.edge_valid[:, None] * g.edge_info  # [E, 6]
    ii, jj = g.edge_ij[:, 0].long(), g.edge_ij[:, 1].long()
    plan = assembly_plan(ii, jj, K)
    zero = torch.zeros(12, device=dev)

    def linearize(poses):
        pi, pj = poses[ii], poses[jj]
        r = _edge_residual_perturbed(zero, pi, pj, g.edge_rel)
        J = torch.func.jacfwd(_edge_residual_perturbed)(zero, pi, pj, g.edge_rel)  # [E, 6, 12]
        return r, J[..., :6], J[..., 6:]

    def cost_at(poses):
        r = edge_residual(poses[ii], poses[jj], g.edge_rel)
        if huber <= 0.0:
            return 0.5 * torch.sum(w * r * r)
        s2 = torch.sum(w * r * r, dim=1)
        sn = torch.sqrt(torch.clamp(s2, min=1e-12))
        return torch.sum(torch.where(sn <= huber, 0.5 * s2, huber * (sn - 0.5 * huber)))

    def robust_w(r):
        """IRLS edge weights: w scaled by min(1, huber / ||r||_Lambda)."""
        if huber <= 0.0:
            return w
        sn = torch.sqrt(torch.clamp(torch.sum(w * r * r, dim=1), min=1e-12))
        return w * torch.clamp(huber / sn, max=1.0)[:, None]

    mask = free.to(torch.float32)
    fixed_diag = 1.0 - mask.repeat_interleave(6)
    poses = g.poses
    lam = torch.tensor(damping, device=dev)
    cost = cost_at(poses)
    costs = []
    for _ in range(iters):
        r, Ji, Jj = linearize(poses)
        H, b = normal_equations(r, Ji, Jj, robust_w(r), plan, K)
        # gauge and invalid nodes: project out their DOFs
        m6 = mask.repeat_interleave(6)
        Hm = H * m6[:, None] * m6[None, :]
        bm = (b * mask[:, None]).reshape(K * 6)
        # LM damping proportional to the diagonal; a unit diagonal on the
        # fixed DOFs keeps the system nonsingular
        Hm = Hm + torch.diag(fixed_diag + lam * torch.clamp(torch.diagonal(Hm), min=1e-8))
        delta = -torch.linalg.solve(Hm, bm).reshape(K, 6) * mask[:, None]
        cand = geometry.se3_compose(poses, geometry.se3_exp(delta))
        new_cost = cost_at(cand)
        accept = torch.isfinite(new_cost) & (new_cost < cost)
        poses = torch.where(accept, cand, poses)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 8.0), 1e-7, 1e6)
        cost = torch.where(accept, new_cost, cost)
        costs.append(cost)
    return g.replace(poses=poses), torch.stack(costs)
