"""Pose-graph optimization: Levenberg-Marquardt on SE(3) (port of
`parakeet_slam_tpu.backend.posegraph`).

Minimizes sum_e || log(Z_e^-1 T_i^-1 T_j) ||^2_{Lambda_e} over the keyframe
poses, with right-multiplied tangent perturbations (T <- T exp(delta)), the
first valid node fixed as the gauge, IRLS-Huber edge weights, adaptive
damping and step acceptance. The residual Jacobians of all edges come from
one `torch.func.jacfwd` over the shared 12-dim (delta_i, delta_j)
perturbation (each edge's residual depends only on its own two poses); the
normal system is assembled densely ([K*6, K*6]) and solved in float32.
Every step stays on the device: acceptance and damping are tensors.
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
    six = torch.arange(6, device=dev)
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

    def block(a, b):  # rows of node a, columns of node b: [E, 6, 6] indices
        return (a[:, None] * 6 + six)[:, :, None], (b[:, None] * 6 + six)[:, None, :]

    mask = free.to(torch.float32)
    fixed_diag = 1.0 - mask.repeat_interleave(6)
    poses = g.poses
    lam = torch.tensor(damping, device=dev)
    cost = cost_at(poses)
    costs = []
    for _ in range(iters):
        r, Ji, Jj = linearize(poses)
        we = robust_w(r)
        wr = we * r
        JiW, JjW = Ji * we[:, :, None], Jj * we[:, :, None]
        Hii = torch.einsum("eki,ekj->eij", Ji, JiW)
        Hjj = torch.einsum("eki,ekj->eij", Jj, JjW)
        Hij = torch.einsum("eki,ekj->eij", Ji, JjW)
        bi = torch.einsum("eki,ek->ei", Ji, wr)
        bj = torch.einsum("eki,ek->ei", Jj, wr)
        H = torch.zeros(K * 6, K * 6, device=dev)
        H.index_put_(block(ii, ii), Hii, accumulate=True)
        H.index_put_(block(jj, jj), Hjj, accumulate=True)
        H.index_put_(block(ii, jj), Hij, accumulate=True)
        H.index_put_(block(jj, ii), Hij.transpose(-1, -2), accumulate=True)
        b = torch.zeros(K, 6, device=dev).index_add_(0, ii, bi).index_add_(0, jj, bj)
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
