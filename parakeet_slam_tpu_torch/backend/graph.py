"""Fixed-capacity pose-graph container (port of the pose-graph half of
`parakeet_slam_tpu.backend.graph`).

Keyframe poses and relative-pose edges are dense masked tensors with static
capacities, filled at a cursor; the optimizer works on a power-of-two view
of the live part. The cursors are host integers here (the reference keeps
them as device scalars and reads them back to size the view). Insertions
return a new graph and leave the old one as it was, as in the reference.
The bundle-adjustment problem types of the reference module belong to the
BA slice and are not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from parakeet_slam_tpu_torch.core import geometry

_FIELDS = ("poses", "node_valid", "edge_ij", "edge_rel", "edge_info", "edge_valid")


@dataclass
class PoseGraph:
    """SE(3) pose graph: nodes + relative-pose edges.

    poses      [K, 7]  keyframe poses (world-from-keyframe)
    node_valid [K]
    edge_ij    [E, 2]  int32 endpoints (i observes j: Z_ij ~ T_i^-1 T_j)
    edge_rel   [E, 7]  measured relative pose Z_ij
    edge_info  [E, 6]  diagonal information (per tangent dim)
    edge_valid [E]
    n_nodes, n_edges   cursors (host ints)
    """

    poses: torch.Tensor
    node_valid: torch.Tensor
    edge_ij: torch.Tensor
    edge_rel: torch.Tensor
    edge_info: torch.Tensor
    edge_valid: torch.Tensor
    n_nodes: int
    n_edges: int

    def replace(self, **kw) -> "PoseGraph":
        return dataclasses.replace(self, **kw)

    @property
    def max_nodes(self) -> int:
        return self.poses.shape[0]

    @property
    def max_edges(self) -> int:
        return self.edge_ij.shape[0]


def _identity(n, device):
    out = torch.zeros(n, 7, device=device)
    out[:, 6] = 1.0
    return out


def make_pose_graph(max_nodes: int, max_edges: int, *, device="cpu") -> PoseGraph:
    return PoseGraph(
        poses=_identity(max_nodes, device),
        node_valid=torch.zeros(max_nodes, dtype=torch.bool, device=device),
        edge_ij=torch.zeros(max_edges, 2, dtype=torch.int32, device=device),
        edge_rel=_identity(max_edges, device),
        edge_info=torch.ones(max_edges, 6, device=device),
        edge_valid=torch.zeros(max_edges, dtype=torch.bool, device=device),
        n_nodes=0,
        n_edges=0,
    )


def shrink_to_active(g: PoseGraph, min_cap: int = 32) -> tuple[PoseGraph, int, int]:
    """View of the graph at power-of-two capacities covering the live node
    and edge counts (the optimizer's dense normal system is [K*6, K*6]).
    Returns (view, n_nodes, n_edges); poses[:n_nodes] of the view are the
    live ones."""
    kc = min_cap
    while kc < g.n_nodes:
        kc *= 2
    ec = min_cap
    while ec < g.n_edges:
        ec *= 2
    kc = min(kc, g.max_nodes)
    ec = min(ec, g.max_edges)
    view = g.replace(
        poses=g.poses[:kc], node_valid=g.node_valid[:kc], edge_ij=g.edge_ij[:ec],
        edge_rel=g.edge_rel[:ec], edge_info=g.edge_info[:ec], edge_valid=g.edge_valid[:ec],
    )
    return view, g.n_nodes, g.n_edges


def add_node(g: PoseGraph, pose: torch.Tensor) -> PoseGraph:
    """Append a node (a no-op when full)."""
    k = g.n_nodes
    if k >= g.max_nodes:
        return g
    poses, node_valid = g.poses.clone(), g.node_valid.clone()
    poses[k] = torch.as_tensor(pose, dtype=poses.dtype).to(poses.device)
    node_valid[k] = True
    return g.replace(poses=poses, node_valid=node_valid, n_nodes=k + 1)


def add_edge(g: PoseGraph, i: int, j: int, rel, info=None, valid: bool = True) -> PoseGraph:
    """Append an edge i -> j with measurement `rel` [7] and diagonal
    information `info` [6] (ones by default); a no-op when full or invalid."""
    e = g.n_edges
    if e >= g.max_edges or not valid:
        return g
    dev = g.poses.device
    edge_ij, edge_rel = g.edge_ij.clone(), g.edge_rel.clone()
    edge_info, edge_valid = g.edge_info.clone(), g.edge_valid.clone()
    edge_ij[e, 0], edge_ij[e, 1] = int(i), int(j)
    edge_rel[e] = torch.as_tensor(rel, dtype=torch.float32).to(dev)
    edge_info[e] = 1.0 if info is None else torch.as_tensor(info, dtype=torch.float32).to(dev)
    edge_valid[e] = True
    return g.replace(edge_ij=edge_ij, edge_rel=edge_rel, edge_info=edge_info,
                     edge_valid=edge_valid, n_edges=e + 1)


def graph_from_numpy(g, *, device) -> PoseGraph:
    """Carry a graph across from any object with the PoseGraph fields as
    arrays (e.g. a JAX `PoseGraph`); uint32 arrays are reinterpreted as
    int32, as `state_from_numpy` does."""
    out = {}
    for f in _FIELDS:
        a = np.asarray(getattr(g, f))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[f] = torch.tensor(a, device=device)  # a copy: JAX buffers are read-only
    return PoseGraph(**out, n_nodes=int(np.asarray(g.n_nodes)), n_edges=int(np.asarray(g.n_edges)))


def graph_to_numpy(g: PoseGraph) -> dict[str, np.ndarray]:
    """The graph's fields as numpy arrays keyed by field name (cursors as
    int32 scalars): `jax_graph.replace(**graph_to_numpy(g))` carries it back."""
    out = {f: getattr(g, f).detach().cpu().numpy() for f in _FIELDS}
    out["n_nodes"] = np.int32(g.n_nodes)
    out["n_edges"] = np.int32(g.n_edges)
    return out


def estimate_relative_pose_3d3d(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor):
    """SE(3) T with pa ~ T(pb) from masked 3-D correspondences [..., N, 3]
    (Horn/Umeyama closed form, weights = the valid mask). Turns loop-closure
    landmark matches into pose-graph edge measurements."""
    w = valid.to(pa.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)[..., None]
    mu_a = torch.sum(pa * w[..., None], dim=-2) / n
    mu_b = torch.sum(pb * w[..., None], dim=-2) / n
    xa = (pa - mu_a[..., None, :]) * w[..., None]
    xb = (pb - mu_b[..., None, :]) * w[..., None]
    cov = xa.transpose(-1, -2) @ xb / n[..., None]
    U, _, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.cat([torch.ones_like(U[..., 0, :2]), d[..., None]], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    t = mu_a - (R @ mu_b[..., None])[..., 0]
    return torch.cat([t, geometry.matrix_to_quat(R)], dim=-1)
