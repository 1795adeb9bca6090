"""Fixed-capacity pose-graph and bundle-adjustment containers (port of
`parakeet_slam_tpu.backend.graph`).

Keyframe poses and relative-pose edges are dense masked tensors with static
capacities, filled at a cursor; the optimizer works on a power-of-two view
of the live part. The cursors are host integers here (the reference keeps
them as device scalars and reads them back to size the view). Insertions
return a new graph and leave the old one as it was, as in the reference.

A bundle-adjustment problem (`BAProblem`) is an observation list; the
solver works on a point-major layout packed on the host with numpy, either
one padded table (`pack_problem`) or a few tables bucketed by observations
per point (`pack_buckets`, the production layout). The packed tensors are
built on the problem's device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.kernels import horn
from parakeet_slam_tpu_torch.utils import trace

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


def make_pose_graph(max_nodes: int, max_edges: int, *, device) -> PoseGraph:
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
    (Horn/Umeyama closed form, weights = the valid mask; the rotation from
    `kernels/horn.rotation_fit`). Turns loop-closure landmark matches into
    pose-graph edge measurements."""
    w = valid.to(pa.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)[..., None]
    mu_a = torch.sum(pa * w[..., None], dim=-2) / n
    mu_b = torch.sum(pb * w[..., None], dim=-2) / n
    xa = (pa - mu_a[..., None, :]) * w[..., None]
    xb = (pb - mu_b[..., None, :]) * w[..., None]
    cov = xa.transpose(-1, -2) @ xb / n[..., None]
    R = horn.rotation_fit(cov)
    t = mu_a - (R @ mu_b[..., None])[..., 0]
    return torch.cat([t, geometry.matrix_to_quat(R)], dim=-1)


# ---------------------------------------------------------------------------
# Bundle adjustment: the problem and its point-major layouts
# ---------------------------------------------------------------------------

_BA_FIELDS = ("cam_pose", "cam_valid", "points", "pt_valid", "obs_cam", "obs_pt", "obs_uv",
              "obs_valid", "cam_fixed")


class _BALayout:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def num_cams(self) -> int:
        return self.cam_pose.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


@dataclass
class BAProblem(_BALayout):
    """Bundle-adjustment problem: cameras, points, projections.

    cam_pose  [C, 7]  world-from-camera SE(3)
    cam_valid [C]
    points    [Lm, 3] world landmarks
    pt_valid  [Lm]
    obs_cam   [O]     int32 camera index per observation
    obs_pt    [O]     int32 point index
    obs_uv    [O, Dz] measured projection (2 for mono/equirect, 3 stereo)
    obs_valid [O]
    cam_fixed [C]     gauge-fixing mask (the first camera typically)
    """

    cam_pose: torch.Tensor
    cam_valid: torch.Tensor
    points: torch.Tensor
    pt_valid: torch.Tensor
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor
    obs_uv: torch.Tensor
    obs_valid: torch.Tensor
    cam_fixed: torch.Tensor

    @property
    def num_obs(self) -> int:
        return self.obs_cam.shape[0]


def make_ba_problem(
    cam_pose, points, obs_cam, obs_pt, obs_uv,
    cam_valid=None, pt_valid=None, obs_valid=None, cam_fixed=None, *, device,
) -> BAProblem:
    """A BAProblem on `device` from arrays or tensors; the masks default to
    all valid, with the first camera fixed."""
    def put(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    ones = lambda n: torch.ones(n, dtype=torch.bool, device=device)  # noqa: E731
    with trace.span("ba.problem"):
        cam_pose, points = put(cam_pose, torch.float32), put(points, torch.float32)
        obs_cam, obs_pt = put(obs_cam, torch.int32), put(obs_pt, torch.int32)
        C, Lm, O = cam_pose.shape[0], points.shape[0], obs_cam.shape[0]
        if cam_fixed is None:
            cam_fixed = torch.zeros(C, dtype=torch.bool, device=device)
            cam_fixed[0] = True
        return BAProblem(
            cam_pose=cam_pose,
            cam_valid=ones(C) if cam_valid is None else put(cam_valid, torch.bool),
            points=points, pt_valid=ones(Lm) if pt_valid is None else put(pt_valid, torch.bool),
            obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=put(obs_uv, torch.float32),
            obs_valid=ones(O) if obs_valid is None else put(obs_valid, torch.bool),
            cam_fixed=put(cam_fixed, torch.bool),
        )


def ba_problem_from_numpy(arrays, *, device) -> BAProblem:
    """Carry a problem across from a mapping, or any object, that holds the
    BAProblem fields as arrays (e.g. a JAX `BAProblem`)."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else lambda f: getattr(arrays, f)
    # copies: JAX buffers are read-only
    return BAProblem(**{f: torch.tensor(np.asarray(get(f)), device=device) for f in _BA_FIELDS})


def ba_problem_to_numpy(prob: BAProblem) -> dict[str, np.ndarray]:
    """The problem's fields as numpy arrays keyed by field name."""
    return {f: getattr(prob, f).detach().cpu().numpy() for f in _BA_FIELDS}


@dataclass
class BAProblemPacked(_BALayout):
    """Point-major padded BA problem, derived from a `BAProblem` by
    `pack_problem`: every point's observations sit in one dense [Lm, Kmax]
    table, so the per-point aggregations of the Schur matvec (Jp^T t, the C
    blocks, w_g, the back-substitution) are dense sums over axis 1.

    cam_pose  [C, 7], cam_valid [C], cam_fixed [C]
    points    [Lm, 3], pt_valid [Lm]
    p_cam     [Lm, K] int32 camera index per slot
    p_uv      [Lm, K, Dz]
    p_valid   [Lm, K] bool (padding slots are False)
    """

    cam_pose: torch.Tensor
    cam_valid: torch.Tensor
    points: torch.Tensor
    pt_valid: torch.Tensor
    cam_fixed: torch.Tensor
    p_cam: torch.Tensor
    p_uv: torch.Tensor
    p_valid: torch.Tensor

    @property
    def k_max(self) -> int:
        return self.p_cam.shape[1]


def _obs_numpy(prob: BAProblem):
    return tuple(getattr(prob, f).detach().cpu().numpy()
                 for f in ("obs_pt", "obs_cam", "obs_uv", "obs_valid"))


def pack_problem(prob: BAProblem, k_max: int | None = None) -> BAProblemPacked:
    """Host-side repack of a BAProblem into the point-major padded layout.
    k_max defaults to the largest number of observations of one point,
    rounded up to a multiple of 4."""
    obs_pt, obs_cam, obs_uv, valid = _obs_numpy(prob)
    Lm = prob.num_points
    Dz = obs_uv.shape[1]

    pt_v = obs_pt[valid]
    counts = np.bincount(pt_v, minlength=Lm) if pt_v.size else np.zeros(Lm, np.int64)
    need = int(counts.max()) if counts.size else 1
    if k_max is None:
        k_max = max(4, ((need + 3) // 4) * 4)
    elif need > k_max:
        raise ValueError(
            f"pack_problem: k_max={k_max} < max obs/point {need}; raise k_max or split the problem"
        )

    p_cam = np.zeros((Lm, k_max), np.int32)
    p_uv = np.zeros((Lm, k_max, Dz), obs_uv.dtype)
    p_valid = np.zeros((Lm, k_max), bool)
    idx = np.nonzero(valid)[0]
    if idx.size:
        order = np.argsort(obs_pt[idx], kind="stable")
        o_sorted = idx[order]
        pts = obs_pt[o_sorted]
        starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
        slots = np.arange(o_sorted.size) - starts[pts]
        p_cam[pts, slots] = obs_cam[o_sorted]
        p_uv[pts, slots] = obs_uv[o_sorted]
        p_valid[pts, slots] = True

    dev = prob.points.device
    return BAProblemPacked(
        cam_pose=prob.cam_pose, cam_valid=prob.cam_valid, points=prob.points,
        pt_valid=prob.pt_valid, cam_fixed=prob.cam_fixed,
        p_cam=torch.as_tensor(p_cam, device=dev), p_uv=torch.as_tensor(p_uv, device=dev),
        p_valid=torch.as_tensor(p_valid, device=dev),
    )


@dataclass
class BAProblemBuckets(_BALayout):
    """Bucketed point-major BA layout, the solver's production form.

    `BAProblemPacked` pads every point to the global maximum of observations
    per point, which on skewed covisibility (mean ~2.6, max 12+) multiplies
    the dense work several times. Here points are grouped by observation
    count into a few tables, each padded only to its own K cap, so padded
    work stays within ~2x of the true observation count. Each point is in
    exactly one bucket; per-point reductions are dense sums over axis 1
    inside a bucket.

    cam_pose [C, 7], cam_valid [C], cam_fixed [C]
    points   [Lm, 3], pt_valid [Lm]
    pt_idx    tuple of [Lb]        original point index per bucket row
    row_valid tuple of [Lb]        padding rows are False
    p_cam     tuple of [Lb, Kb] int32
    p_uv      tuple of [Lb, Kb, Dz]
    p_valid   tuple of [Lb, Kb]
    """

    cam_pose: torch.Tensor
    cam_valid: torch.Tensor
    points: torch.Tensor
    pt_valid: torch.Tensor
    cam_fixed: torch.Tensor
    pt_idx: tuple
    row_valid: tuple
    p_cam: tuple
    p_uv: tuple
    p_valid: tuple


_BUCKET_CAPS = (4, 8, 16, 32, 64, 128)


def pack_buckets(prob: BAProblem, caps=_BUCKET_CAPS) -> BAProblemBuckets:
    """Host-side repack of a BAProblem into the bucketed point-major layout.
    The K caps are the fixed ladder above, and bucket row counts round up to
    multiples of 512 (the reference's shapes, which its compiled optimizer
    reuses across similar problems)."""
    with trace.span("ba.pack"):
        obs_pt, obs_cam, obs_uv, valid = _obs_numpy(prob)
        Lm = prob.num_points
        Dz = obs_uv.shape[1]

        idx = np.nonzero(valid)[0]
        counts = np.bincount(obs_pt[idx], minlength=Lm)
        need = int(counts.max()) if idx.size else 1
        caps = [k for k in caps if k < need] + [max(4, int(2 ** np.ceil(np.log2(need))))]
        caps = sorted(set(caps))

        # observations sorted by point; per-point slot = rank within the point
        order = np.argsort(obs_pt[idx], kind="stable")
        o_sorted = idx[order]
        pts_sorted = obs_pt[o_sorted]
        starts = np.concatenate(([0], np.cumsum(counts)))
        slots = np.arange(o_sorted.size) - starts[pts_sorted]

        # bucket id per point (points with no observation join no bucket)
        bucket_of = np.searchsorted(caps, counts, side="left")
        tables = []  # (pt_idx, row_valid, p_cam, p_uv, p_valid) per bucket
        for b, K in enumerate(caps):
            members = np.nonzero((bucket_of == b) & (counts > 0))[0]
            if members.size == 0:
                continue
            Lb = int(-(-members.size // 512) * 512)
            row_of = np.full(Lm, -1, np.int64)
            row_of[members] = np.arange(members.size)
            pt_idx = np.zeros(Lb, np.int32)
            pt_idx[: members.size] = members
            row_valid = np.zeros(Lb, bool)
            row_valid[: members.size] = True
            p_cam = np.zeros((Lb, K), np.int32)
            p_uv = np.zeros((Lb, K, Dz), obs_uv.dtype)
            p_valid = np.zeros((Lb, K), bool)
            sel = row_of[pts_sorted] >= 0
            r = row_of[pts_sorted[sel]]
            s = slots[sel]
            o = o_sorted[sel]
            p_cam[r, s] = obs_cam[o]
            p_uv[r, s] = obs_uv[o]
            p_valid[r, s] = True
            tables.append((pt_idx, row_valid, p_cam, p_uv, p_valid))

        if not tables:  # degenerate: no valid observation at all
            tables = [(np.zeros(512, np.int32), np.zeros(512, bool), np.zeros((512, 4), np.int32),
                       np.zeros((512, 4, Dz), obs_uv.dtype), np.zeros((512, 4), bool))]

        dev = prob.points.device
        cols = [tuple(torch.as_tensor(t[i], device=dev) for t in tables) for i in range(5)]
        return BAProblemBuckets(
            cam_pose=prob.cam_pose, cam_valid=prob.cam_valid, points=prob.points,
            pt_valid=prob.pt_valid, cam_fixed=prob.cam_fixed,
            pt_idx=cols[0], row_valid=cols[1], p_cam=cols[2], p_uv=cols[3], p_valid=cols[4],
        )


def cap_obs_per_point(prob: BAProblem, k: int) -> BAProblem:
    """Host-side covisibility thinning: keep at most k observations per
    point, spread evenly across that point's observing cameras (by
    observation order = keyframe order). Long runs re-observe some landmarks
    hundreds of times; beyond a few dozen views per point the extra
    residuals barely change the solution, but the bucketed pack's [Lb, Kmax]
    temporaries grow with them."""
    if k <= 0:
        return prob
    obs_pt = prob.obs_pt.detach().cpu().numpy()
    valid = prob.obs_valid.detach().cpu().numpy().copy()
    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return prob
    order = np.argsort(obs_pt[idx], kind="stable")
    o_sorted = idx[order]
    pts_sorted = obs_pt[o_sorted]
    counts = np.bincount(pts_sorted, minlength=prob.num_points)
    starts = np.concatenate(([0], np.cumsum(counts)))
    rank = np.arange(o_sorted.size) - starts[pts_sorted]
    cnt = np.maximum(counts[pts_sorted], 1)
    # Even decimation: keep rank r iff floor(r*k/c) advanced. For c > k this
    # keeps exactly k ranks; for c <= k it advances every step and keeps all.
    keep = (rank * k) // cnt != ((rank - 1) * k) // cnt
    keep |= rank == 0
    valid[o_sorted[~keep]] = False
    return prob.replace(obs_valid=torch.as_tensor(valid, device=prob.obs_valid.device))


def gate_outlier_obs(camera, prob: BAProblem, max_px: float) -> BAProblem:
    """Invalidate observations whose reprojection residual at the initial
    values exceeds max_px: the gross-outlier gate before bundle adjustment
    (wrong associations and diverged landmarks give residuals whose
    robustified cost still drowns the real signal)."""
    cam = prob.cam_pose[prob.obs_cam.long()]
    pt = prob.points[prob.obs_pt.long()]
    pred = camera.project(geometry.se3_apply_inverse(cam, pt))
    if hasattr(camera, "residual"):
        r = camera.residual(prob.obs_uv, pred)
    else:
        r = prob.obs_uv - pred
    n = torch.linalg.vector_norm(r, dim=-1)
    return prob.replace(obs_valid=prob.obs_valid & torch.isfinite(n) & (n < max_px))
