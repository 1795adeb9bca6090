"""The keyframe flush's reference: one flush of the online system worked
out again by plain code, on the keyframe backend as the program held it
before the flush frame and on the frames of the flush window as the filter
reference (`reference/filter.py`) worked them out.

A flush, every `lag` frames (the system's `flush_flags`):
  1. the closure matches of the keyframes the previous flush made (those
     whose frame lies in the previous window) are resolved: each keyframe's
     descriptors are matched both ways against every keyframe at least
     `loop_min_frame_gap` frames older (the frozen copy's plain Hamming
     top-2 and Lowe ratio test), the candidates are the two keyframes with
     the most mutual matches at `min_matches` or more and the places whose
     bit-frequency signature is alike at half that, each candidate is
     verified (three rounds of Horn's fit with inlier re-selection, then a
     reprojection refine of the edge), and every candidate with
     `min_matches` inliers becomes a closure edge;
  2. where an accepted closure passes the innovation gate, the pose graph
     is solved (the frozen copy's Levenberg-Marquardt), and the correction
     of the latest keyframe is applied to the filter state, the keyframe
     reference and the keyframe poses;
  3. each flagged frame of the window becomes a keyframe: its estimate
     (after this flush's correction) and its own map snapshot, a node, and
     an odometry edge to the keyframe before.

The program's flush reads the same numbers; the reference takes none of
them from it, only the backend as it stood before the flush frame.
Verification and the solve run in float32, as the program's; Horn's
rotation is the frozen copy's SVD twin (the program's is a kernel that
agrees to ~1e-5), so the edges and the solved poses are compared with
limits, and the closure pairs and keyframe counts exactly."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slambench.reference import filter as fref
from slambench.reference.frozen.backend import graph as fgraph
from slambench.reference.frozen.backend import posegraph
from slambench.reference.frozen.core import geometry
from slambench.reference.frozen.frontend import camera as fcamera
from slambench.reference.frozen.kernels import match as fmatch

# the system's closure threshold (`_resolve_closures`' default) and the
# keyframe store's first capacity
MIN_MATCHES = 12
STORE_ROWS = 64


@dataclasses.dataclass
class Backend:
    """The keyframe backend at one instant, as host arrays and device
    tensors the flush does not write in place: each keyframe's pose [7],
    its snapshot (points [F, 3] in its own frame, descriptors [F, W] int32
    words, validity [F]) and its frame (1-based), the pose graph's fields
    and cursors, the accepted closures (old, new) and the keyframe
    reference pose [7]."""

    poses: list
    points: list
    desc: list
    valid: list
    frames: list
    graph: dict
    n_nodes: int
    n_edges: int
    closures: list
    last_kf: torch.Tensor

    def copy(self) -> "Backend":
        return dataclasses.replace(
            self, poses=[p.copy() for p in self.poses], points=list(self.points),
            desc=list(self.desc), valid=list(self.valid), frames=list(self.frames),
            graph={k: v.clone() for k, v in self.graph.items()}, closures=list(self.closures),
            last_kf=self.last_kf.clone())

    def pose_graph(self) -> fgraph.PoseGraph:
        return fgraph.PoseGraph(**self.graph, n_nodes=self.n_nodes, n_edges=self.n_edges)

    def set_graph(self, g: fgraph.PoseGraph) -> None:
        self.graph = {f: getattr(g, f) for f in fgraph._FIELDS}
        self.n_nodes, self.n_edges = g.n_nodes, g.n_edges


def global_descriptor(desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Bit-frequency signature of a keyframe's descriptors: the share of
    valid descriptors with each bit set, less 0.5, L2-normalized."""
    F, W = desc.shape
    if valid.sum() == 0:
        return np.zeros((W * 32,), np.float32)
    bits = np.unpackbits(desc[valid].view(np.uint8), bitorder="little").reshape(-1, W * 32)
    f = bits.mean(axis=0).astype(np.float32) - 0.5
    n = float(np.linalg.norm(f))
    return f / n if n > 1e-9 else f


def _huber(n, valid, delta):
    w = torch.where(valid, torch.clamp(delta / torch.clamp(n, min=1e-6), max=1.0),
                    torch.zeros_like(n))
    c = torch.where(n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta))
    return torch.sum(c * valid, dim=-1), w


class Flush:
    """The reference flush of a configuration (its frozen `SLAMConfig`)."""

    def __init__(self, cfg, device):
        if cfg.backend.loop_refine_depth_sigma > 0.0:
            raise NotImplementedError("the flush reference refines closure edges with the "
                                      "structure fixed (loop_refine_depth_sigma 0)")
        self.cfg = cfg
        self.device = device
        self.camera = fcamera.from_config(cfg.frontend)
        self.lag = 4
        # each solve's largest move of a keyframe pose (`_pose_gap`), and
        # its correction's translation, in metres: what a flush that skipped
        # the solve would miss by
        self.moves: list = []

    # -- closures ---------------------------------------------------------

    def _candidates(self, be: Backend, kidx: int, n_old: int, sigs: list) -> list:
        """(old index, pa, pb, valid) of keyframe kidx's closure candidates
        among the first n_old keyframes."""
        dev = self.device
        qd = torch.as_tensor(be.desc[kidx].view(np.int32), device=dev)
        qv = torch.as_tensor(be.valid[kidx], device=dev)
        db = torch.as_tensor(np.stack([d.view(np.int32) for d in be.desc[:n_old]]), device=dev)
        dbv = torch.as_tensor(np.stack(be.valid[:n_old]), device=dev)
        ratio = self.cfg.frontend.match_ratio
        fwd, _ = fmatch.match(qd, qv, db, dbv, ratio=ratio)       # [n_old, F]
        rev, _ = fmatch.match(db, dbv, qd, qv, ratio=ratio)
        fwd, rev = fwd.cpu().numpy(), rev.cpu().numpy()
        F = fwd.shape[1]
        rows = np.arange(F)[None, :]
        mutual = (fwd >= 0) & (np.take_along_axis(rev, np.clip(fwd, 0, F - 1), axis=1) == rows)
        # the counts over the keyframe store's rows at the dispatch (64,
        # doubled as needed), the rows past n_old at 0: `np.argsort` breaks
        # ties by the array it is given
        cap = STORE_ROWS
        while cap < kidx + 1:
            cap *= 2
        counts = np.zeros(cap, np.int64)
        counts[:n_old] = mutual.sum(axis=1)
        cands = [(int(k), MIN_MATCHES) for k in np.argsort(counts)[::-1][:2]]
        sims = np.asarray([float(sigs[kidx] @ sigs[i]) for i in range(n_old)])
        seen = {c[0] for c in cands}
        relaxed = max(6, MIN_MATCHES // 2)
        for i in np.argsort(sims)[::-1][:2]:
            i = int(i)
            if sims[i] > 0.5 and i not in seen and counts[i] >= relaxed:
                cands.append((i, relaxed))
        out = []
        for k, thr in cands:
            if counts[k] < thr:
                continue
            sel = np.where(mutual[k])[0]
            pa = np.zeros((F, 3), np.float32)
            pb = np.zeros((F, 3), np.float32)
            pa[:len(sel)] = be.points[kidx][sel]
            pb[:len(sel)] = be.points[k][fwd[k, sel]]
            out.append((k, pa, pb, np.arange(F) < len(sel)))
        return out

    def _horn(self, pa, pb, valid):
        radius = self.cfg.backend.loop_inlier_radius
        cur, rel = valid, None
        for _ in range(3):
            rel = fgraph.estimate_relative_pose_3d3d(pb, pa, cur)
            fit = geometry.se3_apply(rel[..., None, :], pa)
            cur = (torch.linalg.vector_norm(fit - pb, dim=-1) < radius) & valid
        return rel, torch.sum(cur.to(torch.int32), dim=-1)

    def _refine(self, rel0, pa, pb, valid):
        """Eight Gauss-Newton steps on the edge's tangent against the
        symmetric pixel reprojection error under a 3 px Huber kernel, a
        step kept only where it lowers the cost; rel0 where the refined
        cost is not better."""
        cam = self.camera
        delta = 3.0
        vm = torch.cat([valid, valid], dim=-1)
        uv_a, uv_b = cam.project(pa), cam.project(pb)

        def residual(rel):
            pao = geometry.se3_apply(rel[..., None, :], pa)
            pbk = geometry.se3_apply_inverse(rel[..., None, :], pb)
            return torch.cat([cam.project(pao) - uv_b, cam.project(pbk) - uv_a], dim=-2)

        def cost_w(rel):
            return _huber(torch.linalg.vector_norm(residual(rel), dim=-1), vm, delta)

        def perturbed(xi, rel):
            return geometry.se3_compose(rel, geometry.se3_exp(xi[None])[0])

        eye = torch.eye(6, device=pa.device)
        zero = torch.zeros(6, device=pa.device)
        rel = rel0
        for _ in range(8):
            r0 = residual(rel)
            _, w = cost_w(rel)
            J = torch.func.jacfwd(lambda x: residual(perturbed(x, rel)))(zero).flatten(-3, -2)
            wf = w.repeat_interleave(r0.shape[-1], dim=-1)
            A = J.transpose(-1, -2) @ (wf[..., None] * J) + 1e-4 * eye
            b = (J.transpose(-1, -2) @ (wf * r0.flatten(-2))[..., None])[..., 0]
            xi = -torch.linalg.solve_ex(A, b, check_errors=False)[0]
            xi = torch.where(torch.isfinite(xi), xi, torch.zeros_like(xi))
            cand = geometry.se3_compose(rel, geometry.se3_exp(xi))
            c_old, _ = cost_w(rel)
            c_new, _ = cost_w(cand)
            rel = torch.where((torch.isfinite(c_new) & (c_new < c_old))[..., None], cand, rel)
        c0, _ = cost_w(rel0)
        c1, _ = cost_w(rel)
        return torch.where((torch.isfinite(c1) & (c1 <= c0))[..., None], rel, rel0)

    def _resolve(self, be: Backend, frame_idx: int) -> bool:
        """Step 1 on `be` in place; True where a closure asks for a solve."""
        lo, hi = frame_idx - 2 * self.lag + 1, frame_idx - self.lag
        gap = self.cfg.backend.loop_min_frame_gap
        sigs = [global_descriptor(d, v) for d, v in zip(be.desc, be.valid)]
        rows = []
        for kidx, fr in enumerate(be.frames):
            if not lo <= fr <= hi:
                continue
            n_old = sum(1 for f in be.frames[:kidx] if f <= fr - gap)
            if n_old:
                rows += [(kidx, *c) for c in self._candidates(be, kidx, n_old, sigs)]
        if not rows:
            return False
        dev = self.device
        # one batch of a power of two rows, as the program verifies
        nc = 1
        while nc < len(rows):
            nc *= 2
        pa, pb, valid = (torch.as_tensor(np.concatenate(
            [np.stack([r[i] for r in rows]),
             np.zeros((nc - len(rows),) + rows[0][i].shape, rows[0][i].dtype)]), device=dev)
            for i in (2, 3, 4))
        rel, n_in = self._horn(pa, pb, valid)
        rel = self._refine(rel, pa, pb, valid).cpu()
        n_in = n_in.cpu()
        g = be.pose_graph()
        need = False
        it, ir = self.cfg.backend.loop_edge_info
        gate = self.cfg.backend.loop_min_innovation
        for (kidx, old, *_), r, n in zip(rows, rel, n_in):
            if int(n) < max(MIN_MATCHES, 4):
                continue
            g = fgraph.add_edge(g, old, kidx, r, info=[it, it, it, ir, ir, ir])
            be.closures.append((old, kidx))
            if gate > 0.0:
                pred = geometry.se3_between(torch.as_tensor(be.poses[old]),
                                            torch.as_tensor(be.poses[kidx]))
                xi = geometry.se3_log(geometry.se3_between(r, pred)).numpy()
                if float(np.linalg.norm(xi[:3]) + 3.0 * np.linalg.norm(xi[3:])) < gate:
                    continue
            need = True
        be.set_graph(g)
        return need

    def _solve(self, be: Backend, state):
        """Step 2 on `be` in place: the solved graph and the correction
        applied; returns (state, correction [7])."""
        g = be.pose_graph()
        view, _, _ = fgraph.shrink_to_active(g)
        view, _ = posegraph.optimize_pose_graph(view, iters=self.cfg.backend.gn_iters)
        poses = g.poses.clone()
        poses[:view.poses.shape[0]] = view.poses
        be.set_graph(g.replace(poses=poses))
        k = len(be.poses) - 1
        corr = geometry.se3_compose(poses[k], geometry.se3_inverse(
            torch.as_tensor(be.poses[k], device=poses.device)))
        state = dataclasses.replace(state, pose=geometry.se3_compose(corr, state.pose),
                                    lm_mean=geometry.se3_apply(corr, state.lm_mean))
        be.last_kf = geometry.se3_compose(corr, be.last_kf)
        host = poses[:len(be.poses)].cpu().numpy()
        moved = fref._pose_gap(torch.as_tensor(host), torch.as_tensor(np.stack(be.poses)))
        self.moves.append((float(moved.max()), float(torch.linalg.vector_norm(corr[:3]))))
        be.poses = [host[i] for i in range(len(be.poses))]
        return state, corr

    # -- keyframes --------------------------------------------------------

    def _keyframe(self, be: Backend, est, snap, frame: int) -> None:
        pts, desc, valid = (t.cpu().numpy() for t in snap)
        pose = est.to(torch.float32)
        be.poses.append(pose.cpu().numpy())
        be.points.append(pts)
        be.desc.append(desc)
        be.valid.append(valid)
        be.frames.append(frame)
        g = fgraph.add_node(be.pose_graph(), pose)
        k = len(be.poses) - 1
        if k > 0:
            rel = geometry.se3_between(torch.as_tensor(be.poses[k - 1], device=pose.device), pose)
            df = max(frame - be.frames[k - 1], 1)
            it0, ir0 = self.cfg.backend.odom_edge_info
            st, sr = self.cfg.data.odom_noise
            it = 1.0 / (df * float(st) ** 2 + 1.0 / it0)
            ir = 1.0 / (df * float(sr) ** 2 + 1.0 / ir0)
            g = fgraph.add_edge(g, k - 1, k, rel, info=[it, it, it, ir, ir, ir])
        be.set_graph(g)

    def __call__(self, be: Backend, pending: list, state, last_kf, frame_idx: int):
        """The flush at the 1-based frame `frame_idx` on the backend `be`
        as it stood before the flush window, with the window's frames
        `pending` [(frame, est, flag, snapshot)], the filter state after
        the flush frame's step and the keyframe reference the window's
        flags latched. Returns (state, backend) after the flush; `be` is
        left as it was."""
        be = be.copy()
        be.last_kf = last_kf.clone()
        corr = None
        if self._resolve(be, frame_idx):
            state, corr = self._solve(be, state)
        for fr, est, flag, snap in pending:
            if not bool(flag):
                continue
            if corr is not None:
                est = geometry.se3_compose(corr.to(est.device), est)
            self._keyframe(be, est, snap, fr)
        return state, be


def compare(prog: Backend, ref: Backend, before: Backend, tol_m: float = 1e-3) -> dict:
    """The numbers compared for one flush: the program's backend after it
    (`prog`) against the reference's (`ref`), both from `before`.

    `kf_count_differs` counts the keyframes one side made and the other
    did not; `closure_pairs_differ` the closures one side accepted and the
    other did not. `graph_pose_gap` is the largest pose gap over the
    keyframe poses, the graph's node poses (both solved by the flush where
    it solves) and the keyframe reference; `kf_pose_gap` over the poses of
    the keyframes this flush made; `kf_snapshot_mismatch_share` the share
    of their snapshot rows that mismatch (`filter._lane_mismatch`);
    `closure_rel_gap` the largest pose gap over the edges this flush
    added (inf where the two sides' edges join other keyframes)."""
    k0, K = len(before.poses), min(len(prog.poses), len(ref.poses))
    out = {"kf_count_differs": float(abs(len(prog.poses) - len(ref.poses))),
           "closure_pairs_differ": float(len(set(prog.closures[len(before.closures):])
                                             ^ set(ref.closures[len(before.closures):])))}

    def gap(a, b):
        a = torch.as_tensor(np.asarray(a), dtype=torch.float32)
        b = torch.as_tensor(np.asarray(b), dtype=torch.float32)
        g = fref._pose_gap(a, b)
        return float(torch.where(torch.isfinite(g), g, torch.full_like(g, float("inf"))).max())

    old = [gap(prog.poses[:k0], ref.poses[:k0])] if k0 else []
    n = min(prog.n_nodes, ref.n_nodes)
    nodes = [gap(prog.graph["poses"][:n].cpu(), ref.graph["poses"][:n].cpu())] if n else []
    out["graph_pose_gap"] = max(old + nodes + [gap(prog.last_kf.cpu()[None],
                                                   ref.last_kf.cpu()[None])])
    new = range(k0, K)
    out["kf_pose_gap"] = gap(prog.poses[k0:K], ref.poses[k0:K]) if K > k0 else 0.0
    rows = bad = 0
    for k in new:
        t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
        m = fref._lane_mismatch(t(prog.valid[k]), t(prog.points[k]), t(prog.desc[k]),
                                t(ref.valid[k]), t(ref.points[k]), t(ref.desc[k]), tol_m)
        rows += m.numel()
        bad += int(m.sum())
    out["kf_snapshot_mismatch_share"] = bad / rows if rows else 0.0
    e0 = before.n_edges
    e1 = min(prog.n_edges, ref.n_edges)
    if prog.n_edges != ref.n_edges or not torch.equal(prog.graph["edge_ij"][e0:e1].cpu(),
                                                      ref.graph["edge_ij"][e0:e1].cpu()):
        out["closure_rel_gap"] = float("inf")
    else:
        out["closure_rel_gap"] = (gap(prog.graph["edge_rel"][e0:e1].cpu(),
                                      ref.graph["edge_rel"][e0:e1].cpu()) if e1 > e0 else 0.0)
    return out
