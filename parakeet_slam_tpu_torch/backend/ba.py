"""Bundle adjustment: Schur-complement reduced camera system, solved by PCG
with an implicit operator (port of `parakeet_slam_tpu.backend.ba`).

Minimizes sum rho(|| pi(T_c, X_p) - u ||^2) over camera poses T (SE(3)
tangent steps, right-multiplied) and points X. The normal equations are
[B E; E^T C][dc; dp] = -[v; w] with C block-diagonal (3x3 per landmark).
Schur: (B - E C^-1 E^T) dc = -v + E C^-1 w, then dp = -C^-1 (w + E^T dc).

- The reduced camera matrix S = B - E C^-1 E^T is never built (except by
  `solver="dense"`, column by column). PCG needs only S x, computed per
  observation: S x = B x - Jc^T (Jp (C^-1 (Jp^T (Jc x)))).
- Every C^-1 apply is `kernels.schur.cinv_apply`: the hand-written kernel on
  CUDA tensors, its plain twin on CPU tensors.
- Huber weights fold into the residual/Jacobian weighting.
- Jacobians are closed forms (`linearize`): camera.jac_project chained with
  the SE(3) right perturbation, held to the forward-mode twin
  `linearize_ad` in the tests.
- One Levenberg-Marquardt iteration is a function of the problem buffers
  and the state (poses, points, damping), the body of the reference's
  `lax.scan`: its accept test and damping stay tensors on the device, and
  no iteration reads a value back to the host or copies one from it. The
  solver runs under `torch.no_grad()`; nothing differentiates through it.
- On CUDA tensors `optimize_ba` runs the iteration as a CUDA graph
  (`CapturedBA`: the reference's jitted program), one graph per shape key,
  captured at the second iteration of the key's first solve and replayed
  from then on; `capture=False` is the eager twin, the same iteration
  function called from a Python loop. Direct callers share one `CapturedBA`
  per device (`captured_solver`), kept for the life of the process with a
  graph pool of its own; `SLAMSystem` keeps its own on the system's pool.

Three layouts, as in the reference: the bucketed point-major one
(`_bucket_iteration`, what `optimize_ba` runs on a `BAProblem`), the padded
point-major one (`_packed_step`) and the observation-major oracle
(`optimize_ba_obsmajor`). In the bucketed solver the camera-side gathers are
`index_select` (exact). Every segment sum, in all three layouts, is a
product with a 0/1 matrix [n, N] (built once per solve in the bucketed
solver, per sum in the other two): a deterministic sum, where `index_add_`
on the card adds with atomics in arrival order. The reported
costs differ by path on purpose: the bucketed solver reports the achieved
cost and refuses non-finite candidates, the other two report the
candidate's cost.
"""

from __future__ import annotations

import itertools
from typing import Callable, NamedTuple

import torch

from parakeet_slam_tpu_torch.backend import graph as graph_mod
from parakeet_slam_tpu_torch.backend import posegraph
from parakeet_slam_tpu_torch.backend.graph import BAProblem
from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.filter import captured
from parakeet_slam_tpu_torch.kernels import schur
from parakeet_slam_tpu_torch.utils import trace

# the number of each solve, the `rid` of its `ba.solve` span
_SOLVE_IDS = itertools.count()


class BAResult(NamedTuple):
    problem: object               # the input's type, with updated poses and points
    costs: torch.Tensor           # [iters]
    pcg_residuals: torch.Tensor   # [iters]


def _residual(camera, uv, pred):
    if hasattr(camera, "residual"):
        return camera.residual(uv, pred)
    return uv - pred


def _project_residual(camera, delta, cam_pose, point, uv):
    """Reprojection residuals [..., Dz] with the 6-dof camera tangent and the
    3-dof point perturbation delta = [dc(6), dp(3)] applied to every
    observation. The twist keeps a leading axis of one (see
    `posegraph._edge_residual_perturbed`)."""
    pose = geometry.se3_compose(cam_pose, geometry.se3_exp(delta[None, :6]))
    p_cam = geometry.se3_apply_inverse(pose, point + delta[6:])
    return _residual(camera, uv, camera.project(p_cam))


def _huber_weights(valid, r, huber_delta):
    """w = min(1, delta / ||r||) folded with observation validity."""
    rnorm = torch.linalg.vector_norm(r, dim=-1)
    w_huber = torch.clamp(huber_delta / torch.clamp(rnorm, min=1e-9), max=1.0)
    return w_huber * valid.to(r.dtype)


def _huber_cost(r, valid, huber_delta):
    n = torch.linalg.vector_norm(r, dim=-1)
    rho = torch.where(n <= huber_delta, 0.5 * n * n, huber_delta * (n - 0.5 * huber_delta))
    return torch.sum(rho * valid)


def _obs_operands(prob: BAProblem):
    return prob.cam_pose[prob.obs_cam.long()], prob.points[prob.obs_pt.long()]


def linearize_ad(camera, prob: BAProblem, huber_delta: float):
    """Forward-mode twin of `linearize`, the oracle of the tests: one
    `torch.func.jacfwd` over a 9-dim perturbation shared by every
    observation (each residual depends on its own camera and point only)."""
    cam, pt = _obs_operands(prob)
    zero = torch.zeros(9, dtype=cam.dtype, device=cam.device)
    fn = lambda d: _project_residual(camera, d, cam, pt, prob.obs_uv)  # noqa: E731
    r = fn(zero)
    J = torch.func.jacfwd(fn)(zero)                         # [O, Dz, 9]
    return r, J[..., :6], J[..., 6:], _huber_weights(prob.obs_valid, r, huber_delta)


def _linearize_at(camera, cam, pt, uv, valid, huber_delta):
    """Residuals and closed-form Jacobians of observations with camera poses
    cam [..., 7], points pt [..., 3] and measurements uv [..., Dz].

    Right perturbation on the camera, additive on the point:
      p_cam(dc, dp) = (T exp(dc))^-1 (X + dp) = exp(-dc) q,  q = T^-1 X
      => d p_cam / d v = -I,  d p_cam / d w = [q]_x,  d p_cam / d X = R(T)^T;
      residual = z (-) proj(p_cam)
      => Jc = [dpi, -dpi [q]_x],  Jp = -dpi R^T,  dpi = camera.jac_project.
    Returns (r [..., Dz], Jc [..., Dz, 6], Jp [..., Dz, 3], w [...])."""
    q = geometry.se3_apply_inverse(cam, pt)
    r = _residual(camera, uv, camera.project(q))
    dpi = camera.jac_project(q)
    Jc = torch.cat([dpi, -dpi @ geometry.hat3(q)], dim=-1)
    Rt = geometry.quat_to_matrix(geometry.quat_conjugate(cam[..., 3:]))
    Jp = -dpi @ Rt
    return r, Jc, Jp, _huber_weights(valid, r, huber_delta)


def linearize(camera, prob: BAProblem, huber_delta: float):
    """(r [O, Dz], Jc [O, Dz, 6], Jp [O, Dz, 3], w [O]) of all observations;
    w folds validity and the Huber weight."""
    cam, pt = _obs_operands(prob)
    return _linearize_at(camera, cam, pt, prob.obs_uv, prob.obs_valid, huber_delta)


def _segment_sum(values, index, n):
    """out[i] = sum of the rows of values whose index is i, as a product
    with the 0/1 selector [n, N] (see `_selector`): summed in a fixed order
    on every device. The selector is dense, which suits the oracles' test
    sizes; the bucketed solver builds its selectors once per solve."""
    flat = values.reshape(values.shape[0], -1)
    return (_selector(index, n) @ flat).reshape((n,) + values.shape[1:])


def _damp(B, C, cam_fixed, cam_valid, pt_valid, lam):
    """LM damping (additive, keeps the blocks PD); fixed and invalid cameras
    and invalid points get a huge one."""
    big = torch.full_like(lam, 1e12)
    eye6 = torch.eye(6, dtype=B.dtype, device=B.device)
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    cam_damp = torch.where(cam_fixed | ~cam_valid, big, lam)
    pt_damp = torch.where(pt_valid, lam, big)
    return (B + cam_damp[:, None, None] * eye6,
            C + pt_damp[:, None, None] * eye3 + 1e-6 * eye3)


def _build_blocks(prob, r, Jc, Jp, w, lam):
    """Per-camera B blocks, per-point C blocks (damped), gradient halves."""
    C_, P_ = prob.num_cams, prob.num_points
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    B = _segment_sum(torch.einsum("oki,okj->oij", Jc, wJc), oc, C_)
    C = _segment_sum(torch.einsum("oki,okj->oij", Jp, wJp), op, P_)
    v = _segment_sum(torch.einsum("oki,ok->oi", wJc, r), oc, C_)
    wg = _segment_sum(torch.einsum("oki,ok->oi", wJp, r), op, P_)
    B, C = _damp(B, C, prob.cam_fixed, prob.cam_valid, prob.pt_valid, _as_scalar(lam, B))
    return B, C, v, wg


def _as_scalar(x, like):
    """x as a 0-d tensor of like's dtype on its device (a tensor as it is,
    a number by a fill: no copy from the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=like.dtype, device=like.device)
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _schur_matvec(x, prob, B, C, Jc, Jp, w):
    """S x = B x - Jc^T W Jp C^-1 Jp^T W Jc x, all per observation."""
    oc, op = prob.obs_cam.long(), prob.obs_pt.long()
    Bx = torch.einsum("cij,cj->ci", B, x)
    t = torch.einsum("okj,oj->ok", Jc, x[oc]) * w[:, None]
    u = _segment_sum(torch.einsum("oki,ok->oi", Jp, t), op, prob.num_points)
    y = schur.cinv_apply(C, u)
    s = torch.einsum("oki,oi->ok", Jp, y[op]) * w[:, None]
    return Bx - _segment_sum(torch.einsum("oki,ok->oi", Jc, s), oc, prob.num_cams)


def _guard(d):
    """A CG denominator kept away from 0."""
    return torch.where(d.abs() < 1e-20, torch.full_like(d, 1e-20), d)


def _pcg(matvec: Callable, b, Minv, iters: int, tol: float):
    """Preconditioned conjugate gradients on the reduced camera system, a
    fixed number of iterations. Returns (x, the last residual norm)."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = torch.einsum("cij,cj->ci", Minv, r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / _guard(torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("cij,cj->ci", Minv, r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / _guard(rz)) * p
        rz = rz_new
    # breakdown guard: float32 PCG can diverge on ill-conditioned reduced
    # systems (small damping); a non-finite solution becomes a zero step,
    # which the LM accept test rejects and retries with more damping
    good = torch.isfinite(torch.sum(x * x))
    return torch.where(good, x, torch.zeros_like(x)), torch.sqrt(torch.sum(r * r))


def _solve_reduced(matvec, rhs, B, solver, pcg_iters, pcg_tol):
    """dc [C, 6] of S dc = rhs and the PCG residual norm (0 for "dense")."""
    if solver == "pcg":
        Minv = torch.linalg.inv_ex(B).inverse  # block-Jacobi preconditioner
        return _pcg(matvec, rhs, Minv, pcg_iters, pcg_tol)
    # dense reduced system (small C): S column by column
    n = rhs.numel()
    eye = torch.eye(n, dtype=rhs.dtype, device=rhs.device)
    S = torch.stack([matvec(e.reshape(rhs.shape)).reshape(-1) for e in eye], dim=-1)
    dc = torch.linalg.solve_ex(S.T, rhs.reshape(-1)).result.reshape(rhs.shape)
    return dc, torch.zeros((), dtype=rhs.dtype, device=rhs.device)


def _retract(cam_pose, dc, cam_fixed):
    new_cam = geometry.se3_compose(cam_pose, geometry.se3_exp(dc))
    return torch.where(cam_fixed[:, None], cam_pose, new_cam)


def ba_cost(camera, prob: BAProblem, huber_delta: float) -> torch.Tensor:
    cam, pt = _obs_operands(prob)
    zero = torch.zeros(9, dtype=cam.dtype, device=cam.device)
    r = _project_residual(camera, zero, cam, pt, prob.obs_uv)
    return _huber_cost(r, prob.obs_valid, huber_delta)


# ---------------------------------------------------------------------------
# Point-major padded path (graph.BAProblemPacked): per-point aggregations are
# dense sums over axis 1
# ---------------------------------------------------------------------------


def linearize_packed(camera, packed, huber_delta: float):
    """`linearize` over the [Lm, K] table, batched over (point, slot)."""
    cam = packed.cam_pose[packed.p_cam.long()]              # [Lm, K, 7]
    return _linearize_at(camera, cam, packed.points[:, None, :], packed.p_uv, packed.p_valid,
                         huber_delta)


def _build_blocks_packed(packed, r, Jc, Jp, w, lam):
    C_, P_, K = packed.num_cams, packed.num_points, packed.k_max
    wJc = Jc * w[..., None, None]
    wJp = Jp * w[..., None, None]
    cam_flat = packed.p_cam.reshape(-1).long()
    B = _segment_sum(torch.einsum("lkdi,lkdj->lkij", Jc, wJc).reshape(P_ * K, 6, 6), cam_flat, C_)
    v = _segment_sum(torch.einsum("lkdi,lkd->lki", wJc, r).reshape(P_ * K, 6), cam_flat, C_)
    C = torch.einsum("lkdi,lkdj->lij", Jp, wJp)
    wg = torch.einsum("lkdi,lkd->li", wJp, r)
    B, C = _damp(B, C, packed.cam_fixed, packed.cam_valid, packed.pt_valid, _as_scalar(lam, B))
    return B, C, v, wg


def _back_project(Jc, Jp, w, y):
    """Jc^T W Jp y per slot: y [L, 3] -> [L, K, 6]."""
    s = torch.einsum("lkdi,li->lkd", Jp, y) * w[..., None]
    return torch.einsum("lkdi,lkd->lki", Jc, s)


def _forward_project(Jc, Jp, w, xg):
    """Jp^T W Jc x summed per point: xg [L, K, 6] -> [L, 3]."""
    t = torch.einsum("lkdj,lkj->lkd", Jc, xg) * w[..., None]
    return torch.einsum("lkdi,lkd->li", Jp, t)


def _schur_matvec_packed(x, packed, B, C, Jc, Jp, w):
    """S x with dense per-point reductions."""
    p_cam = packed.p_cam.long()
    Bx = torch.einsum("cij,cj->ci", B, x)
    y = schur.cinv_apply(C, _forward_project(Jc, Jp, w, x[p_cam]))
    back = _back_project(Jc, Jp, w, y)
    return Bx - _segment_sum(back.reshape(-1, 6), p_cam.reshape(-1), packed.num_cams)


def ba_cost_packed(camera, packed, huber_delta: float) -> torch.Tensor:
    cam = packed.cam_pose[packed.p_cam.long()]
    q = geometry.se3_apply_inverse(cam, packed.points[:, None, :])
    r = _residual(camera, packed.p_uv, camera.project(q))
    return _huber_cost(r, packed.p_valid, huber_delta)


def optimize_ba(
    camera,
    prob,
    iters: int = 10,
    lam: float = 1e-4,
    pcg_iters: int = 50,
    pcg_tol: float = 1e-6,
    huber_delta: float = 2.0,
    solver: str = "pcg",
    step_clamp: tuple = (10.0, 50.0),
    pose_edges=None,
    capture=None,
) -> BAResult:
    """Levenberg-damped Gauss-Newton with Schur elimination of the landmark
    blocks.

    Takes a `BAProblem` (packed here into the bucketed layout; pack once
    with `graph.pack_buckets` and pass the `BAProblemBuckets` when the same
    problem is solved repeatedly), a `BAProblemBuckets`, or a
    `BAProblemPacked`. The result's problem has the input's type, with the
    updated poses and points. `pose_edges` fuses relative-pose edges into a
    bucketed solve (the padded layout ignores them, as the reference's does).

    `capture` picks the program: None captures on CUDA tensors and runs
    eagerly on CPU ones; True runs the LM iteration through
    `captured_solver(device)` (a CUDA graph on the card, its buffer rules
    eagerly on the CPU); False is the eager twin; a `CapturedBA` solves
    through that one."""
    out_prob = None
    if isinstance(prob, BAProblem):
        packed = graph_mod.pack_buckets(prob)
        out_prob = prob
    else:
        packed = prob
    layout = "buckets" if isinstance(packed, graph_mod.BAProblemBuckets) else "packed"
    solver_ = _solver(capture, packed.cam_pose.device)
    run = _solve_eager if solver_ is None else solver_.solve
    cam_pose, points, costs, pcg_res = run(
        camera, packed, layout, iters, lam, pose_edges, huber_delta=huber_delta, solver=solver,
        pcg_iters=pcg_iters, pcg_tol=pcg_tol, step_clamp=step_clamp)
    problem = (out_prob if out_prob is not None else packed).replace(cam_pose=cam_pose,
                                                                      points=points)
    return BAResult(problem=problem, costs=costs, pcg_residuals=pcg_res)


# ---------------------------------------------------------------------------
# Bucketed point-major path (graph.BAProblemBuckets): per-point work is dense
# within each [Lb, Kb] bucket; no scatter in the matvec
# ---------------------------------------------------------------------------


def _selector(index, n):
    """0/1 matrix [n, N] with a one at (index[k], k): `sel @ rows` is the
    segment sum of the rows by index, summed in a fixed order."""
    rows = torch.arange(n, device=index.device)
    return (rows[:, None] == index[None, :]).to(torch.float32)


def _gather(table, flat_index, shape):
    """table[p_cam] for a [C, D] table: [*shape, D]."""
    return table.index_select(0, flat_index).reshape(*shape, table.shape[-1])


def _cost_buckets(camera, bk, cam_pose, points, huber_delta, flat_cam, pt_idx):
    total = torch.zeros((), dtype=points.dtype, device=points.device)
    for fc, pi, p_cam, p_uv, p_valid in zip(flat_cam, pt_idx, bk.p_cam, bk.p_uv, bk.p_valid):
        cam = _gather(cam_pose, fc, p_cam.shape)
        q = geometry.se3_apply_inverse(cam, points.index_select(0, pi)[:, None, :])
        r = _residual(camera, p_uv, camera.project(q))
        total = total + _huber_cost(r, p_valid, huber_delta)
    return total


def _bucket_constants(bk, pose_edges=None) -> dict:
    """The constants of a bucketed solve, built once per solve outside the
    iteration: the gather indices and the segment-sum selectors depend on
    the observation graph alone; the identities and the damping of locked
    cameras are made here so that the iteration copies nothing from the
    host. With pose edges (edge_ij [E, 2], edge_rel [E, 7], edge_info
    [E, 6], edge_valid [E]): the edges' endpoints, their selectors and the
    information folded with validity."""
    dev = bk.cam_pose.device
    C_ = bk.num_cams
    flat_cam = tuple(p_cam.reshape(-1).long() for p_cam in bk.p_cam)
    const = {"flat_cam": flat_cam,
             "selectors": tuple(_selector(fc, C_) for fc in flat_cam),
             "pt_idx": tuple(p.long() for p in bk.pt_idx),
             "cam_locked": bk.cam_fixed | ~bk.cam_valid,
             "eye6": torch.eye(6, device=dev), "eye3": torch.eye(3, device=dev),
             "big": torch.full((), 1e12, device=dev)}
    if pose_edges is not None:
        pe_ij, pe_rel, pe_info, pe_valid = pose_edges
        ii, jj = pe_ij[:, 0].long(), pe_ij[:, 1].long()
        const.update(ii=ii, jj=jj, sel_i=_selector(ii, C_), sel_j=_selector(jj, C_),
                     we=pe_info * pe_valid[:, None], pe_rel=pe_rel,
                     zero12=torch.zeros(12, device=dev))
    return const


def _bucket_iteration(camera, huber_delta: float, solver: str, pcg_iters: int, pcg_tol: float,
                      step_clamp: tuple):
    """One LM iteration of the bucketed solver, the body of the reference's
    `lax.scan`: fn(state, x) -> (new state, (cost, pcg residual)) with
    state = (cam_pose [C, 7], points [Lm, 3], lam 0-d) and x = {"prob": the
    `BAProblemBuckets`, "const": `_bucket_constants`}. The cost is the
    achieved one: a rejected candidate's cost, which may be non-finite, is
    not the state the solver returns."""

    def iteration(state, x):
        cam_pose, points, lam_t = state
        bk, k = x["prob"], x["const"]
        C_ = bk.num_cams
        flat_cam, selectors, pt_idx = k["flat_cam"], k["selectors"], k["pt_idx"]
        eye3, big = k["eye3"], k["big"]
        edges = "we" in k

        # Pose-graph fusion (graph-constrained BA): relative-pose edges of the
        # keyframe graph (odometry chain + verified loop closures) enter the
        # same normal equations as the reprojection terms: camera-camera 6x6
        # blocks on B's diagonal plus off-diagonal couplings applied inside
        # the reduced-system matvec. Pure-reprojection BA fits per-keyframe
        # landmark measurements that embed the filter's drifted relative
        # geometry, and descends its cost while undoing the loop-closure
        # corrections; the fused problem keeps the graph's global anchoring.
        def total_cost(cam_pose, points):
            pe_cost = 0.0
            if edges:
                r = posegraph.edge_residual(cam_pose[k["ii"]], cam_pose[k["jj"]], k["pe_rel"])
                pe_cost = 0.5 * torch.sum(k["we"] * r * r)
            return (_cost_buckets(camera, bk, cam_pose, points, huber_delta, flat_cam, pt_idx)
                    + pe_cost)

        B = torch.where(k["cam_locked"], big, lam_t)[:, None, None] * k["eye6"]
        v = torch.zeros(C_, 6, device=cam_pose.device)
        Hij = None
        if edges:
            ii, jj, sel_i, sel_j, we = k["ii"], k["jj"], k["sel_i"], k["sel_j"], k["we"]
            pi, pj = cam_pose[ii], cam_pose[jj]
            r_e = posegraph.edge_residual(pi, pj, k["pe_rel"])
            J = torch.func.jacfwd(posegraph._edge_residual_perturbed)(k["zero12"], pi, pj,
                                                                        k["pe_rel"])
            Ji, Jj = J[..., :6], J[..., 6:]
            JiW = Ji * we[:, :, None]
            JjW = Jj * we[:, :, None]
            B = B + (sel_i @ torch.einsum("eki,ekj->eij", Ji, JiW).reshape(-1, 36)
                     + sel_j @ torch.einsum("eki,ekj->eij", Jj, JjW).reshape(-1, 36)
                     ).reshape(C_, 6, 6)
            v = v + (sel_i @ torch.einsum("eki,ek->ei", Ji, we * r_e)
                     + sel_j @ torch.einsum("eki,ek->ei", Jj, we * r_e))
            Hij = torch.einsum("eki,ekj->eij", Ji, JjW)
        per_bucket = []
        for fc, sel, pi, row_valid, p_cam, p_uv, p_valid in zip(
            flat_cam, selectors, pt_idx, bk.row_valid, bk.p_cam, bk.p_uv, bk.p_valid
        ):
            cam = _gather(cam_pose, fc, p_cam.shape)
            pts_b = points.index_select(0, pi)
            r, Jc, Jp, w = _linearize_at(camera, cam, pts_b[:, None, :], p_uv, p_valid,
                                         huber_delta)
            wJc = Jc * w[..., None, None]
            wJp = Jp * w[..., None, None]
            N = p_cam.numel()
            B = B + (sel @ torch.einsum("lkdi,lkdj->lkij", Jc, wJc).reshape(N, 36)
                     ).reshape(C_, 6, 6)
            v = v + sel @ torch.einsum("lkdi,lkd->lki", wJc, r).reshape(N, 6)
            Cb = torch.einsum("lkdi,lkdj->lij", Jp, wJp)
            pv_b = bk.pt_valid.index_select(0, pi) & row_valid
            pt_damp = torch.where(pv_b, lam_t, big)
            Cb = Cb + pt_damp[:, None, None] * eye3 + 1e-6 * eye3
            wg = torch.einsum("lkdi,lkd->li", wJp, r)
            per_bucket.append((fc, sel, pi, row_valid, p_cam.shape, Jc, Jp, w, Cb, wg))

        def matvec(x):
            acc = torch.einsum("cij,cj->ci", B, x)
            if Hij is not None:
                acc = acc + (sel_i @ torch.einsum("eij,ej->ei", Hij, x[jj])
                             + sel_j @ torch.einsum("eji,ej->ei", Hij, x[ii]))
            for fc, sel, _, _, shape, Jc, Jp, w, Cb, _ in per_bucket:
                u = _forward_project(Jc, Jp, w, _gather(x, fc, shape))
                y = schur.cinv_apply(Cb, u)
                acc = acc - sel @ _back_project(Jc, Jp, w, y).reshape(-1, 6)
            return acc

        rhs = -v
        for fc, sel, _, _, shape, Jc, Jp, w, Cb, wg in per_bucket:
            y = schur.cinv_apply(Cb, wg)
            rhs = rhs + sel @ _back_project(Jc, Jp, w, y).reshape(-1, 6)

        dc, pcg_res = _solve_reduced(matvec, rhs, B, solver, pcg_iters, pcg_tol)

        # Trust-region sanitization: an ill-conditioned reduced system can
        # return inf/NaN or astronomically long steps (se3_exp(inf) would
        # poison the candidate and LM would reject every iteration forever).
        # Non-finite components become zero. The clamp radii guard against
        # pathological magnitudes only: LM's own accept test is the trust
        # region for finite steps.
        clamp_c, clamp_p = step_clamp
        dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
        dc = dc * torch.clamp(
            clamp_c / (torch.linalg.vector_norm(dc, dim=1, keepdim=True) + 1e-12), max=1.0)

        # back-substitute: dp = -C^-1 (w_g + E^T dc). Every point sits in one
        # row of one bucket and padding rows (point 0, masked) add +0.0 to a
        # sum that starts at +0.0, so the atomic index_add_ on the card gives
        # the same bits in any order.
        dp_full = torch.zeros_like(points)
        for fc, _, pi, row_valid, shape, Jc, Jp, w, Cb, wg in per_bucket:
            Etdc = _forward_project(Jc, Jp, w, _gather(dc, fc, shape))
            dp = -schur.cinv_apply(Cb, wg + Etdc)
            dp_full.index_add_(0, pi, torch.where(row_valid[:, None], dp, torch.zeros_like(dp)))
        dp_full = torch.where(torch.isfinite(dp_full), dp_full, torch.zeros_like(dp_full))
        dp_full = dp_full * torch.clamp(
            clamp_p / (torch.linalg.vector_norm(dp_full, dim=1, keepdim=True) + 1e-12), max=1.0)

        new_cam = _retract(cam_pose, dc, bk.cam_fixed)
        new_points = points + dp_full * bk.pt_valid[:, None]

        old_cost = total_cost(cam_pose, points)
        new_cost = total_cost(new_cam, new_points)
        accept = torch.isfinite(new_cost) & (new_cost < old_cost)
        return ((torch.where(accept, new_cam, cam_pose), torch.where(accept, new_points, points),
                 torch.where(accept, lam_t * 0.5, lam_t * 4.0)),
                (torch.where(accept, new_cost, old_cost), pcg_res))

    return iteration


def _lm_iteration(step):
    """One LM iteration of the padded and the observation-major path, from
    `step(p, lam) -> (dc, dp, cost function of a problem, pcg residual)`:
    fn(state, x) -> (new state, (cost, pcg residual)) with state as in
    `_bucket_iteration` and x = {"prob": the problem}. The candidate's cost
    is what is reported."""

    def iteration(state, x):
        cam_pose, points, lam_t = state
        prob = x["prob"]
        p = prob.replace(cam_pose=cam_pose, points=points)
        dc, dp, cost_of, pcg_res = step(p, lam_t)
        new_cam = _retract(cam_pose, dc, prob.cam_fixed)
        new_points = points + dp * prob.pt_valid[:, None]
        new_cost = cost_of(p.replace(cam_pose=new_cam, points=new_points))
        accept = new_cost < cost_of(p)
        return ((torch.where(accept, new_cam, cam_pose), torch.where(accept, new_points, points),
                 torch.where(accept, lam_t * 0.5, lam_t * 4.0)), (new_cost, pcg_res))

    return iteration


def _packed_step(camera, huber_delta, solver, pcg_iters, pcg_tol):
    def step(p, lam_t):
        r, Jc, Jp, w = linearize_packed(camera, p, huber_delta)
        B, C, v, wg = _build_blocks_packed(p, r, Jc, Jp, w, lam_t)
        p_cam = p.p_cam.long()
        # rhs = -v + E C^-1 w_g
        back = _back_project(Jc, Jp, w, schur.cinv_apply(C, wg))
        rhs = -v + _segment_sum(back.reshape(-1, 6), p_cam.reshape(-1), p.num_cams)
        matvec = lambda x: _schur_matvec_packed(x, p, B, C, Jc, Jp, w)  # noqa: E731
        dc, pcg_res = _solve_reduced(matvec, rhs, B, solver, pcg_iters, pcg_tol)
        # back-substitute points: dp = -C^-1 (w_g + E^T dc)
        dp = -schur.cinv_apply(C, wg + _forward_project(Jc, Jp, w, dc[p_cam]))
        return dc, dp, lambda q: ba_cost_packed(camera, q, huber_delta), pcg_res

    return step


def _obsmajor_step(camera, huber_delta, solver, pcg_iters, pcg_tol):
    def step(p, lam_t):
        oc, op = p.obs_cam.long(), p.obs_pt.long()
        r, Jc, Jp, w = linearize(camera, p, huber_delta)
        B, C, v, wg = _build_blocks(p, r, Jc, Jp, w, lam_t)
        # rhs = -v + E C^-1 w_g
        s = torch.einsum("oki,oi->ok", Jp, schur.cinv_apply(C, wg)[op]) * w[:, None]
        rhs = -v + _segment_sum(torch.einsum("oki,ok->oi", Jc, s), oc, p.num_cams)
        matvec = lambda x: _schur_matvec(x, p, B, C, Jc, Jp, w)  # noqa: E731
        dc, pcg_res = _solve_reduced(matvec, rhs, B, solver, pcg_iters, pcg_tol)
        # back-substitute points: dp = -C^-1 (w_g + E^T dc)
        t = torch.einsum("okj,oj->ok", Jc, dc[oc]) * w[:, None]
        Etdc = _segment_sum(torch.einsum("oki,ok->oi", Jp, t), op, p.num_points)
        dp = -schur.cinv_apply(C, wg + Etdc)
        return dc, dp, lambda q: ba_cost(camera, q, huber_delta), pcg_res

    return step


def _program(camera, prob, layout, pose_edges, *, huber_delta, solver, pcg_iters, pcg_tol,
             step_clamp=(10.0, 50.0)):
    """(iteration function, its inputs x) of one solve of `prob` in
    `layout` ("buckets", "packed" or "obsmajor")."""
    kw = dict(huber_delta=huber_delta, solver=solver, pcg_iters=pcg_iters, pcg_tol=pcg_tol)
    if layout == "buckets":
        return (_bucket_iteration(camera, step_clamp=step_clamp, **kw),
                {"prob": prob, "const": _bucket_constants(prob, pose_edges)})
    make = _packed_step if layout == "packed" else _obsmajor_step
    return _lm_iteration(make(camera, **kw)), {"prob": prob}


def _lam(lam, like):
    """The initial damping as a 0-d tensor on the problem's device, made by
    a fill (no copy from the host)."""
    return torch.full((), float(lam), dtype=like.dtype, device=like.device)


@torch.no_grad()
def _solve_eager(camera, prob, layout, iters, lam, pose_edges=None, **kw):
    """The eager LM loop (the twin of `CapturedBA`): (poses, points, costs
    [iters], pcg residuals [iters])."""
    with trace.span("ba.solve", rid=next(_SOLVE_IDS)):
        fn, x = _program(camera, prob, layout, pose_edges, **kw)
        state = (prob.cam_pose, prob.points, _lam(lam, prob.points))
        costs, residuals = [], []
        for _ in range(iters):
            state, (cost, pcg_res) = fn(state, x)
            costs.append(cost)
            residuals.append(pcg_res)
        return state[0], state[1], torch.stack(costs), torch.stack(residuals)


def _leaf_key(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in captured.leaves(tree))


class CapturedBA:
    """`optimize_ba` (and `optimize_ba_obsmajor`) with the LM iteration as
    one `captured.CapturedStep` per shape key: on the card a CUDA graph of
    the reference's `lax.scan` body (`_bucket_iteration`, `_lm_iteration`),
    run eagerly as the warm-up at the first iteration of a key's first
    solve, captured at its second and replayed from then on; `graph=False`
    runs the same buffer rules eagerly. The key holds the layout, the
    camera, the shapes of every problem buffer and constant (the bucket
    tables, C, P and E, the number of pose edges, or none), the solver,
    `pcg_iters`, `pcg_tol`, `huber_delta` and `step_clamp`; the initial
    damping is written into the state at each solve. A solve writes the
    problem and its constants into the step's static inputs, calls the step
    `iters` times, copies each iteration's cost and PCG residual out and
    returns the caller's own copies of the final poses and points. The
    steps draw on `pool` (a shared graph pool) when given."""

    def __init__(self, *, graph: bool, pool=None):
        self.graph, self.pool = graph, pool
        self.steps: dict[tuple, captured.CapturedStep] = {}

    @torch.no_grad()
    def solve(self, camera, prob, layout, iters, lam, pose_edges=None, *, huber_delta, solver,
              pcg_iters, pcg_tol, step_clamp=(10.0, 50.0)):
        """(poses, points, costs [iters], pcg residuals [iters]) of `prob`
        in `layout`, as `_solve_eager` returns them."""
        with trace.span("ba.solve", rid=next(_SOLVE_IDS)):
            kw = dict(huber_delta=float(huber_delta), solver=solver, pcg_iters=int(pcg_iters),
                      pcg_tol=float(pcg_tol), step_clamp=tuple(float(c) for c in step_clamp))
            fn, x = _program(camera, prob, layout, pose_edges, **kw)
            key = (layout, camera, _leaf_key(x), tuple(sorted(kw.items())))
            step = self.steps.get(key)
            if step is None:
                state = (prob.cam_pose.clone(), prob.points.clone(), _lam(lam, prob.points))
                step = self.steps[key] = captured.CapturedStep(fn, state, captured.clone(x),
                                                               graph=self.graph, pool=self.pool)
            captured.copy_into(step.inputs, x)
            captured.copy_into(step.state, (prob.cam_pose, prob.points, _lam(lam, prob.points)))
            costs, residuals = [], []
            for _ in range(iters):
                step()
                cost, pcg_res = step.take()
                costs.append(cost)
                residuals.append(pcg_res)
            return (step.state[0].clone(), step.state[1].clone(), torch.stack(costs),
                    torch.stack(residuals))


# CapturedBA of direct `optimize_ba` callers, one per device, each with a
# graph pool of its own (`SLAMSystem` keeps its own on the system's pool)
_SOLVERS: dict = {}


def captured_solver(device) -> CapturedBA:
    """The CapturedBA that `optimize_ba(capture=True)` uses on `device`."""
    device = torch.device(device)
    if device not in _SOLVERS:
        graph = device.type == "cuda"
        _SOLVERS[device] = CapturedBA(graph=graph,
                                      pool=torch.cuda.graph_pool_handle() if graph else None)
    return _SOLVERS[device]


def _solver(capture, device):
    """None for the eager twin, else the CapturedBA to solve with."""
    if capture is None:
        capture = device.type == "cuda"
    if isinstance(capture, CapturedBA):
        return capture
    return captured_solver(device) if capture else None


@torch.no_grad()
def optimize_ba_obsmajor(
    camera,
    prob: BAProblem,
    iters: int = 10,
    lam: float = 1e-4,
    pcg_iters: int = 50,
    pcg_tol: float = 1e-6,
    huber_delta: float = 2.0,
    solver: str = "pcg",
    capture=None,
) -> BAResult:
    """Observation-major optimizer on a raw BAProblem: the semantics oracle
    of the tests (its per-point and per-camera sums are `_segment_sum`
    selector products, [points, observations] dense: an oracle's sizes).
    `capture` as in `optimize_ba`."""
    kw = dict(huber_delta=huber_delta, solver=solver, pcg_iters=pcg_iters, pcg_tol=pcg_tol)
    solver_ = _solver(capture, prob.cam_pose.device)
    run = _solve_eager if solver_ is None else solver_.solve
    cam_pose, points, costs, res = run(camera, prob, "obsmajor", iters, lam, **kw)
    return BAResult(prob.replace(cam_pose=cam_pose, points=points), costs, res)


def window_problem(prob: BAProblem, window: int) -> BAProblem:
    """Sliding-window (local) BA: only the newest `window` cameras stay
    free; older cameras are frozen (cam_fixed), and their observations still
    constrain the shared points. Shapes are unchanged."""
    C = prob.num_cams
    idx = torch.arange(C, device=prob.cam_valid.device)
    last_valid = torch.where(prob.cam_valid, idx, torch.full_like(idx, -1)).max()
    return prob.replace(cam_fixed=prob.cam_fixed | (idx <= (last_valid - window)))
