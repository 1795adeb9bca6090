"""Distributed bundle adjustment: point blocks sharded over ranks (port of
`parakeet_slam_tpu.dist.dist_ba`).

1-D form (`shard_problem`, `optimize_ba_distributed`): the points are cut
into contiguous blocks over the mesh's `dcn` ranks, and each rank owns its
block and every observation of those points. The 3x3 point blocks C, their
inverse applies (`kernels.schur.cinv_apply`: the `apply_cinv` kernel on the
card) and the point back-substitution are rank-local. The cameras are small
and replicated: B, v, E C^-1 w_g and every PCG matvec's E C^-1 E^T x
partial are summed over the ranks by `all_reduce`, so every rank solves the
same reduced camera system and takes the same LM branch.

2-D form (`shard_problem_2d`, `optimize_ba_distributed_2d`): cameras over
`dcn`, points over `ici`; rank (i, j) owns the observations of camera block
i and point block j. The point-side sums are reduced over `dcn` only, the
camera-side sums over both axes.

On CUDA tensors an LM iteration runs as one CUDA graph with every
all-reduce inside (`CapturedDistBA`, the reference's `jax.jit` of the
`shard_map`ped `lax.scan`), in the pattern of `backend/ba.CapturedBA`: one
`captured.CapturedStep` per key (the layout, the shapes, `huber_delta`,
`pcg_iters`, the camera and the mesh), run eagerly at the first iteration
of a key's first solve, captured at its second and replayed from then on.
Its state is (cam_pose, this rank's points, the damping), its outputs the
candidate's cost and the accept flag. What comes from the host (the
rank's slice of the problem, the segment plans, the damping's start and the
constants) is made once per solve, outside the graph, and written into the
step's static inputs. `capture=False` is the eager twin, the same iteration
in a Python loop; `capture=True` on the CPU (gloo) runs the captured path's
buffer rules eagerly. The steps live with the mesh (`Mesh.programs`), so
that they are freed with its groups.

The Jacobians are the closed forms of `backend/ba._linearize_at`. Every
segment sum (per camera, per point) is the sorted segment sum of
`backend/posegraph` (`_segment_plan` once per solve, `_segment_sum` per
use): a fixed order on every device, memory linear in the observations, no
atomics. The LM semantics are the reference's: damping on B's and C's
diagonals, a fixed number of PCG iterations with the block-Jacobi
preconditioner, the candidate accepted when its cost is lower, the
candidate's cost reported.
"""

from __future__ import annotations

import numpy as np
import torch

from parakeet_slam_tpu_torch.backend import ba as ba_mod
from parakeet_slam_tpu_torch.backend import posegraph
from parakeet_slam_tpu_torch.backend.graph import BAProblem
from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.mesh import BOTH_AXES, MAP_AXIS, PARTICLE_AXIS, Mesh
from parakeet_slam_tpu_torch.filter import captured
from parakeet_slam_tpu_torch.kernels import schur


def _host(prob: BAProblem):
    return {f: getattr(prob, f).detach().cpu().numpy()
            for f in ("points", "pt_valid", "obs_cam", "obs_pt", "obs_uv", "obs_valid")}


def _replace(prob: BAProblem, points, pt_valid, cam, pt, uv, valid) -> BAProblem:
    dev = prob.points.device
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return prob.replace(points=T(points), pt_valid=T(pt_valid), obs_cam=T(cam), obs_pt=T(pt),
                        obs_uv=T(uv), obs_valid=T(valid))


def shard_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Host-side re-layout: points padded to a multiple of n_shards and cut
    into contiguous blocks; observations grouped by their point's block and
    padded so that every block owns the same count (invalid padding rows
    point into their own block). Block s then holds points [s*Lp, (s+1)*Lp)
    and observation rows [s*O_l, (s+1)*O_l)."""
    S = n_shards
    h = _host(prob)
    Lm = prob.num_points
    Lp = (Lm + S - 1) // S
    points = np.pad(h["points"], ((0, Lp * S - Lm), (0, 0)))
    pt_valid = np.pad(h["pt_valid"], (0, Lp * S - Lm))
    obs_valid = h["obs_valid"]
    shard_of = h["obs_pt"] // Lp
    O_l = int(max(np.bincount(shard_of[obs_valid], minlength=S).max(), 1))
    uv_dim = h["obs_uv"].shape[1]
    cam = np.zeros((S, O_l), np.int32)
    pt = np.zeros((S, O_l), np.int32)
    uv = np.zeros((S, O_l, uv_dim), h["obs_uv"].dtype)
    valid = np.zeros((S, O_l), bool)
    for s in range(S):
        rows = np.where(obs_valid & (shard_of == s))[0]
        n = len(rows)
        cam[s, :n], pt[s, :n], uv[s, :n], valid[s, :n] = (
            h["obs_cam"][rows], h["obs_pt"][rows], h["obs_uv"][rows], True)
        pt[s, n:] = s * Lp  # padding rows point inside this block
    return _replace(prob, points, pt_valid, cam.reshape(-1), pt.reshape(-1),
                    uv.reshape(S * O_l, uv_dim), valid.reshape(-1))


def shard_problem_2d(prob: BAProblem, n_cam_shards: int, n_pt_shards: int) -> BAProblem:
    """Host-side re-layout for the 2-D solver: points padded to a multiple
    of n_pt_shards and cut into contiguous blocks over `ici`; observations
    bucketed by (camera block, point block) with equal padded counts, laid
    out [Sc * Sp * O_l] so that bucket (i, j) is row block i * Sp + j."""
    Sc, Sp = n_cam_shards, n_pt_shards
    h = _host(prob)
    Lm, C_ = prob.num_points, prob.num_cams
    Lp = (Lm + Sp - 1) // Sp
    cam_chunk = (C_ + Sc - 1) // Sc
    points = np.pad(h["points"], ((0, Lp * Sp - Lm), (0, 0)))
    pt_valid = np.pad(h["pt_valid"], (0, Lp * Sp - Lm))
    obs_valid = h["obs_valid"]
    cam_shard = h["obs_cam"] // cam_chunk
    pt_shard = h["obs_pt"] // Lp
    rows_of = {(i, j): np.where(obs_valid & (cam_shard == i) & (pt_shard == j))[0]
               for i in range(Sc) for j in range(Sp)}
    O_l = int(max(max(len(r) for r in rows_of.values()), 1))
    uv_dim = h["obs_uv"].shape[1]
    cam = np.zeros((Sc, Sp, O_l), np.int32)
    pt = np.zeros((Sc, Sp, O_l), np.int32)
    uv = np.zeros((Sc, Sp, O_l, uv_dim), h["obs_uv"].dtype)
    valid = np.zeros((Sc, Sp, O_l), bool)
    for (i, j), rows in rows_of.items():
        n = len(rows)
        cam[i, j, :n], pt[i, j, :n], uv[i, j, :n], valid[i, j, :n] = (
            h["obs_cam"][rows], h["obs_pt"][rows], h["obs_uv"][rows], True)
        cam[i, j, n:] = min(i * cam_chunk, C_ - 1)
        pt[i, j, n:] = j * Lp
    return _replace(prob, points, pt_valid, cam.reshape(-1), pt.reshape(-1),
                    uv.reshape(Sc * Sp * O_l, uv_dim), valid.reshape(-1))


def _segment_sum(plan, values):
    """Per-key sums of values [N, ...] over a `posegraph._segment_plan`."""
    n = plan[3]
    flat = values.reshape(values.shape[0], -1)
    return posegraph._segment_sum(plan, flat).reshape((n,) + values.shape[1:])


def _cost(camera, cam_pose, points_l, oc, pl, uv, valid, huber_delta):
    q = geometry.se3_apply_inverse(cam_pose[oc], points_l[pl])
    r = ba_mod._residual(camera, uv, camera.project(q))
    return ba_mod._huber_cost(r, valid, huber_delta)


def _setup(prob: BAProblem, mesh: Mesh, *, pt_axis, obs_block: int, n_obs_blocks: int, lam):
    """This rank's start of a solve, made once per solve outside the graph:
    (the LM state (cam_pose, this block's points, the damping), the
    iteration's inputs). `pt_axis` shards the points, `obs_block` of
    `n_obs_blocks` is this rank's observation rows."""
    ps = mesh_mod.RowSharding(mesh, pt_axis)
    rows = ps.rows(prob.num_points)
    Lp = rows.stop - rows.start
    O_l = prob.num_obs // n_obs_blocks
    orows = slice(obs_block * O_l, (obs_block + 1) * O_l)
    oc = prob.obs_cam[orows].long()
    pl = prob.obs_pt[orows].long() - rows.start  # rebased into this block
    points = prob.points[rows]
    dev = points.device
    x = {"oc": oc, "pl": pl, "uv": prob.obs_uv[orows], "valid": prob.obs_valid[orows],
         "pt_valid": prob.pt_valid[rows], "cam_fixed": prob.cam_fixed,
         "cam_plan": posegraph._segment_plan(oc, prob.num_cams),
         "pt_plan": posegraph._segment_plan(pl, Lp),
         "eye6": torch.eye(6, device=dev), "eye3": torch.eye(3, device=dev),
         "big": torch.tensor(1e12, device=dev)}
    state = (prob.cam_pose, points, torch.tensor(float(lam), device=dev))
    return state, x


def _iteration(camera, mesh: Mesh, *, cam_sum, pt_sum, pcg_iters, huber_delta):
    """One LM iteration on this rank's block, fn(state, x) -> (new state,
    (the candidate's cost, accept)) over `_setup`'s state and inputs; the
    camera-side sums (and the cost) are reduced over `cam_sum`, the
    point-side sums over `pt_sum` (None: rank-local)."""

    def R_cam(t):
        return mesh_mod.all_reduce_sum(t, mesh, cam_sum)

    def R_pt(t):
        return t if pt_sum is None else mesh_mod.all_reduce_sum(t, mesh, pt_sum)

    def iteration(state, x):
        cam_pose, points, lam_t = state
        oc, pl, uv, valid = x["oc"], x["pl"], x["uv"], x["valid"]
        cam_plan, pt_plan, eye6, eye3 = x["cam_plan"], x["pt_plan"], x["eye6"], x["eye3"]

        def cost_of(cp, pts):
            return R_cam(_cost(camera, cp, pts, oc, pl, uv, valid, huber_delta))

        r, Jc, Jp, w = ba_mod._linearize_at(camera, cam_pose[oc], points[pl], uv, valid,
                                            huber_delta)
        wJc = Jc * w[:, None, None]
        wJp = Jp * w[:, None, None]
        B = R_cam(_segment_sum(cam_plan, torch.einsum("oki,okj->oij", Jc, wJc)))
        v = R_cam(_segment_sum(cam_plan, torch.einsum("oki,ok->oi", wJc, r)))
        Cb = R_pt(_segment_sum(pt_plan, torch.einsum("oki,okj->oij", Jp, wJp)))
        wg = R_pt(_segment_sum(pt_plan, torch.einsum("oki,ok->oi", wJp, r)))
        B = B + torch.where(x["cam_fixed"], x["big"], lam_t)[:, None, None] * eye6
        Cb = Cb + torch.where(x["pt_valid"], lam_t, x["big"])[:, None, None] * eye3 + 1e-6 * eye3

        def back(y):
            """Jc^T W Jp y summed per camera over all blocks."""
            s = torch.einsum("oki,oi->ok", Jp, y[pl]) * w[:, None]
            return R_cam(_segment_sum(cam_plan, torch.einsum("oki,ok->oi", Jc, s)))

        def forward(xc):
            """Jp^T W Jc x summed per point of this block."""
            t = torch.einsum("okj,oj->ok", Jc, xc[oc]) * w[:, None]
            return R_pt(_segment_sum(pt_plan, torch.einsum("oki,ok->oi", Jp, t)))

        def matvec(xc):
            return torch.einsum("cij,cj->ci", B, xc) - back(schur.cinv_apply(Cb, forward(xc)))

        rhs = -v + back(schur.cinv_apply(Cb, wg))
        dc, _ = ba_mod._pcg(matvec, rhs, torch.linalg.inv_ex(B).inverse, pcg_iters, 1e-6)
        dp = -schur.cinv_apply(Cb, wg + forward(dc))

        new_cam = ba_mod._retract(cam_pose, dc, x["cam_fixed"])
        new_pts = points + dp * x["pt_valid"][:, None]
        old_cost = cost_of(cam_pose, points)
        new_cost = cost_of(new_cam, new_pts)
        accept = new_cost < old_cost
        return ((torch.where(accept, new_cam, cam_pose), torch.where(accept, new_pts, points),
                 torch.where(accept, lam_t * 0.5, lam_t * 4.0)), (new_cost, accept))

    return iteration


class CapturedDistBA:
    """The distributed LM iteration as one `captured.CapturedStep` per key
    (the module docstring): on the card a CUDA graph with the all-reduces
    inside, `graph=False` the same buffer rules eagerly. A solve writes its
    state and inputs into the step's static buffers, calls the step `iters`
    times, copies each candidate's cost out and returns the caller's own
    copies of the final poses and points."""

    def __init__(self, *, graph: bool, pool=None):
        self.graph, self.pool = graph, pool
        self.steps: dict[tuple, captured.CapturedStep] = {}

    @torch.no_grad()
    def solve(self, key, fn, state, x, iters: int):
        step = self.steps.get(key)
        if step is None:
            step = self.steps[key] = captured.CapturedStep(
                fn, captured.clone(state), captured.clone(x), graph=self.graph, pool=self.pool)
        captured.copy_into(step.inputs, x)
        captured.copy_into(step.state, state)
        costs = []
        for _ in range(iters):
            step()
            costs.append(step.take()[0])
        return step.state[0].clone(), step.state[1].clone(), torch.stack(costs)


def captured_solver(mesh: Mesh, device) -> CapturedDistBA:
    """The CapturedDistBA that `capture=True` uses on `device` over `mesh`,
    kept with the mesh (`Mesh.programs`) and its graph pool."""
    device = torch.device(device)
    key = ("dist_ba", device)
    if key not in mesh.programs:
        graph = device.type == "cuda"
        mesh.programs[key] = CapturedDistBA(
            graph=graph, pool=torch.cuda.graph_pool_handle() if graph else None)
    return mesh.programs[key]


def _solver(capture, mesh: Mesh, device):
    """None for the eager twin, else the CapturedDistBA to solve with
    (`capture` as in `backend/ba.optimize_ba`: None means captured on CUDA)."""
    if capture is None:
        capture = device.type == "cuda"
    if isinstance(capture, CapturedDistBA):
        return capture
    return captured_solver(mesh, device) if capture else None


@torch.no_grad()
def _solve(camera, prob: BAProblem, mesh: Mesh, *, layout, pt_axis, obs_block: int,
           n_obs_blocks: int, cam_sum, pt_sum, iters, lam, pcg_iters, huber_delta, capture):
    """The LM loop on this rank's block (`_setup`, `_iteration`), eager or
    through the captured step of its key; the points of every block are
    gathered at the end."""
    state, x = _setup(prob, mesh, pt_axis=pt_axis, obs_block=obs_block,
                      n_obs_blocks=n_obs_blocks, lam=lam)
    fn = _iteration(camera, mesh, cam_sum=cam_sum, pt_sum=pt_sum, pcg_iters=int(pcg_iters),
                    huber_delta=float(huber_delta))
    solver = _solver(capture, mesh, prob.points.device)
    if solver is None:
        costs = []
        for _ in range(iters):
            state, (cost, _) = fn(state, x)
            costs.append(cost)
        cam_pose, points, costs = state[0], state[1], torch.stack(costs)
    else:
        key = (layout, camera, ba_mod._leaf_key(x), float(huber_delta), int(pcg_iters), mesh)
        cam_pose, points, costs = solver.solve(key, fn, state, x, iters)
    points_all = mesh_mod.all_gather_rows(points, mesh, pt_axis)
    return prob.replace(cam_pose=cam_pose, points=points_all), costs


def optimize_ba_distributed(camera, prob: BAProblem, mesh: Mesh, iters: int = 10,
                            lam: float = 1e-4, pcg_iters: int = 50, huber_delta: float = 2.0,
                            capture=None):
    """Distributed LM-damped Gauss-Newton over the mesh's `dcn` ranks.
    `prob` comes from `shard_problem` with n_shards = the `dcn` size, and is
    the same on every rank. Returns (the problem with the refined camera
    poses and all points, costs [iters]), the same on every rank of a `dcn`
    line. Per iteration: an all-reduce each for B, v, E C^-1 w_g and the
    two costs, and one per PCG matvec. `capture`: None for one CUDA graph an
    iteration on CUDA tensors and the eager loop on CPU tensors, False for
    the eager loop, True for the captured path (its buffer rules, eager, on
    the CPU), or a `CapturedDistBA` to solve with."""
    k = mesh.axis_index(MAP_AXIS)
    return _solve(camera, prob, mesh, layout="1d", pt_axis=MAP_AXIS, obs_block=k,
                  n_obs_blocks=mesh.axis_size(MAP_AXIS), cam_sum=MAP_AXIS, pt_sum=None,
                  iters=iters, lam=lam, pcg_iters=pcg_iters, huber_delta=huber_delta,
                  capture=capture)


def optimize_ba_distributed_2d(camera, prob: BAProblem, mesh: Mesh, iters: int = 10,
                               lam: float = 1e-4, pcg_iters: int = 50, huber_delta: float = 2.0,
                               capture=None):
    """2-D sharded LM-damped Gauss-Newton; `prob` comes from
    `shard_problem_2d` with (n_cam_shards, n_pt_shards) = the mesh's (dcn,
    ici) sizes. Per iteration: both-axes all-reduces for B, v, E C^-1 w_g,
    the costs and each PCG matvec's camera side, `dcn` all-reduces for the
    point blocks, their gradient, each matvec's point side and the
    back-substitution. `capture` as in `optimize_ba_distributed`."""
    return _solve(camera, prob, mesh, layout="2d", pt_axis=PARTICLE_AXIS,
                  obs_block=mesh.axis_index(BOTH_AXES), n_obs_blocks=mesh.axis_size(BOTH_AXES),
                  cam_sum=BOTH_AXES, pt_sum=MAP_AXIS, iters=iters, lam=lam,
                  pcg_iters=pcg_iters, huber_delta=huber_delta, capture=capture)
