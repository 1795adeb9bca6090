"""The port's bundle adjustment against the JAX package on the CPU: the
landmark-block inverse-apply (twin vs the XLA twin and vs the Pallas kernel
in interpret mode), the BA problem layouts, the closed-form linearization,
the normal-equation blocks and Schur matvecs, and the three optimizers
(bucketed with both solvers and with fused pose edges, padded, and
observation-major). Inputs are numpy arrays handed to both packages; on the
CPU the port's `cinv_apply` runs its plain twin.

Tolerances: the inverse-apply rtol=1e-5, atol=1e-6 (one rounding per
operation in both; XLA may contract a multiply-add). Layout tables equal.
Residuals and Jacobians rtol=1e-4, atol=1e-4 (pixels). Blocks and matvecs
1e-5 of the largest entry (sums of up to 32 terms in another order). Solver
runs: the same accept/reject sequence, costs within rtol=1e-3, final poses
and points within 1e-3 (m, rad). The runs are kept to the iterations that
descend clearly: once LM has converged, candidate and current cost differ
by rounding alone and the accept decision is a coin toss in either package
(the fixtures run 8-10 iterations in the JAX tests; here 3 or 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.backend import ba as j_ba
from parakeet_slam_tpu.backend import graph as j_graph
from parakeet_slam_tpu.core import geometry as j_geo
from parakeet_slam_tpu.frontend import camera as j_cam
from parakeet_slam_tpu.kernels import schur as j_schur
from parakeet_slam_tpu_torch.backend import ba as t_ba
from parakeet_slam_tpu_torch.backend import graph as t_graph
from parakeet_slam_tpu_torch.eval import kernel_inputs
from parakeet_slam_tpu_torch.frontend import camera as t_cam
from parakeet_slam_tpu_torch.kernels import schur as t_schur
from tests.test_backend import _make_ba_problem

CAMS = {
    "pinhole": ("Pinhole", (500.0, 480.0, 320.0, 240.0, 640, 480)),
    "stereo": ("Stereo", (500.0, 480.0, 320.0, 240.0, 0.12, 640, 480)),
    "equirect": ("Equirect", (1024, 512)),
}
FIELDS = ("cam_pose", "cam_valid", "points", "pt_valid", "obs_cam", "obs_pt", "obs_uv",
          "obs_valid", "cam_fixed")


def _cameras(name):
    cls, args = CAMS[name]
    return getattr(j_cam, cls)(*args), getattr(t_cam, cls)(*args)


def _to_jax(arrays):
    return j_graph.BAProblem(**{f: jnp.asarray(arrays[f]) for f in FIELDS})


def _pair(arrays):
    """(JAX problem, port problem on the CPU) holding the same arrays."""
    return _to_jax(arrays), t_graph.ba_problem_from_numpy(arrays, device="cpu")


def _from_jax(prob):
    arrays = {f: np.asarray(getattr(prob, f)) for f in FIELDS}
    return prob, t_graph.ba_problem_from_numpy(arrays, device="cpu")


def _random_problem(seed, name, n_cams=4, n_pts=32, drop_every=0, point_noise=0.0):
    """tests/test_ba_jacobians.py's problem, drawn with numpy: every camera
    sees every point; pinhole and stereo points sit in front of the cameras."""
    rng = np.random.default_rng(seed)
    jcam, _ = _cameras(name)
    pts = rng.uniform(-3.0, 3.0, (n_pts, 3))
    if name != "equirect":
        pts = pts + np.array([0.0, 0.0, 10.0])
    q = np.array([0.0, 0.0, 0.0, 1.0]) + 0.05 * rng.normal(size=(n_cams, 4))
    poses = np.concatenate([0.3 * rng.normal(size=(n_cams, 3)),
                            q / np.linalg.norm(q, axis=1, keepdims=True)], axis=1)
    poses, pts = poses.astype(np.float32), pts.astype(np.float32)
    obs_cam = np.tile(np.arange(n_cams, dtype=np.int32), n_pts)
    obs_pt = np.repeat(np.arange(n_pts, dtype=np.int32), n_cams)
    uv = np.asarray(jcam.project(j_geo.se3_apply_inverse(jnp.asarray(poses[obs_cam]),
                                                         jnp.asarray(pts[obs_pt]))))
    uv = uv + 0.3 * rng.normal(size=uv.shape)
    valid = np.ones(len(obs_cam), bool)
    if drop_every:
        valid[::drop_every] = False
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    pts = pts + point_noise * rng.normal(size=pts.shape).astype(np.float32)
    return dict(cam_pose=poses, cam_valid=np.ones(n_cams, bool), points=pts.astype(np.float32),
                pt_valid=np.ones(n_pts, bool), obs_cam=obs_cam, obs_pt=obs_pt,
                obs_uv=uv.astype(np.float32), obs_valid=valid, cam_fixed=fixed)


def _skewed_problem(seed, n_cams=6, n_pts=700, n_obs=2600):
    """A problem with skewed covisibility (most points seen a few times, a
    few seen up to 40 times: three buckets), invalid observations, an
    unobserved and an invalid point, and a few gross outliers."""
    rng = np.random.default_rng(seed)
    arr = _random_problem(seed, "pinhole", n_cams=n_cams, n_pts=n_pts)
    w = np.ones(n_pts)
    w[:20] = 40.0
    w[20:120] = 6.0
    obs_pt = rng.choice(n_pts, n_obs, p=w / w.sum()).astype(np.int32)
    obs_pt[obs_pt == n_pts - 1] = 0                        # the last point: unobserved
    obs_cam = rng.integers(0, n_cams, n_obs).astype(np.int32)
    jcam, _ = _cameras("pinhole")
    uv = np.asarray(jcam.project(j_geo.se3_apply_inverse(
        jnp.asarray(arr["cam_pose"][obs_cam]), jnp.asarray(arr["points"][obs_pt]))))
    uv = uv + 0.3 * rng.normal(size=uv.shape)
    uv[::97] += 400.0                                      # gross outliers
    pt_valid = np.ones(n_pts, bool)
    pt_valid[5] = False
    arr.update(obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv.astype(np.float32),
               obs_valid=rng.random(n_obs) > 0.1, pt_valid=pt_valid)
    return arr


def _close(a, b, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _scaled_close(t, j, atol=1e-5):
    j = np.asarray(j)
    scale = float(np.abs(j).max()) + 1.0
    np.testing.assert_allclose(t.numpy() / scale, j / scale, atol=atol)


# -- the landmark-block inverse-apply -----------------------------------------


def _blocks(n, seed):
    """SPD blocks, with (from n >= 100) one block whose |det| < eps, one
    negative definite block and one with a 1e12 damping diagonal."""
    C, u = kernel_inputs.schur_blocks(n, seed)
    if n >= 100:
        C[3] = 1e-5 * np.eye(3, dtype=np.float32)          # det 1e-15 < eps
        C[7] = -C[7]
        C[11] = C[11] + 1e12 * np.eye(3, dtype=np.float32)  # an invalid point's block
    return C, u


@pytest.mark.parametrize("n", [1, 100, 1024, 5000])
def test_apply_cinv_reference_matches_jax(n):
    C, u = _blocks(n, seed=n)
    y = t_schur.apply_cinv_reference(torch.as_tensor(C), torch.as_tensor(u)).numpy()
    y_xla = np.asarray(j_schur.apply_cinv_xla(jnp.asarray(C), jnp.asarray(u)))
    y_pal = np.asarray(j_schur.apply_cinv(jnp.asarray(C), jnp.asarray(u), interpret=True))
    assert y.shape == (n, 3) and np.isfinite(y).all()
    _close(y, y_xla, rtol=1e-5, atol=1e-6)
    _close(y, y_pal, rtol=1e-5, atol=1e-6)
    if n >= 100:
        # the clamp drops det's sign and divides by eps: y = 1e-10 u / 1e-12
        _close(y[3], 100.0 * u[3], rtol=1e-4)
        sane = np.ones(n, bool)
        sane[[3, 11]] = False
        y_np = np.linalg.solve(C[sane].astype(np.float64), u[sane, :, None].astype(np.float64))
        _close(y[sane], y_np[..., 0], rtol=1e-3, atol=1e-4)


def test_cinv_apply_dispatches_by_device():
    """On CPU tensors the solver's dispatch runs the twin and counts no
    launch; the kernel entry point refuses them; shapes are checked."""
    C, u = (torch.as_tensor(a) for a in _blocks(100, seed=0))
    before = t_schur.apply_cinv.launches
    assert torch.equal(t_schur.cinv_apply(C, u), t_schur.apply_cinv_reference(C, u))
    # any strides: the twin indexes, as the kernel does
    wide = torch.zeros(100, 4, 5)
    wide[:, :3, :3] = C
    assert torch.equal(t_schur.cinv_apply(wide[:, :3, :3], u), t_schur.cinv_apply(C, u))
    assert t_schur.apply_cinv.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        t_schur.apply_cinv(C, u)
    with pytest.raises(ValueError, match="expected"):
        t_schur.cinv_apply(C, u[:50])


# -- the problem and its layouts ----------------------------------------------


def test_ba_problem_numpy_round_trip():
    arr = _skewed_problem(0)
    jprob, tprob = _pair(arr)
    back = t_graph.ba_problem_to_numpy(tprob)
    for f in FIELDS:
        assert back[f].dtype == arr[f].dtype, f
        np.testing.assert_array_equal(back[f], arr[f])
    # from an object with the fields (a JAX BAProblem), and back into one
    again = t_graph.ba_problem_to_numpy(t_graph.ba_problem_from_numpy(jprob, device="cpu"))
    for f in FIELDS:
        np.testing.assert_array_equal(again[f], np.asarray(getattr(_to_jax(back), f)))
    assert (tprob.num_cams, tprob.num_points, tprob.num_obs) == (6, 700, 2600)
    made = t_graph.make_ba_problem(arr["cam_pose"], arr["points"], arr["obs_cam"], arr["obs_pt"],
                                   arr["obs_uv"], device="cpu")
    ref = j_graph.make_ba_problem(*(jnp.asarray(arr[f]) for f in (
        "cam_pose", "points", "obs_cam", "obs_pt", "obs_uv")))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(made, f).numpy(), np.asarray(getattr(ref, f)))
    with pytest.raises(TypeError):
        t_graph.make_ba_problem(arr["cam_pose"], arr["points"], arr["obs_cam"], arr["obs_pt"],
                                arr["obs_uv"])


def _assert_tables_equal(t, j, fields):
    for f in fields:
        a, b = getattr(t, f), getattr(j, f)
        if isinstance(a, tuple):
            assert len(a) == len(b), f
            for x, y in zip(a, b):
                assert x.numpy().dtype == np.asarray(y).dtype, f
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


PACKED_FIELDS = ("cam_pose", "cam_valid", "points", "pt_valid", "cam_fixed", "p_cam", "p_uv",
                 "p_valid")
BUCKET_FIELDS = PACKED_FIELDS[:5] + ("pt_idx", "row_valid", "p_cam", "p_uv", "p_valid")


@pytest.mark.parametrize("what", ["pack_problem", "pack_buckets", "cap_obs_per_point",
                                  "gate_outlier_obs", "window_problem"])
def test_layouts_equal_jax(what):
    jprob, tprob = _pair(_skewed_problem(1))
    jcam, tcam = _cameras("pinhole")
    if what == "pack_problem":
        _assert_tables_equal(t_graph.pack_problem(tprob), j_graph.pack_problem(jprob),
                             PACKED_FIELDS)
        _assert_tables_equal(t_graph.pack_problem(tprob, k_max=64),
                             j_graph.pack_problem(jprob, k_max=64), PACKED_FIELDS)
        with pytest.raises(ValueError, match="k_max"):
            t_graph.pack_problem(tprob, k_max=4)
    elif what == "pack_buckets":
        tb, jb = t_graph.pack_buckets(tprob), j_graph.pack_buckets(jprob)
        assert len(tb.pt_idx) >= 3 and [p.shape[1] for p in tb.p_cam] == sorted(
            p.shape[1] for p in tb.p_cam)
        assert all(p.shape[0] % 512 == 0 for p in tb.pt_idx)
        _assert_tables_equal(tb, jb, BUCKET_FIELDS)
        none = tprob.replace(obs_valid=torch.zeros_like(tprob.obs_valid))
        _assert_tables_equal(t_graph.pack_buckets(none), j_graph.pack_buckets(
            jprob.replace(obs_valid=jnp.zeros_like(jprob.obs_valid))), BUCKET_FIELDS)
    elif what == "cap_obs_per_point":
        for k in (0, 3, 8):
            got = t_graph.cap_obs_per_point(tprob, k)
            np.testing.assert_array_equal(
                got.obs_valid.numpy(), np.asarray(j_graph.cap_obs_per_point(jprob, k).obs_valid))
        assert int(got.obs_valid.sum()) < int(tprob.obs_valid.sum())
    elif what == "gate_outlier_obs":
        got = t_graph.gate_outlier_obs(tcam, tprob, 200.0)
        ref = j_graph.gate_outlier_obs(jcam, jprob, 200.0)
        np.testing.assert_array_equal(got.obs_valid.numpy(), np.asarray(ref.obs_valid))
        assert 0 < int(got.obs_valid.sum()) < int(tprob.obs_valid.sum())
    else:
        tv = tprob.replace(cam_valid=torch.tensor([True] * 5 + [False]))
        jv = jprob.replace(cam_valid=jnp.asarray([True] * 5 + [False]))
        got = t_ba.window_problem(tv, 2)
        np.testing.assert_array_equal(got.cam_fixed.numpy(),
                                      np.asarray(j_ba.window_problem(jv, 2).cam_fixed))
        assert got.cam_fixed.tolist() == [True, True, True, False, False, False]


# -- linearization, blocks, matvecs -------------------------------------------


@pytest.mark.parametrize("name", list(CAMS))
def test_linearize_matches_jax_and_forward_mode(name):
    jcam, tcam = _cameras(name)
    jprob, tprob = _pair(_random_problem(3, name, drop_every=5))
    ref = j_ba.linearize(jcam, jprob, 50.0)
    got = t_ba.linearize(tcam, tprob, 50.0)
    oracle = t_ba.linearize_ad(tcam, tprob, 50.0)
    j_oracle = j_ba.linearize_ad(jcam, jprob, 50.0)
    for g, r, o, jo, what in zip(got, ref, oracle, j_oracle, ("r", "Jc", "Jp", "w")):
        assert g.shape == tuple(r.shape) and g.dtype == torch.float32, what
        _close(g, r, rtol=1e-4, atol=1e-4)
        _close(o, jo, rtol=1e-4, atol=2e-3)
        # closed form vs forward mode: the JAX test's own bar
        _close(g, o, rtol=2e-4, atol=2e-3)
    assert not got[3][::5].any() and got[3].max() <= 1.0
    _close(t_ba.ba_cost(tcam, tprob, 2.0), j_ba.ba_cost(jcam, jprob, 2.0), rtol=1e-5)


def test_blocks_and_matvecs_match_jax():
    """Observation-major and padded point-major normal-equation blocks and
    Schur matvecs against JAX's, and against each other (the bucketed
    matvec is a closure of the solver in both packages: the dense solver
    below builds its S from it)."""
    jcam, tcam = _cameras("pinhole")
    jprob, tprob = _pair(_random_problem(11, "pinhole", n_pts=40, drop_every=7,
                                         point_noise=0.05))
    jpk, tpk = j_graph.pack_problem(jprob), t_graph.pack_problem(tprob)
    x = np.random.default_rng(1).normal(size=(4, 6)).astype(np.float32)
    lam = 1e-4
    with jax.default_matmul_precision("highest"):
        j_lin = j_ba.linearize(jcam, jprob, 50.0)
        j_blk = j_ba._build_blocks(jprob, *j_lin, jnp.float32(lam))
        j_mv = j_ba._schur_matvec(jnp.asarray(x), jprob, j_blk[0], j_blk[1], *j_lin[1:])
        j_linp = j_ba.linearize_packed(jcam, jpk, 50.0)
        j_blkp = j_ba._build_blocks_packed(jpk, *j_linp, jnp.float32(lam))
        j_mvp = j_ba._schur_matvec_packed(jnp.asarray(x), jpk, j_blkp[0], j_blkp[1], *j_linp[1:])
    t_lin = t_ba.linearize(tcam, tprob, 50.0)
    t_blk = t_ba._build_blocks(tprob, *t_lin, lam)
    t_mv = t_ba._schur_matvec(torch.as_tensor(x), tprob, t_blk[0], t_blk[1], *t_lin[1:])
    t_linp = t_ba.linearize_packed(tcam, tpk, 50.0)
    t_blkp = t_ba._build_blocks_packed(tpk, *t_linp, torch.tensor(lam))
    t_mvp = t_ba._schur_matvec_packed(torch.as_tensor(x), tpk, t_blkp[0], t_blkp[1], *t_linp[1:])
    for g, r in zip(t_linp, j_linp):
        _close(g, r, rtol=1e-4, atol=1e-4)
    for t, j in zip(t_blk + (t_mv,) + t_blkp + (t_mvp,), j_blk + (j_mv,) + j_blkp + (j_mvp,)):
        _scaled_close(t, j)
    # padded equals observation-major, as tests/test_ba_jacobians.py holds it
    for a, b in zip(t_blk + (t_mv,), t_blkp + (t_mvp,)):
        _scaled_close(a, b.numpy())
    _close(t_ba.ba_cost_packed(tcam, tpk, 50.0), j_ba.ba_cost_packed(jcam, jpk, 50.0), rtol=1e-5)


def test_pcg_matches_jax_and_guards_breakdown():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(18, 18)).astype(np.float32)
    S = A @ A.T + 18 * np.eye(18, dtype=np.float32)
    b = rng.normal(size=(3, 6)).astype(np.float32)
    Minv = np.stack([np.linalg.inv(S[i:i + 6, i:i + 6]) for i in (0, 6, 12)]).astype(np.float32)
    jx, jres = j_ba._pcg(lambda v: (jnp.asarray(S) @ v.reshape(-1)).reshape(3, 6), jnp.asarray(b),
                         jnp.asarray(Minv), 12, 1e-6)
    tx, tres = t_ba._pcg(lambda v: (torch.as_tensor(S) @ v.reshape(-1)).reshape(3, 6),
                         torch.as_tensor(b), torch.as_tensor(Minv), 12, 1e-6)
    _close(tx, jx, atol=1e-5)
    _close(tx.reshape(-1), np.linalg.solve(S, b.reshape(-1)), atol=1e-4)
    assert float(tres) < 1e-3 and abs(float(tres) - float(jres)) < 1e-4
    # a non-finite solution becomes the zero step
    bad, _ = t_ba._pcg(lambda v: v * float("nan"), torch.as_tensor(b), torch.as_tensor(Minv),
                       3, 1e-6)
    assert not bad.any()


# -- the optimizers -----------------------------------------------------------


def _accepts(costs, first):
    """The accept sequence of a bucketed run (it reports the achieved cost):
    an iteration was accepted iff the cost fell."""
    prev = np.concatenate([[first], np.asarray(costs)[:-1]])
    return (np.asarray(costs) < prev).tolist()


def _assert_same_run(t_res, j_res, first_cost=None):
    _close(t_res.costs, j_res.costs, rtol=1e-3)
    # the last PCG residual norm of a float32 run is rounding noise: finite
    # and the same shape, not the same digits
    assert t_res.pcg_residuals.shape == tuple(j_res.pcg_residuals.shape)
    assert torch.isfinite(t_res.pcg_residuals).all()
    if first_cost is not None:
        assert _accepts(t_res.costs.numpy(), first_cost) == _accepts(j_res.costs, first_cost)
    a, b = t_res.problem.cam_pose.numpy(), np.asarray(j_res.problem.cam_pose)
    _close(a[:, :3], b[:, :3], atol=1e-3)
    sign = np.sign(np.sum(a[:, 3:] * b[:, 3:], axis=1, keepdims=True))
    _close(a[:, 3:], sign * b[:, 3:], atol=1e-3)
    _close(t_res.problem.points, j_res.problem.points, atol=1e-3)


def _ring_edges(gt_poses, info):
    C = gt_poses.shape[0]
    ij = np.stack([np.arange(C - 1), np.arange(1, C)], 1).astype(np.int32)
    rel = np.array(jax.vmap(j_geo.se3_between)(gt_poses[:-1], gt_poses[1:]))
    return ij, rel, np.full((C - 1, 6), info, np.float32), np.ones(C - 1, bool)


@pytest.mark.parametrize("solver", ["pcg", "dense"])
def test_optimize_ba_bucketed_matches_jax(solver):
    """tests/test_backend.py's recover-the-ring fixture (8 iterations there;
    3 here, all of which descend clearly in both packages)."""
    jcam, prob, gt_poses, _ = _make_ba_problem(jax.random.PRNGKey(3))
    jprob, tprob = _from_jax(prob)
    tcam = t_cam.Pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
    kw = dict(iters=3, pcg_iters=60, solver=solver, huber_delta=50.0)
    j_res = j_ba.optimize_ba(jcam, jprob, **kw)
    t_res = t_ba.optimize_ba(tcam, tprob, **kw)
    assert isinstance(t_res.problem, t_graph.BAProblem)
    if solver == "dense":
        assert not t_res.pcg_residuals.any()
    first = float(j_ba.ba_cost(jcam, jprob, 50.0))
    _assert_same_run(t_res, j_res, first)
    assert _accepts(t_res.costs.numpy(), first)[:2] == [True, True]
    # the reference's functional bounds
    assert float(t_ba.ba_cost(tcam, t_res.problem, 2.0)) < 0.05 * float(t_ba.ba_cost(tcam, tprob, 2.0))
    err = np.linalg.norm(t_res.problem.cam_pose[:, :3].numpy() - np.asarray(gt_poses[:, :3]), axis=1)
    assert err.max() < 0.05, err.max()
    # a packed-once BAProblemBuckets comes back as one
    bk = t_graph.pack_buckets(tprob)
    again = t_ba.optimize_ba(tcam, bk, **kw)
    assert isinstance(again.problem, t_graph.BAProblemBuckets)
    assert torch.equal(again.problem.cam_pose, t_res.problem.cam_pose)
    assert torch.equal(again.costs, t_res.costs)


def test_optimize_ba_huber_matches_jax():
    """The outlier fixture: 5% of the observations shifted by 150 px, Huber
    width 3 px (3 iterations: the fourth is a near-tie)."""
    jcam, prob, gt_poses, _ = _make_ba_problem(jax.random.PRNGKey(4))
    uv = np.array(prob.obs_uv)
    bad = np.random.default_rng(9).choice(len(uv), max(1, len(uv) // 20), replace=False)
    uv[bad] += 150.0
    jprob, tprob = _from_jax(prob.replace(obs_uv=jnp.asarray(uv)))
    tcam = t_cam.Pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
    kw = dict(iters=3, pcg_iters=60, huber_delta=3.0)
    _assert_same_run(t_ba.optimize_ba(tcam, tprob, **kw), j_ba.optimize_ba(jcam, jprob, **kw),
                     float(j_ba.ba_cost(jcam, jprob, 3.0)))


@pytest.mark.parametrize("info,shift_cam", [(100.0, None), (1e4, 3)],
                         ids=["gt_consistent_edges", "edges_pin_a_corrupted_camera"])
def test_pose_edge_fusion_matches_jax(info, shift_cam):
    """Graph-constrained BA on tests/test_backend.py's two fixtures: relative
    pose edges between consecutive cameras enter the reduced system."""
    jcam, prob, gt_poses, _ = _make_ba_problem(jax.random.PRNGKey(5 if shift_cam is None else 6))
    if shift_cam is not None:
        uv = np.array(prob.obs_uv)
        uv[np.asarray(prob.obs_cam) == shift_cam] += 40.0
        prob = prob.replace(obs_uv=jnp.asarray(uv))
    jprob, tprob = _from_jax(prob)
    tcam = t_cam.Pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
    edges = _ring_edges(gt_poses, info)
    kw = dict(iters=4, pcg_iters=60, solver="pcg")
    j_res = j_ba.optimize_ba(jcam, jprob, pose_edges=tuple(jnp.asarray(e) for e in edges), **kw)
    t_res = t_ba.optimize_ba(tcam, tprob, pose_edges=tuple(torch.as_tensor(e) for e in edges),
                             **kw)
    _assert_same_run(t_res, j_res)
    assert float(t_res.costs[-1]) < float(t_res.costs[0])
    err = np.linalg.norm(t_res.problem.cam_pose[:, :3].numpy() - np.asarray(gt_poses[:, :3]), axis=1)
    assert (err.max() if shift_cam is None else err[shift_cam]) < 0.1


@pytest.mark.parametrize("path", ["packed", "obsmajor"])
def test_optimize_ba_other_layouts_match_jax(path):
    """The padded point-major and the observation-major optimizer on
    tests/test_ba_jacobians.py's problem; both report the candidate's cost.
    That problem fixes one camera, so the monocular scale is a free gauge:
    the first step along it is rounding noise (JAX's own three layouts then
    differ by 0.4% in the first cost). Here the second camera is fixed too,
    which pins the scale, as tests/test_backend.py's fixture does."""
    jcam, tcam = _cameras("pinhole")
    arr = _random_problem(11, "pinhole", n_pts=40, drop_every=7, point_noise=0.05)
    arr["cam_fixed"][1] = True
    jprob, tprob = _pair(arr)
    kw = dict(iters=3, pcg_iters=25, huber_delta=50.0)
    if path == "packed":
        j_res = j_ba.optimize_ba(jcam, j_graph.pack_problem(jprob), **kw)
        t_res = t_ba.optimize_ba(tcam, t_graph.pack_problem(tprob), **kw)
        assert isinstance(t_res.problem, t_graph.BAProblemPacked)
    else:
        j_res = j_ba.optimize_ba_obsmajor(jcam, jprob, **kw)
        t_res = t_ba.optimize_ba_obsmajor(tcam, tprob, **kw)
    _assert_same_run(t_res, j_res)
    c0 = float(t_ba.ba_cost(tcam, tprob, 50.0))
    assert float(t_res.costs[-1]) < 0.8 * c0


def test_optimize_ba_skewed_buckets_match_jax():
    """Three buckets, padding rows, invalid observations and points, fixed
    and invalid cameras, gated outliers and capped views: the production
    sequence of `run_ba` on one problem."""
    arr = _skewed_problem(2)
    arr["cam_valid"][5] = False
    jcam, tcam = _cameras("pinhole")
    jprob, tprob = _pair(arr)
    jprob = j_graph.cap_obs_per_point(j_graph.gate_outlier_obs(jcam, jprob, 200.0), 16)
    tprob = t_graph.cap_obs_per_point(t_graph.gate_outlier_obs(tcam, tprob, 200.0), 16)
    kw = dict(iters=3, lam=1.0, pcg_iters=30, huber_delta=2.0, step_clamp=(10.0, 50.0))
    j_res = j_ba.optimize_ba(jcam, jprob, **kw)
    t_res = t_ba.optimize_ba(tcam, tprob, **kw)
    _assert_same_run(t_res, j_res, float(j_ba.ba_cost(jcam, jprob, 2.0)))
    assert np.isfinite(t_res.problem.points.numpy()).all()
    # fixed and invalid cameras, and invalid points, do not move
    assert torch.equal(t_res.problem.cam_pose[0], tprob.cam_pose[0])
    assert torch.equal(t_res.problem.points[5], tprob.points[5])
    _close(t_res.problem.cam_pose[5], tprob.cam_pose[5], atol=1e-6)


def test_bench_problem_generator():
    """The bench's BA problem and Schur blocks: shapes, determinism, and a
    cost near the noise floor (0.5 px on 2 axes: 0.25 per observation)."""
    arr = kernel_inputs.ba_bench_problem(C=4, Pts=300, obs_per_cam=50, seed=1)
    again = kernel_inputs.ba_bench_problem(C=4, Pts=300, obs_per_cam=50, seed=1)
    for k, v in arr.items():
        np.testing.assert_array_equal(v, again[k])
    prob = t_graph.make_ba_problem(**arr, device="cpu")
    assert (prob.num_cams, prob.num_points, prob.num_obs) == (4, 300, 200)
    assert float(prob.cam_pose[-1, 0]) == 5.0 and prob.cam_fixed.tolist() == [True] + [False] * 3
    cost = float(t_ba.ba_cost(t_cam.Pinhole(*kernel_inputs.BA_BENCH_CAMERA), prob, 50.0))
    assert 0.1 * 200 < cost < 0.5 * 200, cost
    C, u = kernel_inputs.schur_blocks(64)
    assert C.shape == (64, 3, 3) and u.shape == (64, 3) and C.dtype == np.float32
    assert (np.linalg.eigvalsh(C) > 0).all() and np.array_equal(C, np.swapaxes(C, 1, 2))
