"""The port's distributed BA (`dist/dist_ba.py`) on tests/test_backend.py's
problem: the 1-D form at S=2 and the 2-D form on a (dcn=1, ici=2) mesh at 2
gloo ranks on the CPU, against the JAX package's distributed solvers under
`shard_map` on 2-device meshes (camera poses within atol 5e-3, the
reference's own bar in tests/test_schur_distba.py) and against the port at
world size 1 (costs within rtol 1e-4); the host re-layouts equal JAX's. The
1-D form also runs at 4 gloo ranks (S=4), held against the port's one-device
`optimize_ba` and JAX's S=4 solve, with the config-5 demo's BA rows."""

import json

import jax
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.dist import dist_ba as j_dist_ba
from parakeet_slam_tpu.dist.mesh import make_mesh as j_make_mesh
from parakeet_slam_tpu_torch.backend import ba as ba_mod
from parakeet_slam_tpu_torch.backend import posegraph
from parakeet_slam_tpu_torch.dist import dist_ba
from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from tests import torch_dist_worker as W
from tests.test_backend import _make_ba_problem

FIELDS = ("cam_pose", "cam_valid", "points", "pt_valid", "obs_cam", "obs_pt", "obs_uv",
          "obs_valid", "cam_fixed")


@pytest.fixture(scope="module")
def problem():
    cam, prob, gt_poses, _ = _make_ba_problem(jax.random.PRNGKey(11))
    inp = {"camera": np.array([cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height]),
           **{f"prob_{f}": np.asarray(getattr(prob, f)) for f in FIELDS}}
    return cam, prob, np.asarray(gt_poses), inp


@pytest.fixture(scope="module")
def run(tmp_path_factory, problem):
    out = tmp_path_factory.mktemp("torch_dist_ba")
    np.savez(out / "inputs.npz", **problem[3])
    W.spawn("ba", out)
    return [W.load(out, "ba", r) for r in (0, 1)]


@pytest.fixture(scope="module")
def run4(tmp_path_factory, problem):
    out = tmp_path_factory.mktemp("torch_dist_ba4")
    np.savez(out / "inputs.npz", **problem[3])
    W.spawn("ba4", out, world=4)
    return out, [W.load(out, "ba4", r) for r in range(4)]


def _port_one_rank(inp, two_d):
    cam, prob = W.ba_inputs(inp)
    mesh = mesh_mod.make_mesh()
    if two_d:
        return dist_ba.optimize_ba_distributed_2d(cam, dist_ba.shard_problem_2d(prob, 1, 1), mesh,
                                                  **W.BA_KW)
    return dist_ba.optimize_ba_distributed(cam, dist_ba.shard_problem(prob, 1), mesh, **W.BA_KW)


def test_1d_matches_jax_distributed(problem, run):
    cam, prob, gt, inp = problem
    jp, jc = j_dist_ba.optimize_ba_distributed(
        cam, j_dist_ba.shard_problem(prob, 2), j_make_mesh(n_devices=2, map_axis=2), **W.BA_KW)
    for g in run:  # cameras replicated, points gathered: the same on both ranks
        np.testing.assert_allclose(g["cam_1d"][:, :3], np.asarray(jp.cam_pose)[:, :3], atol=5e-3)
        np.testing.assert_allclose(g["costs_1d"], np.asarray(jc), rtol=1e-3)
        assert np.linalg.norm(g["cam_1d"][:, :3] - gt[:, :3], axis=1).max() < 0.05
    np.testing.assert_array_equal(run[0]["cam_1d"], run[1]["cam_1d"])
    np.testing.assert_array_equal(run[0]["pts_1d"], run[1]["pts_1d"])


def test_2d_matches_jax_distributed(problem, run):
    cam, prob, gt, inp = problem
    jp, jc = j_dist_ba.optimize_ba_distributed_2d(
        cam, j_dist_ba.shard_problem_2d(prob, 1, 2), j_make_mesh(n_devices=2, map_axis=1),
        **W.BA_KW)
    for g in run:
        np.testing.assert_allclose(g["cam_2d"][:, :3], np.asarray(jp.cam_pose)[:, :3], atol=5e-3)
        np.testing.assert_allclose(g["costs_2d"], np.asarray(jc), rtol=1e-3)
        assert g["costs_2d"][-1] < g["costs_2d"][0]
    np.testing.assert_array_equal(run[0]["cam_2d"], run[1]["cam_2d"])


@pytest.mark.parametrize("two_d", [False, True])
def test_captured_equals_eager_and_jax(problem, run, two_d):
    """2 ranks: `capture=True` (the captured path's buffer rules, one
    CapturedStep an LM iteration, eager on the CPU) equals `capture=False`
    bit for bit in costs, poses and points, on both ranks; its costs stay
    within the bar above (rtol 1e-3) of JAX's distributed solver."""
    cam, prob, _, _ = problem
    key = "2d" if two_d else "1d"
    if two_d:
        _, jc = j_dist_ba.optimize_ba_distributed_2d(
            cam, j_dist_ba.shard_problem_2d(prob, 1, 2), j_make_mesh(n_devices=2, map_axis=1),
            **W.BA_KW)
    else:
        _, jc = j_dist_ba.optimize_ba_distributed(
            cam, j_dist_ba.shard_problem(prob, 2), j_make_mesh(n_devices=2, map_axis=2),
            **W.BA_KW)
    for g in run:
        for what in ("cam", "pts", "costs"):
            np.testing.assert_array_equal(g[f"cap_{what}_{key}"], g[f"{what}_{key}"],
                                          err_msg=what)
        np.testing.assert_allclose(g[f"cap_costs_{key}"], np.asarray(jc), rtol=1e-3)


@pytest.mark.parametrize("two_d", [False, True])
def test_two_ranks_match_one_rank(problem, run, two_d):
    """World size 2 against the 1 x 1 mesh (no process group): costs within
    rtol 1e-4, poses within 1e-4."""
    p1, c1 = _port_one_rank(problem[3], two_d)
    key = "2d" if two_d else "1d"
    for g in run:
        np.testing.assert_allclose(g[f"costs_{key}"], c1.numpy(), rtol=1e-4)
        np.testing.assert_allclose(g[f"cam_{key}"], p1.cam_pose.numpy(), atol=1e-4)


def test_four_ranks_match_one_device_and_jax(problem, run4):
    """S=4 over 4 gloo ranks: camera positions within the reference's bar
    (atol 5e-3) of the port's one-device `optimize_ba` and of JAX's
    distributed solve at S=4 on 4 virtual devices, costs within rtol 1e-3
    of JAX's, and every rank bit-equal to rank 0."""
    cam, prob, gt, inp = problem
    _, run = run4
    tc, tp = W.ba_inputs(inp)
    one = ba_mod.optimize_ba(tc, tp, solver="pcg", **W.BA_KW).problem.cam_pose.numpy()
    jp, jc = j_dist_ba.optimize_ba_distributed(
        cam, j_dist_ba.shard_problem(prob, 4), j_make_mesh(n_devices=4, map_axis=4), **W.BA_KW)
    for g in run:
        np.testing.assert_allclose(g["cam"][:, :3], one[:, :3], atol=5e-3)
        np.testing.assert_allclose(g["cam"][:, :3], np.asarray(jp.cam_pose)[:, :3], atol=5e-3)
        np.testing.assert_allclose(g["costs"], np.asarray(jc), rtol=1e-3)
        assert np.linalg.norm(g["cam"][:, :3] - gt[:, :3], axis=1).max() < 0.05
        for k in ("cam", "pts", "costs"):
            np.testing.assert_array_equal(g[k], run[0][k], err_msg=k)


@pytest.mark.parametrize("which", ["ring", "bench"])
def test_config5_demo_ba_rows_at_four_ranks(run4, which):
    """The demo's BA rows at S = 1, 2, 4: the accepted cost replayed from the
    candidates equals the returned problem's cost; on the well-posed ring
    problem every S ends at the S=1 accepted cost (rtol 1e-4) and within
    atol 5e-3 of its cameras. (Once LM has converged an accept is a coin
    toss, so the step counts may differ by the last ones.)"""
    out, _ = run4
    rows = json.loads((out / "demo_ba_r0.json").read_text())[which]
    assert [r["map_shards"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["problem"] == which and r["accepted_steps"] >= 1
        assert np.isfinite(r["final_cost"]) and r["accepted_cost"] <= r["final_cost"] + 1e-3
        np.testing.assert_allclose(r["returned_cost"], r["accepted_cost"], rtol=1e-5)
    if which == "ring":
        assert max(r["max_cam_pos_diff_vs_1shard"] for r in rows) < 5e-3
        np.testing.assert_allclose([r["accepted_cost"] for r in rows], rows[0]["accepted_cost"],
                                   rtol=1e-4)


@pytest.mark.parametrize("S", [2, 3])
def test_shard_problem_equals_jax(problem, S):
    cam, prob, _, inp = problem
    _, t_prob = W.ba_inputs(inp)
    j = j_dist_ba.shard_problem(prob, S)
    t = dist_ba.shard_problem(t_prob, S)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


def test_shard_problem_2d_equals_jax(problem):
    cam, prob, _, inp = problem
    _, t_prob = W.ba_inputs(inp)
    j = j_dist_ba.shard_problem_2d(prob, 2, 2)
    t = dist_ba.shard_problem_2d(t_prob, 2, 2)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


def test_segment_sum_is_the_float64_sum():
    """The sorted segment sum the solver uses, on keys with gaps and long
    runs, against numpy's float64 sums."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, 3000)
    keys[keys == 7] = 8  # a key with no rows
    vals = rng.normal(size=(3000, 3, 3)).astype(np.float32)
    got = dist_ba._segment_sum(posegraph._segment_plan(torch.as_tensor(keys), 50),
                               torch.as_tensor(vals))
    want = np.zeros((50, 3, 3))
    np.add.at(want, keys, vals.astype(np.float64))
    assert got.shape == (50, 3, 3) and not got[7].any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
