"""The port's pose-graph backend against the JAX package: the graph
container (add_node / add_edge / shrink_to_active and the numpy carry
across), Horn 3D-3D alignment, and the LM pose-graph optimizer on a noisy
odometry circle with a loop edge.

Tolerances: container fields equal; Horn R and t within 1e-4 (compared on
well-conditioned correspondence sets; never U/V, whose signs are free);
optimized poses within 2e-3 of JAX's (forward-mode Jacobians and a dense
float32 solve in another order) and the cost history within rtol=2e-2 of
JAX's (costs fall by orders of magnitude, so late entries are small
differences of similar numbers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.backend import graph as j_graph
from parakeet_slam_tpu.backend import posegraph as j_pg
from parakeet_slam_tpu.core import geometry as jg
from parakeet_slam_tpu_torch.backend import graph as t_graph
from parakeet_slam_tpu_torch.backend import posegraph as t_pg
from parakeet_slam_tpu_torch.core import geometry as tg


def _circle_graph(n=16, loop=True, seed=0):
    """A drifted odometry chain around a circle (nodes from noisy odometry,
    edges the true relative poses) plus a last->first loop edge, built in
    numpy; returns the JAX and torch graphs holding the same values."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = tg.se2_to_se3(torch.tensor(np.stack([5 * np.cos(th), 5 * np.sin(th), th + np.pi / 2], 1),
                                    dtype=torch.float32))
    est = [gt[0]]
    for i in range(1, n):
        rel = tg.se3_between(gt[i - 1], gt[i])
        noisy = tg.se3_compose(rel, tg.se3_exp(torch.tensor(0.03 * rng.normal(size=6),
                                                            dtype=torch.float32)))
        est.append(tg.se3_compose(est[-1], noisy))
    info = rng.uniform(0.5, 2.0, (n, 6)).astype(np.float32)
    jgr = j_graph.make_pose_graph(max_nodes=n + 3, max_edges=2 * n)
    tgr = t_graph.make_pose_graph(n + 3, 2 * n, device="cpu")
    for p in est:
        jgr = j_graph.add_node(jgr, jnp.asarray(p.numpy()))
        tgr = t_graph.add_node(tgr, p)
    edges = [(i - 1, i, gt[i - 1], gt[i]) for i in range(1, n)]
    if loop:
        edges.append((n - 1, 0, gt[-1], gt[0]))
    for k, (i, j, a, b) in enumerate(edges):
        rel = tg.se3_between(a, b)
        jgr = j_graph.add_edge(jgr, i, j, jnp.asarray(rel.numpy()), info=jnp.asarray(info[k % n]))
        tgr = t_graph.add_edge(tgr, i, j, rel, info=torch.as_tensor(info[k % n]))
    return jgr, tgr, gt


def _assert_graph_equal(tgr, jgr):
    back = t_graph.graph_to_numpy(tgr)
    for f in ("node_valid", "edge_ij", "edge_valid", "n_nodes", "n_edges"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jgr, f)), err_msg=f)
    for f in ("poses", "edge_rel", "edge_info"):
        np.testing.assert_allclose(back[f], np.asarray(getattr(jgr, f)), atol=1e-6, err_msg=f)


def test_add_node_add_edge_match_jax():
    jgr, tgr, _ = _circle_graph(n=6)
    _assert_graph_equal(tgr, jgr)
    # capacity: appends past the end are no-ops
    jfull, tfull = j_graph.make_pose_graph(2, 1), t_graph.make_pose_graph(2, 1, device="cpu")
    p = np.array([1, 2, 3, 0, 0, 0, 1], np.float32)
    for _ in range(4):
        jfull = j_graph.add_node(jfull, jnp.asarray(p))
        tfull = t_graph.add_node(tfull, torch.as_tensor(p))
        jfull = j_graph.add_edge(jfull, 0, 1, jnp.asarray(p))
        tfull = t_graph.add_edge(tfull, 0, 1, torch.as_tensor(p))
    _assert_graph_equal(tfull, jfull)
    assert tfull.n_nodes == 2 and tfull.n_edges == 1
    # add_node leaves its input graph as it was
    before = tgr.poses.clone()
    t_graph.add_node(tgr, torch.as_tensor(p))
    assert torch.equal(tgr.poses, before)


@pytest.mark.parametrize("n", [6, 40])
def test_shrink_to_active_matches_jax(n):
    jgr, tgr, _ = _circle_graph(n=n)
    jv, jn, je = j_graph.shrink_to_active(jgr)
    tv, tn, te = t_graph.shrink_to_active(tgr)
    assert (tn, te) == (jn, je)
    assert tv.poses.shape == jv.poses.shape and tv.edge_ij.shape == jv.edge_ij.shape
    _assert_graph_equal(tv, jv)


def test_graph_numpy_round_trip():
    jgr, _, _ = _circle_graph(n=8)
    tgr = t_graph.graph_from_numpy(jgr, device="cpu")
    _assert_graph_equal(tgr, jgr)
    again = jgr.replace(**{k: jnp.asarray(v) for k, v in t_graph.graph_to_numpy(tgr).items()})
    _assert_graph_equal(tgr, again)


def test_graph_cost_matches_jax():
    jgr, tgr, _ = _circle_graph()
    np.testing.assert_allclose(float(t_pg.graph_cost(tgr)), float(j_pg.graph_cost(jgr)), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_graph_matches_jax(seed):
    jgr, tgr, gt = _circle_graph(seed=seed)
    jopt, jcosts = j_pg.optimize_pose_graph(jgr, iters=10)
    topt, tcosts = t_pg.optimize_pose_graph(tgr, iters=10)
    np.testing.assert_allclose(topt.poses.numpy(), np.asarray(jopt.poses), atol=2e-3)
    np.testing.assert_allclose(tcosts.numpy(), np.asarray(jcosts), rtol=2e-2, atol=1e-6)
    # the loop is pulled shut: the reference's own functional bound
    assert float(t_pg.graph_cost(topt)) < 1e-2 * float(t_pg.graph_cost(tgr))
    err = np.linalg.norm(topt.poses[:16, :3].numpy() - gt[:, :3].numpy(), axis=1)
    assert err.max() < 0.15, err.max()


def _scatter_normal_equations(r, Ji, Jj, w, ii, jj, K):
    """The accumulating assembly the port had before (index_put_ with
    accumulate=True, index_add_): exact on the CPU, the oracle of the
    product form."""
    six = torch.arange(6)
    JiW, JjW = Ji * w[:, :, None], Jj * w[:, :, None]
    blk = lambda a, b: ((a[:, None] * 6 + six)[:, :, None], (b[:, None] * 6 + six)[:, None, :])  # noqa: E731
    H = torch.zeros(K * 6, K * 6, dtype=torch.float64)
    H.index_put_(blk(ii, ii), torch.einsum("eki,ekj->eij", Ji, JiW), accumulate=True)
    H.index_put_(blk(jj, jj), torch.einsum("eki,ekj->eij", Jj, JjW), accumulate=True)
    Hij = torch.einsum("eki,ekj->eij", Ji, JjW)
    H.index_put_(blk(ii, jj), Hij, accumulate=True)
    H.index_put_(blk(jj, ii), Hij.transpose(-1, -2), accumulate=True)
    b = (torch.zeros(K, 6, dtype=torch.float64)
         .index_add_(0, ii, torch.einsum("eki,ek->ei", Ji, w * r))
         .index_add_(0, jj, torch.einsum("eki,ek->ei", Jj, w * r)))
    return H, b


def test_normal_equations_equal_the_scatter_assembly():
    """The segment-sum assembly against the accumulating assembly in
    float64, with repeated edges, a self-edge (i == j) and zero-weight
    edges: the same sums in another order, so equal to rounding."""
    rng = np.random.default_rng(3)
    K, E = 7, 19
    ij = rng.integers(0, K, (E, 2))
    ij[3] = (4, 4)
    ij[5] = ij[6] = (1, 2)
    r, Ji, Jj = (torch.tensor(rng.normal(size=s)) for s in ((E, 6), (E, 6, 6), (E, 6, 6)))
    w = torch.tensor(rng.uniform(0.5, 2.0, (E, 6)))
    w[7:9] = 0.0
    ii, jj = torch.tensor(ij[:, 0]), torch.tensor(ij[:, 1])
    H, b = t_pg.normal_equations(r, Ji, Jj, w, t_pg.assembly_plan(ii, jj, K), K)
    Hs, bs = _scatter_normal_equations(r, Ji, Jj, w, ii, jj, K)
    np.testing.assert_allclose(H.numpy(), Hs.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(b.numpy(), bs.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("N,n", [(1, 1), (37, 1), (200, 9), (513, 64)])
def test_segment_sum_equals_index_add(N, n):
    """Runs of every length, up to one key taking all N rows (the scan's
    longest run), against index_add_ in float64; keys that no row has stay
    zero."""
    rng = np.random.default_rng(N)
    keys = torch.tensor(rng.integers(0, n, N))
    vals = torch.tensor(rng.normal(size=(N, 5)))
    want = torch.zeros(n + 2, 5, dtype=torch.float64).index_add_(0, keys, vals)
    got = t_pg._segment_sum(t_pg._segment_plan(keys, n + 2), vals)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_optimize_pose_graph_is_repeatable():
    """Two solves of one graph give the same poses and costs bit for bit
    (the assembly is a sorted segment sum, not a scatter with atomics)."""
    _, tgr, _ = _circle_graph(seed=2)
    a, ca = t_pg.optimize_pose_graph(tgr, iters=6)
    b, cb = t_pg.optimize_pose_graph(tgr, iters=6)
    assert torch.equal(a.poses, b.poses) and torch.equal(ca, cb)


def test_make_pose_graph_needs_a_device():
    """`device` is a required keyword, as in the port's other constructors,
    and every tensor of the graph lies on it."""
    with pytest.raises(TypeError, match="device"):
        t_graph.make_pose_graph(4, 8)
    g = t_graph.make_pose_graph(4, 8, device="meta")
    for f in ("poses", "node_valid", "edge_ij", "edge_rel", "edge_info", "edge_valid"):
        assert getattr(g, f).device.type == "meta", f
    assert (g.max_nodes, g.max_edges, g.n_nodes, g.n_edges) == (4, 8, 0, 0)


def _horn_case(seed, n=20, outlier=False):
    rng = np.random.default_rng(seed)
    pb = rng.normal(size=(n, 3)).astype(np.float32)
    T = tg.se3_exp(torch.tensor(rng.normal(size=6) * [0.5, 0.5, 0.5, 0.3, 0.3, 0.3],
                                dtype=torch.float32))
    pa = tg.se3_apply(T, torch.as_tensor(pb)).numpy()
    valid = np.ones(n, bool)
    if outlier:
        pa[0] = 100.0
        valid[0] = False
    return pa, pb, valid, T


@pytest.mark.parametrize("seed,outlier", [(0, False), (1, True), (2, False)])
def test_estimate_relative_pose_3d3d_matches_jax(seed, outlier):
    pa, pb, valid, T = _horn_case(seed, outlier=outlier)
    got = t_graph.estimate_relative_pose_3d3d(torch.as_tensor(pa), torch.as_tensor(pb),
                                              torch.as_tensor(valid))
    ref = np.asarray(j_graph.estimate_relative_pose_3d3d(jnp.asarray(pa), jnp.asarray(pb),
                                                         jnp.asarray(valid)))
    R = tg.quat_to_matrix(got[3:]).numpy()
    np.testing.assert_allclose(got[:3].numpy(), ref[:3], atol=1e-4)
    np.testing.assert_allclose(R, np.asarray(jg.quat_to_matrix(jnp.asarray(ref[3:]))), atol=1e-4)
    np.testing.assert_allclose(got[:3].numpy(), T[:3].numpy(), atol=1e-4)
    # batched call: the same answer per batch entry
    two = t_graph.estimate_relative_pose_3d3d(
        torch.as_tensor(np.stack([pa, pa])), torch.as_tensor(np.stack([pb, pb])),
        torch.as_tensor(np.stack([valid, valid])))
    np.testing.assert_allclose(two[1].numpy(), got.numpy(), atol=1e-6)
