"""Horn's rotation fit (`kernels/horn.py`) and the closure verification that
runs it, against the JAX package on seeded numpy inputs.

(a) `estimate_relative_pose_3d3d` (its rotation from `rotation_fit`, which
    runs the SVD twin on the CPU) against JAX's, per candidate, at Nc = 1,
    4 and 16 candidates of F = 256 correspondences: noisy rigid motions, a
    reflection (the cross-covariance has det < 0, so the fit is the best
    proper rotation), and coplanar points (rank 2, still a unique fit).
    Translations within 1e-5 m and quaternions within 1e-6 up to their sign:
    float32 sums in another order, the same algorithm.
(b) Collinear points (rank 1): the fit is not unique, so each package may
    return another rotation. Each is proper (R R^T = I and det R = 1 within
    1e-5) and optimal (tr(R^T M) within 1e-5 of M's largest singular value).
(c) The CUDA kernel's algorithm (`csrc/horn.cu`: Horn's quaternion form, a
    cyclic Jacobi eigen-solve in float64, the rotation stored in float32),
    mirrored step for step in numpy below, against a float64 Kabsch fit
    within 1e-6 where the fit is unique; proper and optimal on rank-1 and
    zero inputs. The card holds the kernel itself to the twin
    (`chip_smoke.py`, `check_verify`).
(d) `_horn_consensus_impl` against JAX's jitted `_horn_consensus` at Nc = 1,
    4 and 16, vmapped: inlier counts equal, rels within 1e-4 (the
    tolerance of tests/test_torch_system.py).
(e) `_verify_batch` captured (`capture=True`, which on the CPU runs the
    captured path's buffer rules eagerly) against `capture=False`, for both
    refines over Nc = 1, 4 and 16: rels and inliers bit for bit; one step
    per batch shape, whose static inputs are the correspondences alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.backend import graph as j_graph
from parakeet_slam_tpu_torch import system
from parakeet_slam_tpu_torch.backend import graph as t_graph
from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.kernels import horn
from test_torch_capture import one_thread  # noqa: F401  (a fixture)
from test_torch_system import _pair, _same_pose

F = 256
BATCHES = (1, 4, 16)
T = torch.as_tensor


def _batch(rng, Nc, kind="rigid"):
    """Nc candidates of F correspondences pa (kf frame), pb = T(pa) + 1 cm
    noise, the first n rows valid (n from 20 to F) and zeros after; `kind`
    "reflection" mirrors pb in z, "coplanar" puts pa on a plane, "collinear"
    on a line."""
    pa = np.stack([rng.uniform(-1.5, 1.5, (Nc, F)), rng.uniform(-1, 1, (Nc, F)),
                   rng.uniform(2, 6, (Nc, F))], -1)
    if kind == "coplanar":
        pa[..., 2] = 4.0
    if kind == "collinear":
        pa = rng.uniform(-2, 2, (Nc, F, 1)) * np.array([0.3, -0.5, 0.8]) + np.array([0, 0, 4.0])
    q = np.concatenate([0.05 * rng.normal(size=(Nc, 3)), np.ones((Nc, 1))], -1)
    rel = np.concatenate([rng.uniform(-0.3, 0.3, (Nc, 3)),
                          q / np.linalg.norm(q, axis=-1, keepdims=True)], -1)
    pb = geometry.se3_apply(T(rel, dtype=torch.float32)[:, None],
                            T(pa, dtype=torch.float32)).numpy()
    if kind == "reflection":
        pb = pb * np.array([1.0, 1.0, -1.0])
    pb = pb + 0.01 * rng.normal(size=pb.shape)
    valid = np.arange(F)[None] < rng.integers(20, F, Nc)[:, None]
    pa, pb = (np.where(valid[..., None], a, 0.0).astype(np.float32) for a in (pa, pb))
    return pa, pb, valid


def _cov(pa, pb, valid):
    """The cross-covariance that `estimate_relative_pose_3d3d(pa, pb, valid)`
    fits, in float64."""
    w = valid.astype(np.float64)[..., None]
    n = np.maximum(w.sum(-2, keepdims=True), 1.0)
    xa = (pa - (pa * w).sum(-2, keepdims=True) / n) * w
    xb = (pb - (pb * w).sum(-2, keepdims=True) / n) * w
    return np.swapaxes(xa, -1, -2) @ xb / n


def _kabsch(M):
    U, _, Vt = np.linalg.svd(M)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    return (U * np.stack([np.ones_like(d), np.ones_like(d), d], -1)[..., None, :]) @ Vt


def _assert_proper_and_optimal(R, M, what):
    R = np.asarray(R, np.float64)
    eye = np.broadcast_to(np.eye(3), R.shape)
    assert np.abs(R @ np.swapaxes(R, -1, -2) - eye).max() < 1e-5, what
    assert np.abs(np.linalg.det(R) - 1.0).max() < 1e-5, what
    s = np.linalg.svd(M, compute_uv=False)
    best = s[..., 0] + s[..., 1] + np.sign(np.linalg.det(M)) * s[..., 2]
    got = np.einsum("...ij,...ij->...", R, M)
    assert np.abs(got - best).max() <= 1e-5 * max(1.0, float(s[..., 0].max())), what


# -- (a), (b) the pose estimate against JAX ----------------------------------------


@pytest.mark.parametrize("Nc", BATCHES)
@pytest.mark.parametrize("kind", ["rigid", "reflection", "coplanar"])
def test_pose_estimate_matches_jax(kind, Nc):
    pa, pb, v = _batch(np.random.default_rng(Nc), Nc, kind)
    j = np.asarray(jax.vmap(j_graph.estimate_relative_pose_3d3d)(
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(v)))
    p = t_graph.estimate_relative_pose_3d3d(T(pa), T(pb), T(v)).numpy()
    np.testing.assert_allclose(p[:, :3], j[:, :3], atol=1e-5)
    sign = np.sign(np.sum(p[:, 3:] * j[:, 3:], axis=-1, keepdims=True))
    np.testing.assert_allclose(p[:, 3:], sign * j[:, 3:], atol=1e-6)
    # the twin's rotation against a float64 Kabsch fit of the same data
    R = horn.rotation_fit(T(_cov(pa, pb, v), dtype=torch.float32)).numpy()
    np.testing.assert_allclose(R, _kabsch(_cov(pa, pb, v)), atol=1e-5)


@pytest.mark.parametrize("Nc", BATCHES)
def test_rank_one_fit_is_a_proper_optimal_rotation(Nc):
    pa, pb, v = _batch(np.random.default_rng(10 + Nc), Nc, "collinear")
    M = _cov(pa, pb, v)
    j = np.asarray(jax.vmap(j_graph.estimate_relative_pose_3d3d)(
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(v)))
    p = t_graph.estimate_relative_pose_3d3d(T(pa), T(pb), T(v)).numpy()
    for name, rel in (("JAX", j), ("port", p)):
        R = geometry.quat_to_matrix(T(rel[:, 3:], dtype=torch.float64)).numpy()
        _assert_proper_and_optimal(R, M, name)


# -- (c) the kernel's algorithm ------------------------------------------------------


def _horn_kernel(M):
    """csrc/horn.cu's rotation_fit_kernel for one matrix, in numpy float64
    (the same operations in the same order): (R as float32, sweeps)."""
    M = np.asarray(M, np.float64)
    a = np.empty((4, 4))
    a[0, 0] = M[0, 0] + M[1, 1] + M[2, 2]
    a[1, 1] = M[0, 0] - M[1, 1] - M[2, 2]
    a[2, 2] = -M[0, 0] + M[1, 1] - M[2, 2]
    a[3, 3] = -M[0, 0] - M[1, 1] + M[2, 2]
    a[0, 1] = a[1, 0] = M[2, 1] - M[1, 2]
    a[0, 2] = a[2, 0] = M[0, 2] - M[2, 0]
    a[0, 3] = a[3, 0] = M[1, 0] - M[0, 1]
    a[1, 2] = a[2, 1] = M[0, 1] + M[1, 0]
    a[1, 3] = a[3, 1] = M[0, 2] + M[2, 0]
    a[2, 3] = a[3, 2] = M[1, 2] + M[2, 1]
    v = np.eye(4)
    sweep = 0
    while sweep < 32:
        off = sum(a[i, j] ** 2 for i in range(4) for j in range(i + 1, 4))
        if off <= 1e-30 * (sum(a[i, i] ** 2 for i in range(4)) + off):
            break
        for p, q in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
            apq = a[p, q]
            if apq == 0.0:
                continue
            theta = (a[q, q] - a[p, p]) / (2.0 * apq)
            at = abs(theta)
            t = 0.5 / at if at > 1e150 else 1.0 / (at + np.sqrt(theta * theta + 1.0))
            t = -t if theta < 0.0 else t
            c = 1.0 / np.sqrt(t * t + 1.0)
            s = t * c
            a[p, p] -= t * apq
            a[q, q] += t * apq
            a[p, q] = a[q, p] = 0.0
            for r in range(4):
                if r not in (p, q):
                    arp, arq = a[r, p], a[r, q]
                    a[r, p] = a[p, r] = c * arp - s * arq
                    a[r, q] = a[q, r] = s * arp + c * arq
                vrp, vrq = v[r, p], v[r, q]
                v[r, p] = c * vrp - s * vrq
                v[r, q] = s * vrp + c * vrq
        sweep += 1
    k = 0
    for i in range(1, 4):
        if a[i, i] > a[k, k]:
            k = i
    w, x, y, z = v[:, k] / np.sqrt(np.sum(v[:, k] ** 2))
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return R.astype(np.float32), sweep


@pytest.mark.parametrize("kind", ["rigid", "reflection", "coplanar", "collinear", "zero"])
def test_kernel_algorithm_matches_kabsch(kind):
    rng = np.random.default_rng(7)
    if kind == "zero":
        M = np.zeros((1, 3, 3))
    else:
        M = _cov(*_batch(rng, 16, kind))
    got = np.stack([_horn_kernel(m)[0] for m in M])
    sweeps = [_horn_kernel(m)[1] for m in M]
    assert max(sweeps) <= 8, sweeps
    if kind in ("collinear", "zero"):
        _assert_proper_and_optimal(got, M, kind)
        return
    np.testing.assert_allclose(got, _kabsch(M), atol=1e-6)
    np.testing.assert_allclose(got, horn.rotation_fit_reference(T(M, dtype=torch.float32)),
                               atol=1e-5)


# -- (d) the consensus against JAX ---------------------------------------------------


@pytest.mark.parametrize("Nc", BATCHES)
def test_horn_consensus_matches_jax(Nc):
    rng = np.random.default_rng(20 + Nc)
    j_sys, p_sys = _pair(camera="pinhole")
    pa, pb, v = _batch(rng, Nc)
    pb[:, :Nc] += rng.uniform(-3, 3, (Nc, Nc, 3)).astype(np.float32)  # outliers
    j_rel, j_n = jax.vmap(j_sys._horn_consensus)(jnp.asarray(pa), jnp.asarray(pb),
                                                 jnp.asarray(v))
    p_rel, p_n = p_sys._horn_consensus_impl(T(pa), T(pb), T(v))
    np.testing.assert_array_equal(p_n.numpy(), np.asarray(j_n))
    _same_pose(p_rel.numpy(), np.asarray(j_rel), 1e-4)


# -- (e) the whole verification captured against eager ------------------------------


@pytest.mark.parametrize("depth_sigma", [0.0, 0.3], ids=["refine", "depth_relaxed"])
def test_captured_verify_equals_eager(depth_sigma, one_thread):  # noqa: F811
    rng = np.random.default_rng(31)
    cfg = _pair(camera="pinhole", depth_sigma=depth_sigma)[1].cfg
    cap = system.SLAMSystem(cfg, device="cpu", capture=True)
    eager = system.SLAMSystem(cfg, device="cpu", capture=False)
    for Nc in (*BATCHES, 4):  # the last batch replays the Nc = 4 step
        pa, pb, v = _batch(rng, Nc)
        pb[:, :5] += rng.uniform(-3, 3, (Nc, 5, 3)).astype(np.float32)
        rels, ns = cap._verify_batch(pa, pb, v)
        e_rels, e_ns = eager._verify_batch(pa, pb, v)
        assert torch.equal(rels.view(torch.int32), e_rels.view(torch.int32))
        np.testing.assert_array_equal(ns, e_ns)
        assert (ns > 0).all()
    assert sorted(cap._verify_steps) == sorted((Nc, F, 3) for Nc in BATCHES)
    assert all(set(cs.inputs) == {"pa", "pb", "valid"} for cs in cap._verify_steps.values())
    assert not eager._verify_steps
