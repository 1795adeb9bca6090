"""Config 5's captured programs in one process on the CPU: the pieces of
the sharded step's capture that need no second rank, and the distributed
programs on the 1 x 1 mesh (no process group; every collective is the
identity). The 2-rank cases (the captured sharded step, the ring gather
against JAX, `best_particle_lanes` on ties across ranks, the host-read
guard at 2 ranks, the captured distributed BA, ring match and system) are
in tests/test_torch_dist.py, test_torch_dist_ba.py, test_torch_ring_match.py
and test_torch_config5.py, whose one spawn of tests/torch_dist_worker.py
runs them beside the older cases.

- The source-window gather (`resample_cuda.gather_state(window=, out=)`,
  its twin here): the S windows of a ring, taken in any rank's ring order,
  equal the global take at S = 1, 2 and 4, and JAX's `ring_gather_rows`
  under `shard_map` on 2 and 4 of the 8 virtual CPU devices.
- `run_sequence` over a `ShardedFastSLAM` with capture=True (the captured
  path's buffer rules) equals `FastSLAM`'s eager loop bit for bit.
- The eager sharded step, its estimate and `best_particle_lanes` run under
  tests/test_torch_capture.py's host-read guard.
- The distributed BA (1-D and 2-D) and the ring match through their
  CapturedSteps equal their eager twins bit for bit, and keep their steps
  with the mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parakeet_slam_tpu.dist.mesh import PARTICLE_AXIS
from parakeet_slam_tpu.dist.mesh import make_mesh as j_make_mesh
from parakeet_slam_tpu.dist.sharded_filter import ring_gather_rows as j_ring_gather_rows
from parakeet_slam_tpu_torch.core.state import ParticleState
from parakeet_slam_tpu_torch.dist import dist_ba
from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.ring_match import ring_hamming_top2, ring_match
from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
from parakeet_slam_tpu_torch.eval import config5_demo
from parakeet_slam_tpu_torch.eval.kernel_inputs import descriptors
from parakeet_slam_tpu_torch.filter import make_filter, run_sequence
from parakeet_slam_tpu_torch.filter.runner import draw_noise
from parakeet_slam_tpu_torch.kernels import match, resample_cuda
from tests import torch_dist_worker as W
from tests.test_torch_capture import no_host_reads, one_thread  # noqa: F401

try:
    from jax import shard_map as shard_map_fn
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as shard_map_fn

pytestmark = pytest.mark.usefixtures("one_thread")

FIELDS = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_desc", "lm_valid", "lm_count")
LEAVES = resample_cuda._LEAVES


def _state(rng, P=16, L=8):
    return ParticleState(
        pose=torch.as_tensor(rng.normal(size=(P, 7)).astype(np.float32)),
        log_w=torch.as_tensor(rng.normal(size=P).astype(np.float32)),
        lm_mean=torch.as_tensor(rng.normal(size=(P, L, 3)).astype(np.float32)),
        lm_cov=torch.as_tensor(rng.normal(size=(P, L, 3, 3)).astype(np.float32)),
        lm_sig=torch.zeros(P, L, 0),
        lm_desc=torch.as_tensor(rng.integers(-2**31, 2**31, (P, L, 8)).astype(np.int32)),
        lm_valid=torch.as_tensor(rng.random((P, L)) > 0.5),
        lm_count=torch.as_tensor(rng.integers(0, 9, (P, L)).astype(np.int32)))


def _block(st, s, Pl):
    return st.replace(**{f: getattr(st, f)[s * Pl:(s + 1) * Pl].clone() for f in FIELDS})


def _windows(st, idx, S, me):
    """Rank `me`'s output of an S-rank ring gather of `st` at its rows of
    `idx`: the S blocks visited in the ring's order (me, me - 1, ...), each
    through the source-window gather into one output."""
    Pl = st.num_particles // S
    out = None
    for s in range(S):
        src = (me - s) % S
        out = resample_cuda.gather_state(_block(st, src, Pl), idx, window=src * Pl, out=out)
    return out


@pytest.mark.parametrize("S", [1, 2, 4])
def test_source_window_gather_equals_the_global_take(S):
    """Every rank's S windows write each of its output rows once, from the
    block that holds its source: the result equals the global take, log_w
    0, with no kernel launch on the CPU (the twin)."""
    rng = np.random.default_rng(S)
    st = _state(rng)
    idx = torch.as_tensor(np.sort(rng.integers(0, 16, 16)))
    before = resample_cuda.gather_state.launches
    Pl = 16 // S
    for me in range(S):
        rows = idx[me * Pl:(me + 1) * Pl]
        got = _windows(st, rows, S, me)
        want = resample_cuda.gather_state_reference(st, rows)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (S, me, f)
    assert resample_cuda.gather_state.launches == before


def test_source_window_leaves_the_other_rows():
    """One window writes only the rows whose index lies in it; the rest of
    `out` keeps its bits, -0.0 and NaN included."""
    rng = np.random.default_rng(5)
    st = _state(rng)
    block = _block(st, 1, 8)
    out = _state(rng, P=6)
    out.lm_mean[0, 0, 0] = -0.0
    out.lm_mean[3, 1, 2] = float("nan")
    idx = torch.tensor([0, 9, 15, 7, 8, 3])
    keep = {f: getattr(out, f).clone() for f in LEAVES}
    got = resample_cuda.gather_state(block, idx, window=8, out=out)
    inside = (idx >= 8) & (idx < 16)
    for f in LEAVES:
        a, b = getattr(got, f), keep[f]
        assert torch.equal(a[inside], getattr(st, f)[idx[inside]]), f
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a[~inside], b[~inside]), f


def test_source_window_arguments():
    st = _state(np.random.default_rng(6))
    idx = torch.arange(4)
    with pytest.raises(ValueError, match="window -1 < 0"):
        resample_cuda.gather_state(st, idx, window=-1)
    with pytest.raises(ValueError, match="out= is the source window's"):
        resample_cuda.gather_state(st, idx, out=st)


@pytest.mark.parametrize("S", [2, 4])
def test_simulated_ring_gather_equals_jax(S):
    """The port's ring form, each simulated rank's windows in its ring
    order, against JAX's `ring_gather_rows` under `shard_map` on S virtual
    devices, on the same indices."""
    rng = np.random.default_rng(10 + S)
    st = _state(rng)
    idx = rng.integers(0, 16, 16)
    fn = shard_map_fn(lambda pl, ix: j_ring_gather_rows(pl, ix, PARTICLE_AXIS),
                      mesh=j_make_mesh(n_devices=S), in_specs=(P(PARTICLE_AXIS), P(PARTICLE_AXIS)),
                      out_specs=P(PARTICLE_AXIS))
    leaves = [f for f in LEAVES if getattr(st, f).numel()]
    ref = fn({f: jnp.asarray(getattr(st, f).numpy()) for f in leaves}, jnp.asarray(idx))
    Pl = 16 // S
    got = [_windows(st, torch.as_tensor(idx[r * Pl:(r + 1) * Pl]), S, r) for r in range(S)]
    for f in leaves:
        np.testing.assert_array_equal(np.concatenate([getattr(g, f).numpy() for g in got]),
                                      np.asarray(ref[f]), err_msg=f)


def _sequence(case):
    fc, fe, init, steps = (W.corridor_case() if case == "corridor"
                           else W.vision_case("equirect_3d", "fastslam1"))
    slam = make_filter(fc, fe)
    T = len(steps)
    noise, u0 = draw_noise(T, fc.num_particles, slam.noise_dim, torch.Generator().manual_seed(0),
                           "cpu")
    st = slam.init_state(device="cpu")
    if init is not None:
        init = torch.as_tensor(init)
        st = st.replace(pose=(init.expand(fc.num_particles, -1) if init.dim() == 1
                              else init).clone())
    seq = (torch.stack([u for u, _ in steps]),
           *(torch.stack([getattr(o, k) for _, o in steps]) for k in ("z", "sig", "valid")))
    kw = dict(motion_noise=noise, resample_u0=u0,
              obs_desc=torch.stack([o.desc for _, o in steps]))
    return slam, st, seq, kw, steps, noise, u0


@pytest.mark.parametrize("case", ["corridor", "equirect_fs1"])
def test_sharded_run_sequence_captured_equals_fastslam(case):
    """`run_sequence` over `ShardedFastSLAM` on the 1 x 1 mesh with
    capture=True (one CapturedStep a frame, eager on the CPU) equals the
    one-device filter's eager loop bit for bit: every state leaf, estimate
    and metric, with and without resamples."""
    slam, st, seq, kw, _, _, _ = _sequence(case)
    sh = ShardedFastSLAM(slam, mesh_mod.make_mesh())
    a = run_sequence(slam, st, *seq, capture=False, **kw)
    b = run_sequence(sh, st, *seq, capture=True, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    assert torch.equal(a[1], b[1])
    for k in ("ess", "num_landmarks", "match_frac", "resampled"):
        assert torch.equal(torch.stack([getattr(m, k) for m in a[2]]),
                           torch.stack([getattr(m, k) for m in b[2]])), k
    res = [bool(m.resampled) for m in b[2]]
    assert any(res) and (case != "corridor" or not all(res))


def test_sharded_step_and_lanes_read_nothing_on_the_host(monkeypatch):
    """One eager sharded step on the 1 x 1 mesh (its resample decided on
    the device, the gather at the identity or the systematic indices), its
    estimate and `best_particle_lanes`, after a warm-up frame, with the
    host reads of tests/test_torch_capture.py's guard made to raise."""
    slam, st, _, _, steps, noise, u0 = _sequence("corridor")
    sh = ShardedFastSLAM(slam, mesh_mod.make_mesh())
    st, _ = sh.step(st, *steps[0], noise[0], u0[0])
    with monkeypatch.context() as mp:
        no_host_reads(mp)
        for t in (1, 2):
            st, m = sh.step(st, *steps[t], noise[t], u0[t])
            sh.estimate_pose(st)
        lanes = sh.best_particle_lanes(st)
    b = torch.argmax(st.log_w)
    for got, want in zip(lanes, (st.lm_mean, st.lm_valid, st.lm_desc, st.lm_count)):
        assert torch.equal(got, want[b])


@pytest.mark.parametrize("two_d", [False, True])
def test_dist_ba_captured_equals_eager_on_one_rank(two_d):
    """The distributed BA through its CapturedStep (capture=True, eager on
    the CPU) equals capture=False bit for bit on the 1 x 1 mesh, twice
    over the same step; a new setting is a new step, kept with the mesh."""
    cam, prob = config5_demo.make_ring_ba(Pts=300, device="cpu")
    mesh = mesh_mod.make_mesh()
    sp = dist_ba.shard_problem_2d(prob, 1, 1) if two_d else dist_ba.shard_problem(prob, 1)
    solve = dist_ba.optimize_ba_distributed_2d if two_d else dist_ba.optimize_ba_distributed
    kw = dict(iters=4, pcg_iters=10, lam=1e-4)
    p0, c0 = solve(cam, sp, mesh, capture=False, **kw)
    for _ in range(2):
        p1, c1 = solve(cam, sp, mesh, capture=True, **kw)
        assert torch.equal(c0, c1) and torch.equal(p0.cam_pose, p1.cam_pose)
        assert torch.equal(p0.points, p1.points)
    assert c0[-1] < c0[0]
    solver = mesh.programs[("dist_ba", torch.device("cpu"))]
    assert len(solver.steps) == 1
    solve(cam, sp, mesh, capture=True, huber_delta=5.0, **kw)
    assert len(solver.steps) == 2
    # capture=None on CPU tensors is the eager loop: no step is added
    solve(cam, sp, mesh, huber_delta=7.0, **kw)
    assert len(solver.steps) == 2


def test_ring_match_captured_on_one_rank_is_the_dense_match():
    rng = np.random.default_rng(3)
    qd = torch.as_tensor(descriptors(rng, (16, 8), 30))
    db = torch.as_tensor(descriptors(rng, (64, 8), 30))
    dbv = torch.as_tensor(rng.random(64) > 0.2)
    qv = torch.ones(16, dtype=torch.bool)
    mesh = mesh_mod.make_mesh()
    for _ in range(2):
        for a, b in zip(ring_hamming_top2(qd, qv, db, dbv, mesh, capture=True),
                        match.hamming_top2(qd, db, dbv)):
            assert torch.equal(a, b)
        for a, b in zip(ring_match(qd, qv, db, dbv, mesh, capture=True),
                        match.match(qd, qv, db, dbv)):
            assert torch.equal(a, b)
    assert len(mesh.programs) == 2
