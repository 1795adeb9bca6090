"""The captured offline programs on the CPU, at small sizes: bundle
adjustment's LM iteration (`backend/ba.CapturedBA`, all three layouts, with
and without pose edges, both solvers), the point dedup's scan step and the
closure match's step (`system._dedup_step`, `system._kf_match_step`), the
port's counterparts of the reference's jitted `_optimize_buckets`,
`_optimize_packed`, `optimize_ba_obsmajor`, `_assign_point_ids` and
`_batched_kf_match`.

(a) Capture safety: after one warm-up call, one call of each program's
    `CapturedStep` runs under tests/test_torch_capture.py's guard, which
    makes the host's reads of the device and its copies of host data raise.
(b) Captured equals eager bit for bit (`capture=True` on the CPU runs the
    captured path's buffer rules eagerly, against `capture=False`): each
    layout solved twice at the same shapes around a problem of other
    shapes; the dedup walked twice, with a full store; the closure match
    across a store doubling and across a `load_checkpoint` rebuild of
    other keyframes; `run_ba` on config 2's small desk system.
(c) Against JAX: the captured `optimize_ba` against JAX's jitted one at
    tests/test_torch_ba.py's tolerances (the same accepts, costs within
    rtol 1e-3, poses and points within 1e-3); the captured dedup and match
    against JAX's `_assign_point_ids` and `_batched_kf_match` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parakeet_slam_tpu.backend import ba as j_ba
from parakeet_slam_tpu.system import _assign_point_ids as j_assign_point_ids
from parakeet_slam_tpu.system import _batched_kf_match as j_batched_kf_match
from parakeet_slam_tpu_torch import system
from parakeet_slam_tpu_torch.backend import ba, graph
from parakeet_slam_tpu_torch.core import config as pcm
from parakeet_slam_tpu_torch.eval.kernel_inputs import BA_BENCH_CAMERA, ba_bench_problem
from parakeet_slam_tpu_torch.filter import captured
from parakeet_slam_tpu_torch.frontend import camera as t_cam
from tests.test_backend import _make_ba_problem
from tests.test_torch_ba import _accepts, _assert_same_run, _from_jax, _ring_edges
from tests.test_torch_capture import SYS_FRAMES, desk, no_host_reads  # noqa: F401
from tests.test_torch_system import _add_port_keyframe, _dedup_case, _host_cfg, _rand_pose

CAM = t_cam.Pinhole(*BA_BENCH_CAMERA)
KW = dict(huber_delta=3.0, pcg_tol=1e-6, step_clamp=(10.0, 50.0))


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _assert_bit_equal(a, b, what):
    for i, (x, y) in enumerate(zip(captured.leaves(a), captured.leaves(b))):
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), f"{what}: leaf {i} differs"


def _problem(C, Pts, obs_per_cam, seed=0):
    """The bench problem at a small size: every camera fixed but the
    first two free, so a few iterations descend."""
    prob = graph.make_ba_problem(**ba_bench_problem(C, Pts, obs_per_cam, seed=seed, noise_px=2.0),
                                 device="cpu")
    pts = prob.points + 0.05 * torch.as_tensor(
        np.random.default_rng(seed).normal(size=tuple(prob.points.shape)), dtype=torch.float32)
    return prob.replace(points=pts)


def _edges(C, seed=0):
    """Relative-pose edges along the camera chain (5 m over C cameras, as
    the bench problem's poses), a little off."""
    rng = np.random.default_rng(seed)
    ij = np.stack([np.arange(C - 1), np.arange(1, C)], 1).astype(np.int32)
    rel = np.tile(np.array([5.0 / (C - 1), 0, 0, 0, 0, 0, 1], np.float32), (C - 1, 1))
    rel[:, :3] += 0.01 * rng.normal(size=(C - 1, 3)).astype(np.float32)
    return (torch.as_tensor(ij), torch.as_tensor(rel), torch.full((C - 1, 6), 100.0),
            torch.ones(C - 1, dtype=torch.bool))


# -- (a) capture safety --------------------------------------------------------

BA_PROGRAMS = ["buckets_pcg", "buckets_dense", "buckets_pcg_edges", "buckets_dense_edges",
               "packed", "obsmajor"]


def _ba_program(name):
    """(iteration function, state, inputs) of one solve."""
    prob = _problem(4, 300, 120)
    layout = name.split("_")[0]
    kw = dict(KW, solver="dense" if "dense" in name else "pcg", pcg_iters=8)
    if layout == "buckets":
        prob = graph.pack_buckets(prob)
    elif layout == "packed":
        prob = graph.pack_problem(prob)
    fn, x = ba._program(CAM, prob, layout, _edges(4) if "edges" in name else None, **kw)
    return fn, (prob.cam_pose, prob.points, ba._lam(1e-4, prob.points)), x


def _other_program(name):
    rng = np.random.default_rng(4)
    if name == "dedup":
        desc, valid, world, cap = _dedup_case("pool")
        state = (torch.zeros(cap + 1, 8, dtype=torch.int32), torch.zeros(cap + 1, dtype=torch.bool),
                 torch.zeros(cap + 1, 3), torch.zeros((), dtype=torch.int32),
                 torch.zeros((), dtype=torch.int32))
        x = {"desc": torch.as_tensor(desc[0].view(np.int32)), "valid": torch.as_tensor(valid[0]),
             "world": torch.as_tensor(world[0])}
        return system._dedup_step(cap, 40), state, x
    store = rng.integers(0, 2**32, (8, 32, 8), dtype=np.uint32).view(np.int32)
    x = {"qd": torch.as_tensor(store[2]), "qv": torch.ones(32, dtype=torch.bool),
         "db": torch.as_tensor(store), "dbv": torch.ones(8, 32, dtype=torch.bool),
         "n_old": torch.full((), 5, dtype=torch.int64)}
    return system._kf_match_step(0.8), (), x


@pytest.mark.parametrize("name", BA_PROGRAMS + ["dedup", "kf_match"])
def test_program_reads_nothing_on_the_host(name):
    fn, state, x = _ba_program(name) if name in BA_PROGRAMS else _other_program(name)
    cs = captured.CapturedStep(fn, captured.clone(state), captured.clone(x), graph=False)
    cs()  # the warm-up
    before = captured.clone(cs.state)
    with pytest.MonkeyPatch.context() as mp:
        no_host_reads(mp)
        out = cs()
    floats = [t for t in captured.leaves(out) if t.is_floating_point()]
    assert all(torch.isfinite(t).all() for t in floats)
    if name in BA_PROGRAMS:  # the damping moved: the state was written
        assert not torch.equal(cs.state[2], before[2])


# -- (b) captured against eager, bit for bit --------------------------------------


def _layout(prob, name):
    return {"bucketed": graph.pack_buckets, "packed": graph.pack_problem,
            "raw": lambda p: p, "obsmajor": lambda p: p}[name](prob)


@pytest.mark.parametrize("layout,solver,edges", [
    ("bucketed", "pcg", False), ("bucketed", "dense", False), ("bucketed", "pcg", True),
    ("raw", "dense", True), ("packed", "pcg", False), ("obsmajor", "pcg", False)])
def test_captured_ba_equals_eager(layout, solver, edges):
    """Solves A, B (other shapes), A' (A's shapes, other values): each equal
    to the eager twin; A' starts from its own problem, not A's state."""
    solver_ = ba.CapturedBA(graph=False)
    probs = [_problem(4, 300, 120, seed=0), _problem(5, 400, 150, seed=1),
             _problem(4, 300, 120, seed=2)]
    kw = dict(iters=3, lam=1e-3, pcg_iters=10, solver=solver, huber_delta=3.0)
    results = []
    for p in probs:
        p = _layout(p, layout)
        if layout == "obsmajor":
            run = lambda c: ba.optimize_ba_obsmajor(CAM, p, capture=c, **kw)  # noqa: E731
        else:
            pe = _edges(p.num_cams) if edges else None
            run = lambda c: ba.optimize_ba(CAM, p, pose_edges=pe, capture=c, **kw)  # noqa: E731
        eager, cap = run(False), run(solver_)
        assert type(cap.problem) is type(p)
        _assert_bit_equal((cap.costs, cap.pcg_residuals, cap.problem.cam_pose,
                           cap.problem.points), (eager.costs, eager.pcg_residuals,
                                                 eager.problem.cam_pose, eager.problem.points),
                          f"{layout} solve {len(results)}")
        assert cap.costs.shape == (3,) and torch.isfinite(cap.costs).all()
        results.append(cap)
    assert len(solver_.steps) == 2  # one step per shape key, A' replayed A's
    assert not torch.equal(results[0].costs, results[2].costs)
    # a caller keeps its own copies: a later solve leaves them alone
    assert results[0].problem.cam_pose.data_ptr() != results[2].problem.cam_pose.data_ptr()


def test_captured_ba_keys_the_settings():
    """huber_delta, step_clamp and the initial damping change the result of
    one shape: the first two key the step, the third is state."""
    solver_ = ba.CapturedBA(graph=False)
    bk = graph.pack_buckets(_problem(4, 300, 120))
    runs = [dict(huber_delta=3.0), dict(huber_delta=1.0), dict(huber_delta=1.0, lam=1.0),
            dict(huber_delta=1.0, step_clamp=(1e-3, 1e-3))]
    for kw in runs:
        kw = dict(dict(iters=2, pcg_iters=8, lam=1e-3), **kw)
        eager = ba.optimize_ba(CAM, bk, capture=False, **kw)
        cap = ba.optimize_ba(CAM, bk, capture=solver_, **kw)
        _assert_bit_equal(cap.costs, eager.costs, str(kw))
        _assert_bit_equal(cap.problem.cam_pose, eager.problem.cam_pose, str(kw))
    assert len(solver_.steps) == 3


def test_optimize_ba_default_is_eager_on_the_cpu(monkeypatch):
    bk = graph.pack_buckets(_problem(4, 300, 120))
    ba._SOLVERS.pop(torch.device("cpu"), None)
    ba.optimize_ba(CAM, bk, iters=1, pcg_iters=4)
    assert torch.device("cpu") not in ba._SOLVERS
    ba.optimize_ba(CAM, bk, iters=2, pcg_iters=4, capture=True)
    assert len(ba.captured_solver("cpu").steps) == 1
    ba._SOLVERS.pop(torch.device("cpu"))


@pytest.mark.parametrize("name", ["dedup_order", "capacity_overflow", "pool"])
def test_captured_dedup_equals_eager(name):
    """Walked twice through one dict of steps, with another case's shapes
    in between: the second walk starts from an empty store."""
    steps = {}
    cases = [_dedup_case(name), _dedup_case("pool" if name != "pool" else "dedup_order"),
             _dedup_case(name)]
    for i, (desc, valid, world, cap) in enumerate(cases):
        args = (torch.as_tensor(desc.view(np.int32)), torch.as_tensor(valid),
                torch.as_tensor(world))
        eager = system._assign_point_ids(*args, cap=cap, max_ham=40)
        cap_ = system._assign_point_ids(*args, cap=cap, max_ham=40, steps=steps)
        _assert_bit_equal(cap_, eager, f"{name} walk {i}")
    assert len(steps) == 2
    (_, _, _, cnt, drop), _ = cap_
    if name == "capacity_overflow":
        assert (int(cnt), int(drop)) == (4, 2)


def _kf_systems(n, seed):
    """A captured and an eager system on the CPU holding the same n random
    keyframes, descriptors drawn from a small pool (so they match)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, (96, 8), dtype=np.uint32)
    systems = [system.SLAMSystem(_host_cfg(pcm), device="cpu", capture=c) for c in (True, False)]
    for i in range(n):
        pose, world = _rand_pose(rng), rng.uniform(-5, 5, (32, 3)).astype(np.float32)
        desc = pool[rng.integers(0, 96, 32)]
        for s in systems:
            _add_port_keyframe(s, i, pose, world, desc)
            s.keyframes[-1].anchors = [(25 * i, pose)]  # what a snapshot keeps
    return systems


def _dispatch_equal(cap, eager, kidx):
    for s in (cap, eager):
        s._dispatch_loop_closure(s.keyframes[kidx])
    a, b = cap._closure_pending[-1], eager._closure_pending[-1]
    assert a[:2] == b[:2]
    _assert_bit_equal(a[2:], b[2:], f"dispatch of keyframe {kidx}")
    assert (a[2] >= 0).any()
    return a


def test_captured_kf_match_across_doubling_and_rebuild(tmp_path):
    cap, eager = _kf_systems(70, seed=5)  # past the store's first 64 rows
    for kidx in (10, 40, 69):
        _dispatch_equal(cap, eager, kidx)
    F, W = 32, 8
    assert sorted(cap._match_steps) == [(64, F, W), (128, F, W)] and not eager._match_steps
    # the store is the static input of its shape's step
    assert cap._kf_desc_dev is cap._match_steps[(128, F, W)].inputs["db"]
    # a snapshot of other keyframes, loaded into both: the rebuilt store
    # (64 rows again) is written into the buffers the 64-row graph reads
    other, other_eager = _kf_systems(40, seed=6)
    other.save_checkpoint(str(tmp_path / "snap"))
    for s in (cap, eager):
        s.load_checkpoint(str(tmp_path / "snap"))
    assert cap._kf_desc_dev is cap._match_steps[(64, F, W)].inputs["db"]
    assert torch.equal(cap._kf_desc_dev, other_eager._kf_desc_dev)
    _, n_old, fwd, _ = _dispatch_equal(cap, eager, 39)
    # the store before the snapshot's, as the 64-row graph last read it
    old = np.stack([k.desc for k in _kf_systems(64, seed=5)[1].keyframes])
    _, (stale, _) = system._kf_match_step(0.8)((), {
        "qd": torch.as_tensor(eager.keyframes[39].desc), "qv": torch.ones(F, dtype=torch.bool),
        "db": torch.as_tensor(old), "dbv": torch.ones(64, F, dtype=torch.bool),
        "n_old": torch.full((), n_old)})
    assert not torch.equal(fwd, stale)


def test_captured_run_ba_equals_eager(desk):
    """`run_ba` on config 2's small desk system (tests/test_torch_capture.py),
    captured against eager: the dedup's ids and store, the solve's costs,
    poses and points, the keyframe poses."""
    cfg, images, odom = desk
    systems = [system.SLAMSystem(cfg, device="cpu", capture=c) for c in (True, False)]
    for s in systems:
        for t in range(SYS_FRAMES):
            s.process_frame(images[t], odom[t])
    cap, eager = systems
    assert len(eager.keyframes) >= 2
    probs = [s.ba_problem() for s in systems]
    _assert_bit_equal(probs[0], probs[1], "the BA problem (dedup ids and store)")
    res = [s.run_ba(iters=3) for s in systems]
    _assert_bit_equal((res[0].costs, res[0].pcg_residuals, res[0].problem),
                      (res[1].costs, res[1].pcg_residuals, res[1].problem), "run_ba")
    assert [k.pose.tobytes() for k in cap.keyframes] == [k.pose.tobytes() for k in eager.keyframes]
    assert cap._dedup_steps and cap._ba_solver.steps and not eager._dedup_steps
    assert eager._ba_solver is None


# -- (c) against JAX ---------------------------------------------------------------


@pytest.mark.parametrize("solver,edges", [("pcg", False), ("dense", False), ("pcg", True)])
def test_captured_ba_matches_jax(solver, edges):
    """tests/test_torch_ba.py's ring fixtures through the captured solve."""
    key = jax.random.PRNGKey(5 if edges else 3)
    jcam, prob, gt_poses, _ = _make_ba_problem(key)
    jprob, tprob = _from_jax(prob)
    tcam = t_cam.Pinhole(500.0, 500.0, 320.0, 240.0, 640, 480)
    kw = dict(iters=4 if edges else 3, pcg_iters=60, solver=solver)
    if not edges:
        kw["huber_delta"] = 50.0
    pe = _ring_edges(gt_poses, 100.0) if edges else None
    j_res = j_ba.optimize_ba(jcam, jprob, **kw, pose_edges=None if pe is None else
                             tuple(jnp.asarray(e) for e in pe))
    t_res = ba.optimize_ba(tcam, tprob, **kw, capture=ba.CapturedBA(graph=False),
                           pose_edges=None if pe is None else tuple(torch.as_tensor(e) for e in pe))
    first = None if edges else float(j_ba.ba_cost(jcam, jprob, 50.0))
    _assert_same_run(t_res, j_res, first)
    if first is not None:
        assert _accepts(t_res.costs.numpy(), first)[:2] == [True, True]


@pytest.mark.parametrize("name", ["dedup_order", "capacity_overflow", "pool"])
def test_captured_dedup_matches_jax(name):
    desc, valid, world, cap = _dedup_case(name)
    (jd, jv, jp, jc, jdrop), jpid = j_assign_point_ids(
        jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(world), cap=cap, use_pallas=False,
        max_ham=40)
    (sd, sv, sp, cnt, drop), pid = system._assign_point_ids(
        torch.as_tensor(desc.view(np.int32)), torch.as_tensor(valid), torch.as_tensor(world),
        cap=cap, max_ham=40, steps={})
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jpid))
    assert (int(cnt), int(drop)) == (int(jc), int(jdrop))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(sd.numpy().view(np.uint32), np.asarray(jd))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jp))


def test_captured_kf_match_matches_jax():
    """The match step through its CapturedStep (two calls: the warm-up and
    the captured path) against JAX's `_batched_kf_match` on the store's
    eligible rows, the dispatch's mask."""
    rng = np.random.default_rng(3)
    K, F = 6, 48
    pool = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    store = pool[rng.integers(0, 64, (K, F))]
    sv = rng.uniform(size=(K, F)) > 0.2
    qd = pool[rng.integers(0, 64, F)]
    qv = rng.uniform(size=F) > 0.1
    T = lambda a: torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)  # noqa: E731
    cs = captured.CapturedStep(system._kf_match_step(0.8), (), {
        "qd": T(qd), "qv": T(qv), "db": T(store), "dbv": T(sv),
        "n_old": torch.zeros((), dtype=torch.int64)}, graph=False)
    for n_old in (4, 2):
        cs.inputs["n_old"].fill_(n_old)
        cs()
        fwd, rev = cs.take()
        eligible = np.arange(K) < n_old
        j_fwd, j_rev = j_batched_kf_match(jnp.asarray(qd), jnp.asarray(qv), jnp.asarray(store),
                                          jnp.asarray(sv & eligible[:, None]), ratio=0.8,
                                          use_pallas=False)
        np.testing.assert_array_equal(fwd.numpy(), np.asarray(j_fwd))
        np.testing.assert_array_equal(rev.numpy(), np.asarray(j_rev))
        assert (fwd[:n_old] >= 0).any() and (fwd[n_old:] < 0).all()
