"""Ranks of the port's multi-process CPU tests (imports no jax).

    python tests/torch_dist_worker.py SUITE OUT_DIR

runs one suite of cases on one rank; `spawn` (called from the tests) starts
the ranks with the reference's variables COORDINATOR_ADDRESS, NUM_PROCESSES
and PROCESS_ID set, a free local port, one thread each and a timeout. A
suite reads its inputs from OUT_DIR/inputs.npz (written by the test) and
writes each rank's results to OUT_DIR/<case>_r<rank>.npz (or .json).

The ranks run torch's CPU kernels at ATEN_CPU_CAPABILITY=default. Its AVX
kernels compute the whole vectors of an elementwise op with Sleef and the
tail past them with libm, whose transcendentals round differently, so the
bits of a row would depend on the batch it sits in; at the default
capability every element goes through one function, and a shard's rows
round as the same rows of the whole batch. The one-device runs the sharded
runs are held to run in the same processes.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = str(Path(__file__).resolve().parent.parent)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TIMEOUT = 120  # seconds, for each spawn


def start(suite: str, out_dir, world: int = 2, stdout=subprocess.PIPE) -> list:
    """Start `world` ranks of `suite` (the Popen handles)."""
    from parakeet_slam_tpu_torch.dist.multihost import free_local_port

    port = free_local_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", ATEN_CPU_CAPABILITY="default",
                   COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(world),
                   PROCESS_ID=str(r),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", __file__, suite, str(out_dir)], stdout=stdout,
            stderr=subprocess.PIPE, text=True, cwd=REPO, env=env))
    return procs


def spawn(suite: str, out_dir, world: int = 2, timeout: float = TIMEOUT) -> list[str]:
    """Run `world` ranks of `suite` to their end; returns their stdouts.
    Raises, with each rank's stderr, when a rank fails or the time is out."""
    procs = start(suite, out_dir, world)
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.time(), 1)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1][-3000:] for p in procs]
        raise RuntimeError(f"{suite}: ranks still running after {timeout} s:\n" + "\n".join(errs))
    bad = [(r, p.returncode, e[-3000:]) for r, (p, (_, e)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"{suite}: ranks failed: {bad}")
    return [o for o, _ in outs]


def load(out_dir, case: str, rank: int = 0):
    return np.load(Path(out_dir) / f"{case}_r{rank}.npz")


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def _save(out: Path, case: str, **arrays):
    import torch.distributed as tdist

    rank = tdist.get_rank() if tdist.is_initialized() else 0
    np.savez(out / f"{case}_r{rank}.npz",
             **{k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
                for k, v in arrays.items()})


def _state_arrays(prefix, st):
    from parakeet_slam_tpu_torch.core.state import state_to_numpy

    return {f"{prefix}{k}": v for k, v in state_to_numpy(st).items()}


# -- filter runs -----------------------------------------------------------


def corridor_case(frames=20):
    """(cfg, init pose, per-frame (u, obs)) of the reference's sharded
    corridor test, the draws of one generator."""
    import torch

    from parakeet_slam_tpu_torch.core.config import FilterConfig
    from parakeet_slam_tpu_torch.core.state import Observation
    from parakeet_slam_tpu_torch.data import make_corridor

    cfg = FilterConfig(num_particles=32, max_landmarks=64, max_observations=8, sig_dim=3,
                       motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
                       max_range=6.5, fov_half_angle=2.5)
    sim = make_corridor(num_landmarks=40, num_steps=frames, max_obs=8, seed=5)
    steps = [(torch.as_tensor(sim.odom[t]),
              Observation(z=torch.as_tensor(sim.obs_z[t]), sig=torch.as_tensor(sim.obs_sig[t]),
                          desc=torch.zeros(8, 0, dtype=torch.int32),
                          valid=torch.as_tensor(sim.obs_valid[t])))
             for t in range(frames)]
    return cfg, None, sim.gt_pose[0], steps


# tests/test_ekf3d_kernel.py's camera
H_IMG, W_IMG = 96, 160
FX = 0.6 * W_IMG


def vision_case(model, algorithm, frames=6, P=16, L=32, Z=8, n_valid=6, W=8, seed=3):
    """(cfg, frontend, init poses [P, 7], per-frame (u, obs)) at the shapes
    of tests/test_dist_vision.py: a camera moving forward through a fixed
    landmark set, the nearest in view observed with pixel noise and two
    flipped descriptor bits, from particle poses scattered by 1e-3 (resampling
    at an ESS below 0.9 P, so that the 6 frames resample)."""
    import torch

    from parakeet_slam_tpu_torch.core.config import FilterConfig, FrontendConfig
    from parakeet_slam_tpu_torch.core.state import Observation
    from parakeet_slam_tpu_torch.eval.kernel_inputs import PAR_KEYS, flip_bits, project_np

    fc = FilterConfig(
        num_particles=P, max_landmarks=L, max_observations=Z, lm_dim=3, obs_dim=2, pose_dim=7,
        sig_dim=0, desc_words=W, desc_weight=0.5, measurement_model=model,
        motion_model="se3_odometry", motion_noise=(0.02, 0.01), meas_noise=(2.0, 2.0),
        new_landmark_loglik=-30.0, max_range=50.0, algorithm=algorithm, resample_frac=0.9)
    fe = FrontendConfig(camera="pinhole", baseline=0.3, intrinsics=(FX, FX, W_IMG / 2, H_IMG / 2),
                        image_size=(H_IMG, W_IMG))
    rng = np.random.default_rng(seed)
    n_lm = 3 * Z
    depth = rng.uniform(4.0, 12.0, n_lm)
    u = rng.uniform(20.0, W_IMG - 20.0, n_lm)
    v = rng.uniform(20.0, H_IMG - 20.0, n_lm)
    pts = np.stack([(u - W_IMG / 2) / FX * depth, (v - H_IMG / 2) / FX * depth, depth], 1)
    table = rng.integers(0, 2**32, (n_lm, W), dtype=np.uint32)
    par = tuple(zip(PAR_KEYS, (FX, FX, W_IMG / 2, H_IMG / 2, 0.3, float(W_IMG), float(H_IMG))))
    twist = np.array([0.0, 0.0, 0.05, 0.0, 0.0, 0.0], np.float32)
    steps = []
    for t in range(frames):
        pose = np.array([0.0, 0.0, 0.05 * t, 0.0, 0.0, 0.0, 1.0])
        _, zw = project_np(model, pose, pts, par)
        pick = np.arange(n_valid) + t  # a window moving by one landmark a frame
        z = np.zeros((Z, 2), np.float32)
        z[:n_valid] = zw[pick] + 0.5 * rng.normal(size=(n_valid, 2))
        desc = np.zeros((Z, W), np.uint32)
        desc[:n_valid] = flip_bits(rng, table[pick], 2)
        steps.append((torch.as_tensor(twist if t else np.zeros(6, np.float32)), Observation(
            z=torch.as_tensor(z), sig=torch.zeros(Z, 0), desc=torch.as_tensor(desc.view(np.int32)),
            valid=torch.as_tensor(np.arange(Z) < n_valid))))
    t0 = rng.uniform(-1e-3, 1e-3, (P, 3))
    q = rng.normal(size=(P, 4)) * np.array([1e-3, 1e-3, 1e-3, 1.0])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return fc, fe, np.concatenate([t0, q], 1).astype(np.float32), steps


def _digest(st) -> str:
    """SHA-256 of every leaf's bytes of a state, in field order."""
    import hashlib

    from parakeet_slam_tpu_torch.core.state import state_to_numpy

    h = hashlib.sha256()
    for v in state_to_numpy(st).values():
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def run_filter(fc, fe, init, steps, mesh=None, seed=0, captured_step=False):
    """Run the steps with the draws of one generator: sharded over `mesh`
    (eagerly, or with `captured_step` through `CapturedStep(graph=False)`,
    the captured path's buffer rules, frame by frame), or on one device.
    Returns (per-frame est [T, D], ess [T], resampled [T], match_frac [T],
    the global final state, the global state's digest after each frame)."""
    import torch

    from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
    from parakeet_slam_tpu_torch.filter import captured, make_filter
    from parakeet_slam_tpu_torch.filter.runner import draw_noise

    slam = make_filter(fc, fe)
    P = fc.num_particles
    noise, u0 = draw_noise(len(steps), P, slam.noise_dim, torch.Generator().manual_seed(seed),
                           "cpu")
    if mesh is None:
        st = slam.init_state(device="cpu")
    else:
        sh = ShardedFastSLAM(slam, mesh)
        st = sh.init_state(device="cpu")
    if init is not None:
        init = torch.as_tensor(init)
        full = init.expand(P, -1) if init.dim() == 1 else init
        st = st.replace(pose=(full if mesh is None else sh.local_draws(full)).clone())
    cs = None
    if captured_step:
        u, obs = steps[0]

        def frame(state, x):
            state, m = sh.step(state, x["u"], x["obs"], x["noise"], x["u0"])
            return state, (sh.estimate_pose(state), m)

        cs = captured.CapturedStep(frame, st, {"u": u.clone(), "obs": captured.clone(obs),
                                               "noise": noise[0].clone(), "u0": u0[0].clone()},
                                   graph=False)
    est, ess, res, mf, digests = [], [], [], [], []
    for t, (u, obs) in enumerate(steps):
        if mesh is None:
            st, m = slam.step(st, u, obs, noise[t], u0[t])
            est.append(slam.estimate_pose(st))
        elif cs is not None:
            captured.copy_into(cs.inputs, {"u": u, "obs": obs, "noise": noise[t], "u0": u0[t]})
            cs()
            e, m = cs.take()
            st = cs.state
            est.append(e)
        else:
            st, m = sh.step(st, u, obs, sh.local_draws(noise[t]), u0[t])
            est.append(sh.estimate_pose(st))
        ess.append(float(m.ess))
        res.append(bool(m.resampled))
        mf.append(float(m.match_frac))
        digests.append(_digest(st if mesh is None else sh.gather_state(st)))
    final = st if mesh is None else sh.gather_state(st)
    return torch.stack(est), np.array(ess), np.array(res), np.array(mf), final, digests


def run_sequence_sharded(fc, fe, init, steps, mesh, seed=0):
    """`filter.run_sequence` over the sharded filter with the captured
    path's buffer rules (capture=True, eager on the CPU), on the draws of
    `run_filter`: (est [T, D], resampled [T], the global final state)."""
    import torch

    from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
    from parakeet_slam_tpu_torch.filter import make_filter, run_sequence
    from parakeet_slam_tpu_torch.filter.runner import draw_noise

    slam = make_filter(fc, fe)
    P = fc.num_particles
    noise, u0 = draw_noise(len(steps), P, slam.noise_dim, torch.Generator().manual_seed(seed),
                           "cpu")
    sh = ShardedFastSLAM(slam, mesh)
    st = sh.init_state(device="cpu")
    if init is not None:
        init = torch.as_tensor(init)
        st = st.replace(pose=sh.local_draws(init.expand(P, -1) if init.dim() == 1
                                            else init).clone())
    seq = [torch.stack([getattr(o, k) for _, o in steps]) for k in ("z", "sig", "valid")]
    st, est, metrics = run_sequence(sh, st, torch.stack([u for u, _ in steps]), *seq,
                                    motion_noise=noise, resample_u0=u0,
                                    obs_desc=torch.stack([o.desc for _, o in steps]),
                                    capture=True)
    return est, np.array([bool(m.resampled) for m in metrics]), sh.gather_state(st)


def _filter_runs(out, mesh, rank):
    cases = {
        "corridor": corridor_case(),
        "equirect_fs1": vision_case("equirect_3d", "fastslam1"),
        "pinhole_fs2": vision_case("pinhole_3d", "fastslam2"),
    }
    for name, (fc, fe, init, steps) in cases.items():
        est, ess, res, mf, final, dig = run_filter(fc, fe, init, steps, mesh)
        estc, essc, resc, mfc, finalc, digc = run_filter(fc, fe, init, steps, mesh,
                                                         captured_step=True)
        ests, ress, finals = run_sequence_sharded(fc, fe, init, steps, mesh)
        rec = dict(est=est, ess=ess, resampled=res, match_frac=mf, digests=np.array(dig),
                   est_c=estc, ess_c=essc, resampled_c=resc, match_frac_c=mfc,
                   digests_c=np.array(digc), est_seq=ests, resampled_seq=ress,
                   **_state_arrays("s_", final), **_state_arrays("c_", finalc),
                   **_state_arrays("q_", finals))
        if rank == 0:
            est1, ess1, res1, mf1, final1, dig1 = run_filter(fc, fe, init, steps)
            rec.update(est1=est1, ess1=ess1, resampled1=res1, match_frac1=mf1,
                       digests1=np.array(dig1), **_state_arrays("o_", final1))
        _save(out, name, **rec)


def _resample_semantics(out, mesh):
    """tests/test_dist.py::test_resampling_preserves_global_semantics."""
    import torch

    from parakeet_slam_tpu_torch.core.config import FilterConfig
    from parakeet_slam_tpu_torch.core.state import Observation
    from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
    from parakeet_slam_tpu_torch.filter import FastSLAM

    cfg = FilterConfig(num_particles=16, max_landmarks=64, max_observations=8, sig_dim=3,
                       motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
                       max_range=6.5, fov_half_angle=2.5, resample_frac=0.9)
    sh = ShardedFastSLAM(FastSLAM(cfg), mesh)
    st = sh.init_state(device="cpu")
    lw = torch.full((16,), -100.0)
    lw[5] = 10.0
    mean, valid, count = st.lm_mean.clone(), st.lm_valid.clone(), st.lm_count.clone()
    mean[:, 0, 0] = sh.local_draws(torch.arange(16, dtype=torch.float32))
    valid[:, 0] = True
    count[:, 0] = 100
    st = st.replace(log_w=sh.local_draws(lw), lm_mean=mean, lm_valid=valid, lm_count=count)
    obs = Observation(z=torch.zeros(1, 2), sig=torch.zeros(1, 3),
                      desc=torch.zeros(1, 0, dtype=torch.int32), valid=torch.tensor([False]))
    noise = torch.randn(16, 3, generator=torch.Generator().manual_seed(1))
    st, m = sh.step(st, torch.zeros(3), obs, sh.local_draws(noise), torch.tensor(0.3 / 16))
    full = sh.gather_state(st)
    _save(out, "resample_semantics", resampled=bool(m.resampled), marker=full.lm_mean[:, 0, 0],
          log_w=full.log_w)


def _mesh_checks(out, rank):
    import torch

    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod

    rec = {}
    for name, map_axis in (("ici2", 1), ("dcn2", 2)):
        m = mesh_mod.make_mesh(map_axis=map_axis)
        rec[name] = {
            "shape": m.shape, "ranks": list(m.ranks),
            "index": {a: m.axis_index(a) for a in (mesh_mod.MAP_AXIS, mesh_mod.PARTICLE_AXIS)},
            "line": {a: m.axis_ranks(a) for a in (mesh_mod.MAP_AXIS, mesh_mod.PARTICLE_AXIS)},
            "sum": {a: float(mesh_mod.all_reduce_sum(torch.tensor(rank + 1.0), m, a))
                    for a in (mesh_mod.MAP_AXIS, mesh_mod.PARTICLE_AXIS)},
            "gather": mesh_mod.all_gather_rows(torch.tensor([rank, rank]), m).tolist(),
            "rows": [mesh_mod.particle_sharding(m).rows(8).start,
                     mesh_mod.landmark_block_sharding(m).rows(8).start],
        }
    (out / f"mesh_r{rank}.json").write_text(json.dumps(rec))


def _ring_gathers(out, mesh, rank):
    import torch

    from parakeet_slam_tpu_torch.core.state import ParticleState
    from parakeet_slam_tpu_torch.dist.sharded_filter import ring_gather_rows

    inp = np.load(out / "inputs.npz")
    T = lambda a: torch.as_tensor(a)  # noqa: E731

    def mine(a):
        n = a.shape[0] // 2
        return T(a[rank * n:(rank + 1) * n])

    got = ring_gather_rows({"x": mine(inp["array_payload"])}, mine(inp["array_idx"]), mesh)
    tree = ring_gather_rows({"a": mine(inp["tree_a"]), "b": mine(inp["tree_b"])},
                            mine(inp["tree_idx"]), mesh)
    st = ParticleState(**{f: mine(inp[f"state_{f}"]) for f in (
        "pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_desc", "lm_valid", "lm_count")})
    gst = ring_gather_rows(st, mine(inp["state_idx"]), mesh)
    _save(out, "ring_gather", array=got["x"], tree_a=tree["a"], tree_b=tree["b"],
          **_state_arrays("state_", gst))


class HostRead(AssertionError):
    pass


def host_read_patches() -> list:
    """(object, attribute, replacement) of the host-read guard: the
    Python-level reads of the device on the host and copies from it,
    `Tensor.__bool__`, `item`, `tolist`, `cpu`, `numpy`, `__int__`,
    `__float__`, `__index__`, `nonzero`, `torch.tensor`, `torch.as_tensor`,
    `torch.nonzero` and `torch.masked_select`, raise `HostRead`, and so does
    indexing with a 0-dim tensor (torch reads it on the host) or a boolean
    one (through `nonzero`). tests/test_torch_capture.py applies them with
    monkeypatch, the ranks here with `no_host_reads`."""
    import torch

    def refuse(name):
        def fn(*args, **kwargs):
            raise HostRead(f"{name} inside the step")

        return fn

    def device_index_only(get):
        def checked(self, idx, *value):
            for i in (idx if isinstance(idx, tuple) else (idx,)):
                if isinstance(i, torch.Tensor) and (i.dim() == 0 or i.dtype == torch.bool):
                    raise HostRead("indexing with a 0-dim or boolean tensor inside the step")
            return get(self, idx, *value)

        return checked

    return ([(torch.Tensor, n, refuse(f"Tensor.{n}")) for n in (
        "__bool__", "item", "tolist", "cpu", "numpy", "__int__", "__float__", "__index__",
        "nonzero")]
        + [(torch, n, refuse(f"torch.{n}")) for n in ("tensor", "as_tensor", "nonzero",
                                                       "masked_select")]
        + [(torch.Tensor, n, device_index_only(getattr(torch.Tensor, n)))
           for n in ("__getitem__", "__setitem__")])


@contextlib.contextmanager
def no_host_reads():
    """`host_read_patches` applied inside the block."""
    saved = []
    for obj, name, fn in host_read_patches():
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


def _host_read_guard(out, mesh, rank):
    """One eager sharded step with a resample and one without (the ring
    gather runs in both), the estimate and `best_particle_lanes`, each
    under `no_host_reads` after an unguarded warm-up frame: "ok" or what
    raised, and whether each guarded frame resampled."""
    import torch

    from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
    from parakeet_slam_tpu_torch.filter import make_filter
    from parakeet_slam_tpu_torch.filter.runner import draw_noise

    fc, fe, init, steps = corridor_case()
    slam = make_filter(fc, fe)
    sh = ShardedFastSLAM(slam, mesh)
    noise, u0 = draw_noise(len(steps), fc.num_particles, slam.noise_dim,
                           torch.Generator().manual_seed(0), "cpu")
    box = [sh.init_state(device="cpu")]

    def frame(t):
        u, obs = steps[t]
        box[0], m = sh.step(box[0], u, obs, sh.local_draws(noise[t]), u0[t])
        return m

    frame(0)
    rec = {}
    calls = {"frame_1": lambda: frame(1), "frame_2": lambda: frame(2),
             "estimate": lambda: sh.estimate_pose(box[0]),
             "best_particle_lanes": lambda: sh.best_particle_lanes(box[0])}
    for name, fn in calls.items():
        try:
            with no_host_reads():
                got = fn()
        except HostRead as e:
            rec[name] = str(e)
            continue
        rec[name] = "ok"
        if name.startswith("frame"):
            rec[f"{name}_resampled"] = bool(got.resampled)
    (out / f"guard_r{rank}.json").write_text(json.dumps(rec))


def _best_lanes(out, mesh):
    """`best_particle_lanes` of the test's states (ties of the top weight
    within and across ranks, -0.0 lanes) on this rank's rows."""
    import torch

    from parakeet_slam_tpu_torch.core.config import FilterConfig
    from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
    from parakeet_slam_tpu_torch.filter import FastSLAM

    inp = np.load(out / "inputs.npz")
    cfg = FilterConfig(num_particles=16, max_landmarks=8, max_observations=4, sig_dim=3)
    sh = ShardedFastSLAM(FastSLAM(cfg), mesh)
    rec = {}
    for case in ("tie_rank0", "tie_rank1", "tie_across"):
        st = sh.init_state(device="cpu")
        st = st.replace(**{f: sh.local_draws(torch.as_tensor(inp[f"lanes_{f}"])).clone()
                           for f in ("lm_mean", "lm_valid", "lm_desc", "lm_count")},
                        log_w=sh.local_draws(torch.as_tensor(inp[f"lanes_log_w_{case}"])).clone())
        got = sh.best_particle_lanes(st)
        rec.update({f"{case}_{k}": v for k, v in zip(("mean", "valid", "desc", "count"), got)})
    _save(out, "lanes", **rec)


CLI_ARGS = ["run", "--config", "configs/panoramic.yaml", "--device", "cpu", "--set",
            "filter.num_particles=8", "filter.max_landmarks=64", "filter.max_observations=16",
            "frontend.image_size=[48,96]", "frontend.max_features=16", "data.num_steps=5",
            "backend.max_keyframes=16"]


def suite_dist(out: Path):
    """`cli run` under the process group (started from the environment
    before it, so that it outlives the runs: `cmd_run` destroys only a
    group it started itself), the mesh, the ring gather, the sharded filter
    against the one-device filter, the reference's resampling case and the
    scaling harness."""
    import torch.distributed as tdist

    from parakeet_slam_tpu_torch import cli
    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost
    from parakeet_slam_tpu_torch.eval.scaling import measure_scaling

    initialize_multihost()
    texts = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(CLI_ARGS + ["dist.particle_axis=2", "dist.map_axis=1"])
    texts["sharded"] = buf.getvalue()
    rank = tdist.get_rank()
    if rank == 0:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(CLI_ARGS + ["dist.particle_axis=1", "dist.map_axis=1"])
        texts["one_device"] = buf.getvalue()
    (out / f"cli_r{rank}.json").write_text(json.dumps(texts))
    _mesh_checks(out, rank)
    mesh = mesh_mod.make_mesh()
    _ring_gathers(out, mesh, rank)
    _resample_semantics(out, mesh)
    _filter_runs(out, mesh, rank)
    _host_read_guard(out, mesh, rank)
    _best_lanes(out, mesh)
    rows = measure_scaling(device="cpu", particles_per_device=16, max_landmarks=64, steps=3)
    (out / f"scaling_r{rank}.json").write_text(json.dumps(rows))


# -- ring match, reshard, BA -----------------------------------------------


def suite_ring(out: Path):
    import torch

    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost
    from parakeet_slam_tpu_torch.dist.ring_match import ring_hamming_top2, ring_match

    initialize_multihost()
    mesh = mesh_mod.make_mesh()
    rows = mesh_mod.particle_sharding(mesh)
    inp = np.load(out / "inputs.npz")
    res = {}
    for case in ("random", "ties"):
        qd = torch.as_tensor(inp[f"{case}_qd"])
        db, dbv = torch.as_tensor(inp[f"{case}_db"]), torch.as_tensor(inp[f"{case}_dbv"])
        qv = torch.ones(qd.shape[0], dtype=torch.bool)
        bi, b1, b2 = ring_hamming_top2(qd, qv, rows.take(db), rows.take(dbv), mesh)
        res.update({f"{case}_bi": bi, f"{case}_b1": b1, f"{case}_b2": b2})
        # through its CapturedStep (the captured path's buffer rules), twice:
        # the second call runs the same step over its static buffers
        for k in range(2):
            got = ring_hamming_top2(qd, qv, rows.take(db), rows.take(dbv), mesh, capture=True)
            res.update({f"cap{k}_{case}_{n}": v for n, v in zip(("bi", "b1", "b2"), got)})
    db = torch.as_tensor(inp["hit_db"])
    args = (db[77:79], torch.ones(2, dtype=torch.bool), rows.take(db),
            torch.ones(db.shape[0] // 2, dtype=torch.bool), mesh)
    idx, dist = ring_match(*args)
    for k in range(2):
        res[f"cap{k}_hit_idx"], res[f"cap{k}_hit_dist"] = ring_match(*args, capture=True)
    res["programs"] = np.array(len(mesh.programs))
    _save(out, "ring", hit_idx=idx, hit_dist=dist, **res)


def suite_reshard(out: Path):
    import torch

    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost
    from parakeet_slam_tpu_torch.dist.reshard import reshard_landmark_to_camera

    initialize_multihost()
    mesh = mesh_mod.make_mesh(map_axis=2)
    rows = mesh_mod.landmark_block_sharding(mesh)
    inp = np.load(out / "inputs.npz")
    T = lambda k: rows.take(torch.as_tensor(inp[k]))  # noqa: E731
    c, p, uv, v, ovf = reshard_landmark_to_camera(
        T("obs_cam"), T("obs_pt"), T("obs_uv"), T("obs_valid"), mesh=mesh,
        axis=mesh_mod.MAP_AXIS, cams_per_shard=int(inp["cams_per_shard"]),
        capacity=int(inp["capacity"]))
    _save(out, "reshard", cam=c, pt=p, uv=uv, valid=v, overflow=ovf)


def ba_inputs(inp, device="cpu"):
    from parakeet_slam_tpu_torch.backend.graph import ba_problem_from_numpy
    from parakeet_slam_tpu_torch.frontend.camera import Pinhole

    cam = Pinhole(*[float(x) for x in inp["camera"][:4]], *[int(x) for x in inp["camera"][4:]])
    prob = ba_problem_from_numpy({k[5:]: inp[k] for k in inp.keys() if k.startswith("prob_")},
                                 device=device)
    return cam, prob


BA_KW = dict(iters=6, pcg_iters=60, huber_delta=50.0)


def suite_ba(out: Path):
    from parakeet_slam_tpu_torch.dist import dist_ba
    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost

    initialize_multihost()
    cam, prob = ba_inputs(np.load(out / "inputs.npz"))
    m1 = mesh_mod.make_mesh(map_axis=2)
    p1, c1 = dist_ba.optimize_ba_distributed(cam, dist_ba.shard_problem(prob, 2), m1, **BA_KW)
    m2 = mesh_mod.make_mesh(map_axis=1)
    p2, c2 = dist_ba.optimize_ba_distributed_2d(cam, dist_ba.shard_problem_2d(prob, 1, 2), m2,
                                                **BA_KW)
    # the captured path's buffer rules (capture=True, eager on the CPU)
    q1, d1 = dist_ba.optimize_ba_distributed(cam, dist_ba.shard_problem(prob, 2), m1,
                                             capture=True, **BA_KW)
    q2, d2 = dist_ba.optimize_ba_distributed_2d(cam, dist_ba.shard_problem_2d(prob, 1, 2), m2,
                                                capture=True, **BA_KW)
    _save(out, "ba", cam_1d=p1.cam_pose, pts_1d=p1.points, costs_1d=c1,
          cam_2d=p2.cam_pose, pts_2d=p2.points, costs_2d=c2,
          cap_cam_1d=q1.cam_pose, cap_pts_1d=q1.points, cap_costs_1d=d1,
          cap_cam_2d=q2.cam_pose, cap_pts_2d=q2.points, cap_costs_2d=d2)


def suite_ba4(out: Path):
    """The 1-D distributed BA at S = 4 (one point block a rank), and the
    config-5 demo's BA rows at S = 1, 2, 4 on both its problems, small."""
    import torch.distributed as tdist

    from parakeet_slam_tpu_torch.dist import dist_ba
    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost
    from parakeet_slam_tpu_torch.eval import config5_demo as demo

    initialize_multihost()
    cam, prob = ba_inputs(np.load(out / "inputs.npz"))
    mesh = mesh_mod.make_mesh(map_axis=4)
    p, c = dist_ba.optimize_ba_distributed(cam, dist_ba.shard_problem(prob, 4), mesh, **BA_KW)
    _save(out, "ba4", cam=p.cam_pose, pts=p.points, costs=c)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = {"ring": demo.demo_dist_ba(Pts=300, iters=4, pcg_iters=30, lam=1e-4,
                                          device="cpu", problem="ring"),
                "bench": demo.demo_dist_ba(Pts=1000, iters=2, pcg_iters=5, device="cpu",
                                           obs_per_cam=200)}
    (out / f"demo_ba_r{tdist.get_rank()}.json").write_text(json.dumps(rows))


# -- the system, and recovery ------------------------------------------------


def pano_config(particle_axis, map_axis):
    """tests/test_config5_sharded.py's configuration."""
    from parakeet_slam_tpu_torch.core import config as cm

    return cm.SLAMConfig(
        filter=cm.FilterConfig(
            num_particles=32, max_landmarks=256, max_observations=24, lm_dim=3, obs_dim=2,
            pose_dim=7, sig_dim=0, desc_words=8, measurement_model="equirect_3d",
            motion_model="se3_odometry", motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0),
            init_range_prior=14.0, init_range_sigma=8.0, new_landmark_loglik=-14.0,
            max_range=45.0),
        frontend=cm.FrontendConfig(detector="fast", max_features=48, fast_threshold=0.12,
                                   camera="equirect", image_size=(96, 192)),
        backend=cm.BackendConfig(max_keyframes=16, max_landmarks=512, keyframe_translation=1.0,
                                 keyframe_rotation=0.4, gn_iters=3, pcg_iters=10),
        dist=cm.DistConfig(particle_axis=particle_axis, map_axis=map_axis),
    )


SYSTEM_FRAMES, SYSTEM_CUT = 12, 6


def _drive(sys_, world, images, frames, save_at=None, prefix=None):
    import torch

    est = []
    for t in frames:
        est.append(sys_.process_frame(images[t], world.odom[t]))
        if save_at is not None and t + 1 == save_at:
            sys_.save_checkpoint(prefix)
    sys_.flush_flags()
    return torch.stack(est)


def _system_record(sys_, est):
    kfs = sys_.keyframes
    st = sys_._sharded.gather_state(sys_.state) if sys_._sharded is not None else sys_.state
    return dict(est=est, kf_pose=np.stack([k.pose for k in kfs]),
                kf_points=np.stack([k.points_kf for k in kfs]),
                kf_desc=np.stack([k.desc for k in kfs]), kf_valid=np.stack([k.valid for k in kfs]),
                kf_frame=np.array([k.frame for k in kfs]),
                closures=np.array(sys_.loop_closures, np.int32).reshape(-1, 2),
                graph_poses=sys_.graph.poses, **_state_arrays("st_", st))


def suite_system(out: Path):
    """The sharded SLAMSystem (particle_axis=2) against the one-device
    system on the same draws; the sharded snapshot resumed by a sharded and
    by a one-device system; the distributed BA, 1 x 2 and 2 x 1."""
    import torch.distributed as tdist

    from parakeet_slam_tpu_torch.data.panoramic import make_panoramic_world
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost
    from parakeet_slam_tpu_torch.system import SLAMSystem

    initialize_multihost()
    rank = tdist.get_rank()
    world = make_panoramic_world(num_landmarks=100, num_steps=SYSTEM_FRAMES,
                                 image_size=(96, 192), seed=5)
    images = [world.render(t) for t in range(SYSTEM_FRAMES)]
    frames = range(SYSTEM_FRAMES)
    snap = str(out / "snap")
    sharded = SLAMSystem(pano_config(2, 1), device="cpu")
    est = _drive(sharded, world, images, frames, SYSTEM_CUT, snap)
    rec = _system_record(sharded, est)
    rec["sharded"] = sharded._sharded is not None and sharded.mesh.shape["ici"] == 2
    res_d = sharded.run_ba(iters=3, distributed=True)
    rec["ba_cost_sharded"] = res_d.costs
    # the snapshot resumed on the mesh
    resumed = SLAMSystem(pano_config(2, 1), device="cpu")
    resumed.load_checkpoint(snap)
    rec["est_resumed_sharded"] = _drive(resumed, world, images, range(SYSTEM_CUT, SYSTEM_FRAMES))
    # the captured path's buffer rules on the mesh (capture=True: eager on
    # the CPU), and its snapshot resumed by another captured system
    cap = SLAMSystem(pano_config(2, 1), device="cpu", capture=True)
    est_c = _drive(cap, world, images, frames, SYSTEM_CUT, str(out / "snap_cap"))
    rec.update({f"cap_{k}": v for k, v in _system_record(cap, est_c).items()})
    rec["cap_capture"] = cap.capture and cap._sharded is not None
    rec["cap_ba_cost_sharded"] = cap.run_ba(iters=3, distributed=True).costs
    cap_resumed = SLAMSystem(pano_config(2, 1), device="cpu", capture=True)
    cap_resumed.load_checkpoint(str(out / "snap_cap"))
    rec["cap_est_resumed"] = _drive(cap_resumed, world, images, range(SYSTEM_CUT, SYSTEM_FRAMES))
    # the distributed BA over two point blocks (the filter replicated on dcn)
    dcn = SLAMSystem(pano_config(1, 2), device="cpu")
    dcn.load_checkpoint(snap)
    _drive(dcn, world, images, range(SYSTEM_CUT, SYSTEM_FRAMES))
    rec["ba_dcn2_auto"] = dcn.run_ba(iters=3).costs
    if rank == 0:
        one = SLAMSystem(pano_config(1, 1), device="cpu")
        est1 = _drive(one, world, images, frames)
        rec.update({f"one_{k}": v for k, v in _system_record(one, est1).items()})
        rec["one_sharded"] = one._sharded is not None
        res_s = one.run_ba(iters=3, distributed=False)
        rec["ba_cost_one"] = res_s.costs
        resumed1 = SLAMSystem(pano_config(1, 1), device="cpu")
        resumed1.load_checkpoint(snap)
        rec["est_resumed_one"] = _drive(resumed1, world, images,
                                        range(SYSTEM_CUT, SYSTEM_FRAMES))
    _save(out, "system", **rec)
    _demo(out, rank)


def _demo(out, rank):
    """eval/config5_demo's rows at small sizes."""
    from parakeet_slam_tpu_torch.eval import config5_demo as demo

    rows = {
        "online": demo.demo_online_sharded(n_frames=3, L=1024, P=8, Z=16, device="cpu",
                                           image_size=(48, 96)),
        "ring_match": demo.demo_ring_match(M=2048, N=32, device="cpu"),
        "dist_ba": demo.demo_dist_ba(Pts=1000, iters=2, pcg_iters=5, device="cpu",
                                     obs_per_cam=200),
    }
    (out / f"demo_r{rank}.json").write_text(json.dumps(rows))


RECOVER_STEPS, RECOVER_EVERY = 40, 4


def _recover_setup():
    import torch

    from parakeet_slam_tpu_torch.core.config import FilterConfig
    from parakeet_slam_tpu_torch.core.state import Observation
    from parakeet_slam_tpu_torch.data import make_corridor
    from parakeet_slam_tpu_torch.filter import make_filter

    sim = make_corridor(num_landmarks=40, num_steps=RECOVER_STEPS, max_obs=8, seed=5)
    cfg = FilterConfig(num_particles=16, max_landmarks=96, max_observations=8, sig_dim=3,
                       motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
                       max_range=6.5, fov_half_angle=2.5)
    slam = make_filter(cfg)

    def frame(t):
        """Step t's inputs and draws (a generator per step: a resumed run
        draws what the uninterrupted one drew)."""
        g = torch.Generator().manual_seed(1000 + t)
        obs = Observation(z=torch.as_tensor(sim.obs_z[t]), sig=torch.as_tensor(sim.obs_sig[t]),
                          desc=torch.zeros(8, 0, dtype=torch.int32),
                          valid=torch.as_tensor(sim.obs_valid[t]))
        noise = torch.randn(16, slam.noise_dim, generator=g)
        return torch.as_tensor(sim.odom[t]), obs, noise, torch.rand((), generator=g) / 16

    return slam, sim.gt_pose[0], frame


def suite_recover_run(out: Path):
    """The corridor filter sharded over 2 ranks, snapshotting the gathered
    state every RECOVER_EVERY steps on rank 0; it prints each step and is
    held at 0.25 s a step, so that the test's SIGKILL lands mid-run."""
    import torch.distributed as tdist

    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost, snapshot_every
    from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM

    initialize_multihost()
    slam, pose0, frame = _recover_setup()
    sh = ShardedFastSLAM(slam, mesh_mod.make_mesh())
    st = sh.init_state(init_pose=pose0, device="cpu")
    snap = snapshot_every(str(out / "snaps"), RECOVER_EVERY)
    for t in range(RECOVER_STEPS):
        u, obs, noise, u0 = frame(t)
        st, _ = sh.step(st, u, obs, sh.local_draws(noise), u0)
        full = sh.gather_state(st)
        snap(full, t + 1)
        if tdist.get_rank() == 0:
            print(f"STEP {t + 1}", flush=True)
        time.sleep(0.25)


def suite_recover_resume(out: Path):
    """World size 1: resume from the latest snapshot, run to the end; and
    the uninterrupted one-device run."""
    from parakeet_slam_tpu_torch.dist.multihost import resume_or_init

    slam, pose0, frame = _recover_setup()

    def init_fn():
        return slam.init_state(init_pose=pose0, device="cpu")

    def run(st, start):
        for t in range(start, RECOVER_STEPS):
            u, obs, noise, u0 = frame(t)
            st, _ = slam.step(st, u, obs, noise, u0)
        return st

    st, start = resume_or_init(str(out / "snaps"), init_fn(), init_fn)
    resumed = run(st, start)
    whole = run(init_fn(), 0)
    _save(out, "recover", start=start, est=slam.estimate_pose(resumed),
          est_whole=slam.estimate_pose(whole), **_state_arrays("r_", resumed),
          **_state_arrays("w_", whole))


# `cli run` on the panoramic config cut to a CPU's size, sharded 2 x 1 over
# the 2 ranks
CLI_RUN_SET = ["filter.num_particles=8", "filter.max_landmarks=128",
               "filter.max_observations=16", "frontend.image_size=[64,128]",
               "frontend.max_features=32", "data.num_landmarks=200", "data.num_steps=6",
               "backend.max_keyframes=16", "dist.particle_axis=2", "dist.map_axis=1"]


def suite_cli_run(out: Path):
    """`cli run` under the group that `cmd_run` starts from the variables:
    after it returns, the rank records whether a group is left and how many
    systems (each owning its captured programs) are still alive."""
    import gc

    import torch.distributed as tdist

    from parakeet_slam_tpu_torch import cli, system

    cli.main(["run", "--config", "configs/panoramic.yaml", "--device", "cpu",
              "--set", *CLI_RUN_SET])
    rank = int(os.environ["PROCESS_ID"])
    alive = sum(isinstance(o, system.SLAMSystem) for o in gc.get_objects())
    (out / f"cli_run_r{rank}.json").write_text(json.dumps(
        {"group_left": tdist.is_initialized(), "systems_alive": alive}))


SUITES = {
    "dist": suite_dist, "ring": suite_ring, "reshard": suite_reshard, "ba": suite_ba, "ba4": suite_ba4,
    "system": suite_system, "recover_run": suite_recover_run,
    "recover_resume": suite_recover_resume, "cli_run": suite_cli_run,
}


def main():
    import torch
    import torch.distributed as tdist

    torch.set_num_threads(1)
    suite, out = sys.argv[1], Path(sys.argv[2])
    SUITES[suite](out)
    if tdist.is_initialized():
        tdist.barrier()
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()
