"""The `pano_online` cell (`panoramic.online4`) on the CPU at a tiny size:
the world (`worlds/pano_field.py`) comes back the same from the seed, and
built in chunks of frames as at once; the driver on two gloo ranks reads
`correct: true` against the reference; and it reads `correct: false` for
each fault the cell can have (the ring gather left out, the keyframe
snapshot taken from rank 0's best particle instead of the owner's, one
rank's keyframe list altered) and for a control run; and
`ring_gather_roofline`'s arithmetic on a known shape.

Run as a script, the file is one rank of the tiny cell:

    python slambench/tests/test_slambench_pano_online.py FAULT OUT_DIR

with the process-group variables set (`_spawn` sets them); it writes the
rank's verdict and checks to OUT_DIR/FAULT_r<rank>.json."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELL = "panoramic.online4"
# the cell at a tiny size: a 4,000-landmark world, 40 warm-up frames and a
# supply of 0.5 x 120 s + 4 = 64 more, which the window uses up long before
# its 120 s however loaded the CPU (so it always reaches its checked
# stretch); 64 particles of 128 lanes over two ranks, 32 observations a
# frame and 64-row keyframe snapshots, 10 landmarks a metre
TINY_PARAMS = {"landmarks": 4000, "landmarks_per_m": 10.0, "max_rate_fps": 0.5,
               "warmup_frames": 40,
               "checked_window_frames": [2, 12], "stretch_search_frames": 24, "trace_frames": 2,
               "chunk_frames": 16}
TINY_RUN = {"filter": {"num_particles": 64, "max_landmarks": 128, "max_observations": 32},
            "frontend": {"max_features": 64}, "backend": {"max_keyframes": 64},
            "dist": {"particle_axis": 2}}
SECONDS = 120.0
FAULTS = ["none", "ring_left_out", "snapshot_rank0", "keyframes_altered", "control", "traced"]
# The world's frames collapse the weights (an effective sample size near 1)
# and resample every frame, which resets every weight: the best particle is
# then the first, rank 0's, and a snapshot from rank 0 reads as the owner's.
# The snapshot's fault is run with no resample, so that the best particle
# lies on either rank, and at 16 particles, whose best moves between the
# ranks within the checked stretch.
FAULT_RUN = {"snapshot_rank0": {"filter": {"resample_frac": 0.0, "num_particles": 16}}}


def tiny_cell(fault: str = "none"):
    from slambench.harness import spec

    cell = spec.load_cell(ROOT, CELL)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic["params"].update(TINY_PARAMS)
    for sec, vals in (*TINY_RUN.items(), *FAULT_RUN.get(fault, {}).items()):
        cell.config["run"][sec].update(vals)
    return cell


def _field(chunk, frames=60, seed=2**31 + 5):
    from slambench.worlds.pano_field import PanoField

    p = dict(tiny_cell().traffic["params"], chunk_frames=chunk)
    return PanoField(p, seed, "cpu", frames, 24, 8, (1024, 2048), 10.0, chunk=chunk)


def _fields(f):
    return {k: getattr(f, k) for k in ("odom", "z", "desc", "valid", "landmark", "points",
                                       "table")}


def test_pano_field_reproduces_from_the_seed_and_its_chunks():
    import torch

    a, b, whole = _fields(_field(7)), _fields(_field(7)), _fields(_field(100))
    other = _fields(_field(7, seed=2**31 + 6))
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], whole[k]), k
    assert not torch.equal(a["z"], other["z"])
    assert a["valid"].all() and (a["landmark"] >= 0).all()
    # the walk goes forward: no landmark is seen again once it has left view
    seen = a["landmark"]
    last = {int(j): t for t in range(seen.shape[0]) for j in seen[t]}
    first = {}
    for t in range(seen.shape[0]):
        for j in seen[t].tolist():
            first.setdefault(j, t)
    for j, t0 in first.items():
        frames = [t for t in range(t0, last[j] + 1) if j in set(seen[t].tolist())]
        assert len(frames) >= (last[j] - t0 + 1) // 2


def test_ring_gather_roofline_arithmetic():
    """Config 5's ring on four ranks: three blocks of 256 particles' packed
    rows a frame (pose, mean, covariance, descriptor, validity and count
    of 8,192 lanes), sent in 2 ms, against 478.125 GB/s each way."""
    from slambench.harness import spec

    mod = spec.load_module(os.path.join(ROOT, "slambench", "metrics", "ring_gather_roofline.py"),
                           "ring_gather_roofline")
    pad = lambda n: -(-n // 16) * 16  # noqa: E731
    L, W, Pl = 8192, 8, 256
    block = sum(pad(Pl * n) for n in (7 * 4, L * 3 * 4, L * 9 * 4, 0, L * W * 4, L, L * 4))
    assert block == 178_265_088
    got = mod.share(3 * block, 2.0)
    assert got == pytest.approx(100.0 * 3 * block / 2e-3 / 478.125e9)
    assert got == pytest.approx(55.93, abs=0.01)
    assert mod.share(0, 2.0) is None and mod.share(3 * block, 0.0) is None


# -- the flush's reference against the program's flush -----------------------


def _flush_world(seed=7, n_lm=400, n_kf=10, step=0.6, F=64, W=8):
    """Keyframes along a street of landmarks: each keyframe's true pose, the
    pose the system holds for it (drifting 2 cm and 0.4 mrad a keyframe),
    and its snapshot (its F nearest landmarks in its true frame, with their
    descriptors: what the sensor saw)."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.core import geometry

    g = np.random.default_rng(seed)
    lm = np.stack([g.uniform(-5, n_kf * step + 5, n_lm),
                   g.choice([-1, 1], n_lm) * g.uniform(3, 8, n_lm),
                   g.uniform(-1, 2, n_lm)], 1).astype(np.float32)
    desc = g.integers(0, 2**32, (n_lm, W), dtype=np.uint64).astype(np.uint32).view(np.int32)
    kfs = []
    for k in range(n_kf):
        yaw = 0.02 * np.sin(k)
        true = torch.tensor([k * step, 0.1 * np.sin(k), 0.0, 0, 0, np.sin(yaw / 2),
                             np.cos(yaw / 2)], dtype=torch.float32)
        drift = torch.tensor([0.02 * k, 0.01 * k, 0, 0, 0, np.sin(2e-4 * k), np.cos(2e-4 * k)],
                             dtype=torch.float32)
        held = geometry.se3_compose(drift, true)
        near = np.argsort(np.linalg.norm(lm - true[:3].numpy(), axis=1))[:F]
        pts = geometry.se3_apply_inverse(true, torch.as_tensor(lm[near])).numpy()
        kfs.append((held, pts, desc[near].copy(), np.ones(F, bool)))
    return kfs


FLUSH_FAULTS = [None, "solve_skipped", "closures_dropped", "snapshot_swapped"]


@pytest.mark.parametrize("fault", FLUSH_FAULTS)
def test_the_flush_reference_follows_the_program_flush(fault, monkeypatch):
    """A keyframe a flush window, each 4 frames after the one before, so that
    from the sixth on the keyframes 20 frames back are eligible and their
    closures verify: the program's flush (`SLAMSystem.flush_flags`, eager on
    the CPU) and the reference's (`reference/flush.py`) from the same
    backend and window agree bit for bit, closures and solves included;
    and each fault of the flush shows in its number."""
    import torch

    from parakeet_slam_tpu_torch import system
    from slambench.harness import spec
    from slambench.reference import filter as fref
    from slambench.reference import flush as fflush

    drv = tiny_cell().driver()
    if fault == "solve_skipped":
        monkeypatch.setattr(system.SLAMSystem, "_optimize_and_correct", lambda self: None)
    elif fault == "closures_dropped":
        monkeypatch.setattr(system.SLAMSystem, "_accept_closures", lambda self, *a: False)
    elif fault == "snapshot_swapped":
        make = system.SLAMSystem._make_keyframe

        def swapped(self, est_pose, snap=None, frame=None, anchor_pose=None):
            if len(self.keyframes) > 6:
                snap = (snap[0].flip(0), snap[1], snap[2])
            return make(self, est_pose, snap, frame, anchor_pose)

        monkeypatch.setattr(system.SLAMSystem, "_make_keyframe", swapped)
    run = dict(tiny_cell().config["run"], dist={"particle_axis": 1, "map_axis": 1})
    cfg = spec.port_config({"run": run})
    sys_ = system.SLAMSystem(cfg, device="cpu", capture=False)
    fl = fflush.Flush(fref.frozen_config(run), torch.device("cpu"))
    numbers, solves, closures = [], 0, 0
    for w, (held, pts, desc, valid) in enumerate(_flush_world(F=cfg.frontend.max_features)):
        frames = [4 * w + j + 1 for j in range(4)]
        snap = (torch.as_tensor(pts), torch.as_tensor(desc), torch.as_tensor(valid))
        no = torch.zeros((), dtype=torch.bool)
        pending = [(f, held, no, snap) for f in frames[:-1]] + [(frames[-1], held, ~no, snap)]
        before = drv._backend(sys_)
        state = fref.as_state(SimpleNamespace(**{f: getattr(sys_.state, f).clone()
                                                 for f in fref.STATE_FIELDS}))
        sys_._flag_pending = list(pending)
        sys_.frame_idx = frames[-1]
        sys_.flush_flags()
        after = drv._backend(sys_)
        r_state, r_be = fl(before, pending, state, before.last_kf, frames[-1])
        nums = fflush.compare(after, r_be, before)
        nums["state_pose_gap"] = float(fref._pose_gap(sys_.state.pose, r_state.pose).max())
        numbers.append(nums)
        solves += int(not torch.equal(r_be.graph["poses"][:len(before.poses)],
                                      before.graph["poses"][:len(before.poses)]))
        closures += len(r_be.closures) - len(before.closures)
    assert solves >= 2 and closures >= 2, (solves, closures)
    worst = {k: max(n[k] for n in numbers) for k in numbers[0]}
    if fault is None:
        assert all(v == 0.0 for v in worst.values()), worst
    else:
        caught = {"solve_skipped": "graph_pose_gap", "closures_dropped": "closure_pairs_differ",
                  "snapshot_swapped": "kf_snapshot_mismatch_share"}[fault]
        assert worst[caught] > 1e-3, worst


def _spawn(fault, out, world=2):
    from parakeet_slam_tpu_torch.dist.multihost import free_local_port

    port = free_local_port()
    procs = []
    for r in range(world):
        e = dict(os.environ, OMP_NUM_THREADS="1", ATEN_CPU_CAPABILITY="default",
                 COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(world),
                 PROCESS_ID=str(r),
                 PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), fault, str(out)],
                                      cwd=ROOT, env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


@pytest.fixture(scope="module")
def verdicts(tmp_path_factory):
    """Every fault's two ranks, two faults at a time (so that the CPU's load
    stays low for the other tests' timed windows)."""
    out = tmp_path_factory.mktemp("pano_online")
    errs = {}
    for k in range(0, len(FAULTS), 2):
        procs = {f: _spawn(f, out) for f in FAULTS[k:k + 2]}
        for f, ps in procs.items():
            for r, p in enumerate(ps):
                try:
                    _, err = p.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    p.kill()
                    _, err = p.communicate()
                if p.returncode != 0:
                    errs[(f, r)] = err[-3000:]
    assert not errs, errs
    return {f: json.loads((out / f"{f}_r0.json").read_text()) for f in FAULTS}


@pytest.mark.parametrize("how", ["none", "traced"])
def test_tiny_two_rank_run_is_correct(verdicts, how):
    """Correct, every compared number 0.0; traced (a host interval standing
    for the device's activity, as in test_slambench_reference.py), rank 0's
    ring bytes a traced frame are one packed block of its 8 particles' rows
    (S - 1 = 1), and the readers of the cell report."""
    v = verdicts[how]
    assert v["correct"], v
    assert v["sharded"] and v["attempted"] > 0 and v["frames_per_s"] > 0
    assert all(c["value"] == 0.0 for c in v["checks"].values()), v["checks"]
    if how == "traced":
        pad = lambda n: -(-n // 16) * 16  # noqa: E731
        L, W, Pl = 128, 8, 32
        block = sum(pad(Pl * n) for n in (7 * 4, L * 3 * 4, L * 9 * 4, 0, L * W * 4, L, L * 4))
        assert v["ring_bytes"] == block
        assert v["metrics"]["flush_host_ms"] > 0
        assert v["metrics"]["ring_gather_roofline"] is None  # no NCCL kernel on the CPU


@pytest.mark.parametrize("fault,caught_by", [
    ("ring_left_out", "pose_gap_max"),
    ("snapshot_rank0", "snapshot_mismatch_share"),
    ("keyframes_altered", "ranks_disagree"),
    ("control", "pose_gap_max"),
])
def test_a_fault_is_not_correct(verdicts, fault, caught_by):
    v = verdicts[fault]
    assert not v["correct"], v
    c = v["checks"][caught_by]
    assert c["value"] > c["limit"], (fault, v["checks"])


# -- one rank ----------------------------------------------------------------


def _apply(fault):
    """Break the program underneath for `fault` (in this rank's process)."""
    import torch

    from parakeet_slam_tpu_torch import system
    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist import sharded_filter

    if fault == "ring_left_out":
        sharded_filter.ring_gather_rows = lambda state, idx, *a, **kw: state
    elif fault == "snapshot_rank0":
        def rank0_best(self, state):
            lw = mesh_mod.all_gather_rows(state.log_w, self.mesh, self.axis)
            best = torch.argmax(lw[:self.local_particles]).reshape(1)
            fields = (state.lm_mean, state.lm_valid, state.lm_desc, state.lm_count)
            mine = [t.index_select(0, best) for t in fields]
            offers = mesh_mod.all_gather_packed(mine, self.mesh, self.axis)
            return tuple(t[0] for t in offers)

        sharded_filter.ShardedFastSLAM.best_particle_lanes = rank0_best
    elif fault == "keyframes_altered" and os.environ["PROCESS_ID"] == "1":
        make = system.SLAMSystem._make_keyframe

        def shifted(self, est_pose, snap=None, frame=None, anchor_pose=None):
            return make(self, est_pose, snap, None if frame is None else frame + 1, anchor_pose)

        system.SLAMSystem._make_keyframe = shifted


class _HostStretch:
    """`trace.Stretch` on the CPU: one host interval stands for the device's
    activity; the program's spans are brought over as the real one does."""

    def __enter__(self):
        self._ns, self._t0 = time.time_ns(), time.perf_counter()
        return self

    def __exit__(self, *exc):
        from slambench.harness import spans
        from slambench.harness import trace as trace_mod

        wall = time.perf_counter() - self._t0
        self.summary = trace_mod.Summary(ops=[("host", 0.0, wall * 1e6)], wall_s=wall,
                                         spans=spans.stretch_spans(self._ns, wall))
        return False


def main(fault, out):
    import torch

    from slambench.harness import clocks, cli, spec

    clocks.shutil.which = lambda _: None  # no card to sample

    torch.set_num_threads(1)
    _apply(fault)
    cell = tiny_cell(fault)
    driver = cell.driver()
    if fault == "traced":
        driver.Stretch = _HostStretch
    run = cli.Run(cell=cell, root=ROOT, seed=2**31 + 11, seconds=SECONDS, trace=fault == "traced",
                  t0_wall=time.time(), device="cpu", with_control=fault == "control",
                  rank=int(os.environ["PROCESS_ID"]), world=2)
    driver.run(run)
    verdict = {"correct": cli.correct(run), "attempted": run.attempted, "errors": run.errors,
               "ring_bytes": run.counters.get("dist.ring_bytes"),
               "metrics": ({m["name"]: spec.metric_reader(m["name"])(run) for m in cell.per_layer}
                           if run.trace else {}),
               "frames_per_s": run.e2e.get("frames_per_s", 0.0),
               "sharded": any("sharded True over 2 ranks" in n for n in run.notes),
               "checks": {c.name: {"value": c.value, "limit": c.limit} for c in run.checks},
               "notes": run.notes}
    with open(os.path.join(out, f"{fault}_r{run.rank}.json"), "w") as f:
        json.dump(verdict, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
