"""Benchmark config 5's system path in the port at 2 gloo ranks on the CPU:
the sharded `SLAMSystem` with `DistConfig(particle_axis=2, map_axis=1)` on
tests/test_config5_sharded.py's 12-frame 96x192 world against the
one-device system on the same draws (estimates, keyframes, graph and the
gathered state bit-equal), its snapshot resumed on the mesh and on one
device, `run_ba(distributed=True)` held to the reference's bar, the
config-5 demo's rows at small sizes, and the failure recovery of
tests/test_failure_recovery.py: a 2-rank run killed with SIGKILL and
resumed at world size 1. One spawn of `tests/torch_dist_worker.py` serves
the system cases, two more the recovery."""

import json
import os
import signal
import time

import numpy as np
import pytest

from parakeet_slam_tpu_torch.data.panoramic import make_panoramic_world
from parakeet_slam_tpu_torch.eval.kernel_inputs import PAR_KEYS, panoramic_observations, project_np
from tests import torch_dist_worker as W

STATE = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_desc", "lm_valid", "lm_count")
RECORD = ("est", "kf_pose", "kf_points", "kf_desc", "kf_valid", "kf_frame", "closures",
          "graph_poses", *(f"st_{f}" for f in STATE))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_config5")
    W.spawn("system", out)
    return out, [W.load(out, "system", r) for r in (0, 1)]


def test_system_takes_the_sharded_path_when_the_world_fits(run):
    _, (r0, r1) = run
    assert bool(r0["sharded"]) and bool(r1["sharded"])
    assert not bool(r0["one_sharded"])  # dist 1 x 1 in a world of 2: one device


@pytest.mark.parametrize("what", RECORD)
def test_sharded_system_equals_one_device(run, what):
    """Estimates, keyframes (pose, points, descriptors, validity, frame),
    closures, graph poses and every gathered state leaf bit-equal to the
    one-device system, on both ranks."""
    _, (r0, r1) = run
    np.testing.assert_array_equal(r0[what], r0[f"one_{what}"])
    np.testing.assert_array_equal(r1[what], r0[what])


@pytest.mark.parametrize("what", RECORD)
def test_captured_sharded_system_equals_eager_and_one_device(run, what):
    """`SLAMSystem(capture=True)` on the 2-rank mesh (the captured path's
    buffer rules: one CapturedStep a frame over the sharded step, eager on
    the CPU) against the eager sharded system and the one-device system on
    the same frames and draws, bit for bit, on both ranks."""
    _, (r0, r1) = run
    assert bool(r0["cap_capture"]) and bool(r1["cap_capture"])
    np.testing.assert_array_equal(r0[f"cap_{what}"], r0[what])
    np.testing.assert_array_equal(r0[f"cap_{what}"], r0[f"one_{what}"])
    np.testing.assert_array_equal(r1[f"cap_{what}"], r0[what])


def test_captured_sharded_system_resumes_and_solves(run):
    """The captured mesh system's own snapshot after frame 6, loaded into a
    fresh captured mesh system (written into its static state buffers),
    continues as the uninterrupted run; its distributed BA through the
    captured step costs what the eager system's does."""
    _, (r0, r1) = run
    for r in (r0, r1):
        np.testing.assert_array_equal(r["cap_est_resumed"], r0["est"][W.SYSTEM_CUT:])
        np.testing.assert_array_equal(r["cap_ba_cost_sharded"], r0["ba_cost_sharded"])


def test_sharded_snapshot_resumes_on_the_mesh_and_on_one_device(run):
    """The snapshot the mesh wrote after frame 6 (the reference's global
    layout, from rank 0) continued by a sharded system and by a one-device
    system: frames 7-12 equal the uninterrupted run's."""
    out, (r0, r1) = run
    assert (out / "snap.state.npz").exists() and (out / "snap.kf.npz").exists()
    np.testing.assert_array_equal(r0["est_resumed_sharded"], r0["est"][W.SYSTEM_CUT:])
    np.testing.assert_array_equal(r1["est_resumed_sharded"], r0["est"][W.SYSTEM_CUT:])
    np.testing.assert_array_equal(r0["est_resumed_one"], r0["est"][W.SYSTEM_CUT:])


def test_run_ba_distributed_meets_the_reference_bar(run):
    """tests/test_config5_sharded.py's bar: the distributed solve's final
    cost <= 2 x the one-device cost + 1, over the mesh's dcn lines of one
    rank (particle_axis=2) and over two point blocks (map_axis=2, picked by
    distributed=None)."""
    _, (r0, r1) = run
    cs = float(r0["ba_cost_one"][-1])
    for r in (r0, r1):
        for key in ("ba_cost_sharded", "ba_dcn2_auto"):
            c = r[key]
            assert np.isfinite(c).all() and c[-1] <= 2.0 * cs + 1.0, (key, c, cs)
    np.testing.assert_array_equal(r0["ba_dcn2_auto"], r1["ba_dcn2_auto"])


def test_config5_demo_rows(run):
    out, _ = run
    rows = json.loads((out / "demo_r0.json").read_text())
    online, ring, ba = rows["online"], rows["ring_match"], rows["dist_ba"]
    assert online["bench"] == "online_sharded_filter" and online["mesh"] == {"dcn": 2, "ici": 1}
    assert online["keyframes"] >= 1 and online["frames_per_s"] > 0
    assert online["parity_vs_one_device"] is True
    # the eager twin beside the default (eager as well on the CPU)
    assert online["frames_per_s_eager"] > 0 and online["captured_equals_eager"] is True
    assert ring["parity_vs_reference"] and ring["devices"] == 2
    assert ring["ms_eager"] > 0 and ring["captured_equals_eager"] is True
    assert all(r["lm_iters_per_s_eager"] > 0 and r["captured_equals_eager"] for r in ba)
    assert online["ranks_agree"] and ring["ranks_agree"] and all(r["ranks_agree"] for r in ba)
    assert [r["map_shards"] for r in ba] == [1, 2]
    assert all(np.isfinite(r["final_cost"]) and r["obs"] == 12800 for r in ba)
    np.testing.assert_allclose(ba[1]["final_cost"], ba[0]["final_cost"], rtol=1e-4)


def test_panoramic_observations_project_the_world():
    """The equirect observations that feed config 5's filter: the Z nearest
    landmarks, inside the image, within the pixel noise of the projection."""
    world = make_panoramic_world(num_landmarks=300, num_steps=4, image_size=(256, 512))
    z, desc, valid = panoramic_observations(world, 2, 128, 8, seed=0)
    assert z.shape == (128, 2) and desc.shape == (128, 8) and valid.all()
    assert (z[:, 0] >= 0).all() and (z[:, 0] < 512).all() and (z[:, 1] < 256).all()
    par = tuple(zip(PAR_KEYS, (1.0, 1.0, 0.0, 0.0, 0.0, 512.0, 256.0)))
    p, zw = project_np("equirect_3d", world.gt_pose[2].astype(np.float64), world.landmarks, par)
    near = np.argsort(np.linalg.norm(p, axis=1), kind="stable")[:128]
    d = np.abs(z - zw[near])
    d[:, 0] = np.minimum(d[:, 0], 512 - d[:, 0])
    assert d.max() < 5.0
    z2, desc2, _ = panoramic_observations(world, 2, 128, 8, seed=0)
    np.testing.assert_array_equal(z, z2)
    np.testing.assert_array_equal(desc, desc2)


def test_kill_and_resume_at_world_size_one(tmp_path):
    """A 2-rank sharded run snapshotting every 4 steps is killed (SIGKILL)
    after step 10, then resumed at world size 1 from its latest snapshot:
    it starts at a snapshot step no later than the kill, and its final
    state and estimate equal the uninterrupted one-device run's bit for
    bit."""
    procs = W.start("recover_run", tmp_path)
    killed_after = None
    deadline = time.time() + W.TIMEOUT
    try:
        for line in procs[0].stdout:
            if line.startswith("STEP") and int(line.split()[1]) >= 10:
                killed_after = int(line.split()[1])
                for p in procs:
                    os.kill(p.pid, signal.SIGKILL)
                break
            if time.time() > deadline:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert killed_after is not None, "the 2-rank run never reached step 10"
    assert sorted(os.listdir(tmp_path / "snaps"))
    W.spawn("recover_resume", tmp_path, world=1)
    d = W.load(tmp_path, "recover")
    start = int(d["start"])
    assert 0 < start <= killed_after and start % W.RECOVER_EVERY == 0
    np.testing.assert_array_equal(d["est"], d["est_whole"])
    for f in STATE:
        np.testing.assert_array_equal(d[f"r_{f}"], d[f"w_{f}"], err_msg=f)
