"""Config 5's online system through `process_obs` at 2 gloo ranks on the
CPU, on a map of 16 lanes that the panoramic world's observations fill
within a few frames, so that new landmarks then find no free lane: the
captured sharded system (its buffer rules, eager on the CPU) against the
one-device system bit for bit, keyframes and their snapshots included;
each rank's flush making rank 0's decisions when its own inputs differ;
and the tracer's counters of the collectives' bytes and the valid lanes.
One spawn of `tests/torch_dist_worker.py pano_obs` serves them all."""

import numpy as np
import pytest

from tests import torch_dist_worker as W

STATE = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_desc", "lm_valid", "lm_count")
RECORD = ("est", "kf_pose", "kf_points", "kf_desc", "kf_valid", "kf_frame", "closures",
          "graph_poses", *(f"st_{f}" for f in STATE))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_pano_obs")
    W.spawn("pano_obs", out)
    return [W.load(out, "pano_obs", r) for r in (0, 1)]


def test_the_map_fills_and_new_landmarks_find_no_lane(run):
    """Every particle's 16 lanes are valid after some frames, and frames
    came whose observations were neither matched nor given a lane."""
    r0, _ = run
    assert (r0["lanes"] == W.PANO_L).sum() >= 3
    assert (r0["match"] < 1.0).any() and (r0["one_match"] == r0["match"]).all()
    assert len(r0["kf_frame"]) >= 2


@pytest.mark.parametrize("what", RECORD)
def test_sharded_obs_system_equals_one_device(run, what):
    """Estimates, keyframes (their snapshots: points, descriptors,
    validity), closures, graph poses and every gathered state leaf of the
    captured sharded system equal the one-device system's, on both
    ranks."""
    r0, r1 = run
    np.testing.assert_array_equal(r0[what], r0[f"one_{what}"])
    np.testing.assert_array_equal(r1[what], r0[what])


@pytest.mark.parametrize("what", RECORD)
def test_every_rank_makes_rank_0s_flush_decisions(run, what):
    """Rank 1's flush receives every frame's keyframe flag inverted and
    its snapshot 1 m off; it still makes rank 0's keyframes from rank 0's
    snapshots, and both ranks end as the unaltered run."""
    r0, r1 = run
    np.testing.assert_array_equal(r1[f"pert_{what}"], r0[what])
    np.testing.assert_array_equal(r0[f"pert_{what}"], r0[what])


def test_counters_count_the_bytes_their_shapes_give(run):
    """`dist.ring_bytes` and `dist.gather_bytes` over the frames equal the
    bytes the state's and the snapshot's shapes give; `lanes_valid` sums
    each drained frame's mean valid lanes over `drained_frames`."""
    for r in run:
        assert int(r["ring_bytes"]) == int(r["ring_expected"]) > 0
        assert int(r["gather_bytes"]) == int(r["gather_expected"]) > 0
        assert int(r["drained_frames"]) == W.PANO_FRAMES
        assert 0 < float(r["lanes_valid"]) <= W.PANO_FRAMES * W.PANO_L
