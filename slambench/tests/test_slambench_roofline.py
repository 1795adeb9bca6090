"""The roofline arithmetic and the trace reduction on known shapes."""

from __future__ import annotations

import pytest

from slambench.harness import roofline, trace


def test_bound_picks_the_binding_side():
    t, by = roofline.bound(3.35e12, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = roofline.bound(1.0, 67e12)
    assert by == "operations" and t == pytest.approx(1.0)


def test_apply_cinv_is_bound_by_bytes():
    n = 46_080
    t, by = roofline.bound(n * roofline.CINV_BYTES, n * roofline.CINV_OPS)
    assert by == "bytes" and t == pytest.approx(n * 48 / 3.35e12)


def test_score_ops_at_the_kitti_shape():
    # stereo: 31 per pair + 8 words x 3 + 3 for the appearance, 201 per lane
    lanes = 2048 * 5000
    assert roofline.score_ops("stereo_3d", 8, lanes, 128) == (31 + 27) * 128 * lanes + 201 * lanes


def test_update_ops_counts_every_part():
    c = roofline.OPS_3D["equirect_3d"]
    ops = roofline.update_ops("equirect_3d", 8, 1000, 10, 4, 30, 10)
    pair = c["pair"] + 27
    assert ops == (pair * 10 * 1000 + c["lane"] * 1000 + c["obs"] * 10 * 4 + c["update"] * 30
                   + c["init"] * 10 + c["cull"] * (1000 - 30))


def test_share_is_silent_without_a_time():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 4.0) == pytest.approx(25.0)


def test_busy_is_the_union_of_intervals():
    assert trace.union_us([(0, 10), (5, 20), (30, 40)]) == 30
    s = trace.Summary(ops=[("a", 0.0, 10.0), ("b", 100.0, 110.0), ("a", 111.0, 120.0)],
                      api_events=[("cudaGraphLaunch", 50.0, 60.0)], wall_s=1.0)
    assert s.busy_s == pytest.approx(29e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "a" and b["device_ops"][0][1] == pytest.approx(19e-6)
    names = dict(b["idle_gaps"])
    assert names["host cudaGraphLaunch | then b"] == pytest.approx(90e-6)
    assert sum(names.values()) == pytest.approx(91e-6)
