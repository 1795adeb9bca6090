"""The reference against tiny CPU runs of the port through its plain
twins: every cell's driver, run on the CPU at a tiny size, is correct and
measures its end-to-end metrics (kitti00's window ends on its frame
supply, and a traced run takes its stretch all the same); and with the
timed path broken underneath (the card's look skipped, the rest of the run
driven), `correct` comes out false for each fault the cell can have: a
step that returns its state unchanged, the exchange between ranks left
out, an answer altered where it is produced, covariances written wrong,
one rank's particles gone wrong. A BA control run prints the reordering's
numbers."""

from __future__ import annotations

import time

import pytest

from slambench.harness import cli, clocks, spans, spec
from slambench.harness import trace as trace_mod
from slambench.tests.conftest import tiny_run

CELLS = ["euroc_mh.joint_ba", "kitti00.stereo_drive", "panoramic.sharded_filter4"]


def _drive(name):
    run = tiny_run(name)
    run.cell.driver().run(run)
    return run


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cpu_run_is_correct(name):
    run = _drive(name)
    assert cli.correct(run), (run.errors, [(c.name, c.value, c.limit) for c in run.checks])
    assert run.attempted > 0 and "setup_s" in run.e2e
    assert {m["name"] for m in run.cell.end_to_end} <= set(run.e2e)


class _HostStretch:
    """`trace.Stretch` on the CPU: one host interval stands for the device's
    activity; the program's spans are brought over as the real one does."""

    def __enter__(self):
        self._ns, self._t0 = time.time_ns(), time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        self.summary = trace_mod.Summary(ops=[("host", 0.0, wall * 1e6)], wall_s=wall,
                                         spans=spans.stretch_spans(self._ns, wall))
        return False


def test_kitti00_traced_run_ends_on_its_supply_and_takes_its_stretch(monkeypatch, tracer):
    """The tiny kitti00 run uses up its supply of 0.1 x 120 + 8 = 20 frames
    long before its 120 s: correct, `frames_per_s` measured, and with
    `--trace 1` its 2 traced frames taken from the supply's middle, with
    the program's spans over them."""
    monkeypatch.setattr(trace_mod, "Stretch", _HostStretch)
    monkeypatch.setattr(clocks.shutil, "which", lambda _: None)
    run = tiny_run("kitti00.stereo_drive")
    run.trace = True
    run.cell.driver().run(run)
    assert cli.correct(run), (run.errors, [(c.name, c.value, c.limit) for c in run.checks])
    assert run.attempted == 20
    assert any("the window ended on its frame supply after 20 frames" in n for n in run.notes)
    assert run.e2e["frames_per_s"] > 0
    assert run.counters["frames_traced"] == 2
    assert "frame" in {s[0] for s in run.stretch.spans}
    assert spec.metric_reader("flush_host_ms")(run) > 0
    assert not tracer.enabled()


def test_ba_control_run_prints_the_reordering():
    """A BA control run also solves the reference in float32 with the
    problem's observations in a seed-drawn order: another order of the same
    sums, which moves its numbers off 0, printed beside the control's."""
    run = tiny_run("euroc_mh.joint_ba")
    run.with_control = True
    driver = run.cell.driver()
    driver.run(run)
    reo = run.counters["reordering"]
    assert set(run.cell.workload["limits"]) <= set(reo)
    assert reo["ba_cost_rel_gap"] > 0
    assert any(n.startswith(driver.REORDERING + " against the reference: ba_cost_rel_gap=")
               for n in run.notes)


def _ba_unchanged(monkeypatch):
    from parakeet_slam_tpu_torch.backend import ba

    real = ba.optimize_ba

    def unchanged(camera, prob, **kw):
        res = real(camera, prob, **kw)
        return res._replace(problem=prob)

    monkeypatch.setattr(ba, "optimize_ba", unchanged)


def _ba_altered(monkeypatch):
    from parakeet_slam_tpu_torch.backend import ba

    real = ba.optimize_ba

    def altered(camera, prob, **kw):
        res = real(camera, prob, **kw)
        return res._replace(problem=res.problem.replace(cam_pose=res.problem.cam_pose + 1e-2))

    monkeypatch.setattr(ba, "optimize_ba", altered)


def _step_unchanged(monkeypatch):
    from parakeet_slam_tpu_torch.filter import fastslam, fastslam2

    for cls in (fastslam.FastSLAM, fastslam2.FastSLAM2):
        real = cls.step

        def unchanged(self, state, *a, _real=real, **kw):
            _, metrics = _real(self, state, *a, **kw)
            return state, metrics

        monkeypatch.setattr(cls, "step", unchanged)


def _sharded_step_unchanged(monkeypatch):
    from parakeet_slam_tpu_torch.dist import sharded_filter

    real = sharded_filter.ShardedFastSLAM.step

    def unchanged(self, state, *a, **kw):
        new, metrics = real(self, state, *a, **kw)
        return state.replace(log_w=state.log_w.clone()), metrics

    monkeypatch.setattr(sharded_filter.ShardedFastSLAM, "step", unchanged)


def _edit_steps(monkeypatch, edit):
    """Every filter step (one device's and the sharded one) returns its
    new state with `edit` applied."""
    from parakeet_slam_tpu_torch.dist import sharded_filter
    from parakeet_slam_tpu_torch.filter import fastslam, fastslam2

    for cls in (fastslam.FastSLAM, fastslam2.FastSLAM2, sharded_filter.ShardedFastSLAM):
        real = cls.__dict__["step"]

        def step(self, state, *a, _real=real, **kw):
            new, metrics = _real(self, state, *a, **kw)
            return edit(new), metrics

        monkeypatch.setattr(cls, "step", step)


def _cov_altered(monkeypatch):
    """The update writes every landmark covariance 1% high, and nothing
    else wrong."""
    _edit_steps(monkeypatch, lambda st: st.replace(lm_cov=st.lm_cov * 1.01))


def _one_rank_of_four(monkeypatch):
    """The rows one rank of four holds (the first quarter of the particles)
    leave the step 2 mm off; the other three quarters are right."""
    def edit(st):
        pose = st.pose.clone()
        pose[: max(1, pose.shape[0] // 4), :3] += 2e-3
        return st.replace(pose=pose)

    _edit_steps(monkeypatch, edit)


def _ring_left_out(monkeypatch):
    from parakeet_slam_tpu_torch.dist import sharded_filter

    monkeypatch.setattr(sharded_filter, "ring_gather_rows", lambda state, idx, *a, **kw: state)


def _estimate_altered(monkeypatch):
    from parakeet_slam_tpu_torch.filter import fastslam

    real = fastslam.FastSLAM.estimate_pose

    def altered(self, state):
        est = real(self, state)
        return est + torch_offset(est)

    monkeypatch.setattr(fastslam.FastSLAM, "estimate_pose", altered)


def torch_offset(est):
    import torch

    return torch.cat([torch.full_like(est[:3], 1e-2), torch.zeros_like(est[3:])])


FAULTS = [
    ("euroc_mh.joint_ba", _ba_unchanged),
    ("euroc_mh.joint_ba", _ba_altered),
    ("kitti00.stereo_drive", _step_unchanged),
    ("kitti00.stereo_drive", _estimate_altered),
    ("kitti00.stereo_drive", _cov_altered),
    ("kitti00.stereo_drive", _one_rank_of_four),
    ("panoramic.sharded_filter4", _sharded_step_unchanged),
    ("panoramic.sharded_filter4", _ring_left_out),
    ("panoramic.sharded_filter4", _estimate_altered),
    ("panoramic.sharded_filter4", _cov_altered),
    ("panoramic.sharded_filter4", _one_rank_of_four),
]

# the number that has to catch a fault which moves nothing else
CAUGHT_BY = {_cov_altered: "lane_mismatch_share", _one_rank_of_four: "pose_gap_max"}


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__.strip('_')}"
                                                    for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    run = _drive(name)
    assert not cli.correct(run)
    # the comparison caught it, not something else that went wrong
    assert not run.errors, run.errors
    failing = {c.name for c in run.checks if not c.ok}
    assert failing, [(c.name, c.value, c.limit) for c in run.checks]
    if fault in CAUGHT_BY:
        assert CAUGHT_BY[fault] in failing, [(c.name, c.value, c.limit) for c in run.checks]


@pytest.mark.parametrize("name", ["kitti00.stereo_drive", "panoramic.sharded_filter4"])
def test_a_control_run_holds_the_control_and_is_not_correct(name):
    """A control run puts the reference with its state in bfloat16 in the
    program's place: its numbers are held to the limits and fail."""
    run = tiny_run(name)
    run.with_control = True
    run.cell.driver().run(run)
    assert not run.errors, run.errors
    assert not cli.correct(run), [(c.name, c.value, c.limit) for c in run.checks]
    assert any(line.startswith("program (not held in a control run)") for line in run.notes)


def test_a_rank_that_holds_jax_after_the_window_prints_no_result(monkeypatch):
    """A rank other than 0 looks for JAX after its window: it exits with
    another code than 0, which makes the launcher print no result."""
    import sys
    import types

    run = tiny_run("euroc_mh.joint_ba")
    run.rank = 1
    assert cli.after_window(run) == 0
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert cli.after_window(run) != 0
