"""On the card: each cell runs and is correct, and a control run of it (the
control, the reference in the next precision below the configuration's, put
in the program's place: TF32 for the bundle adjustment, the particle state
in bfloat16 for the filter) comes out not correct, by its limits, on the
same seed; the BA control's float32 reordering reads over the cost limit
as TF32 does; and the device trace and the program's spans share one
clock. Skips without a card."""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import pytest

from slambench.harness import spans, spec
from slambench.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.benchmark_json(ROOT)["workloads"]]


@functools.lru_cache(maxsize=None)
def _run(cell: str, *extra: str) -> dict:
    res = subprocess.run([sys.executable, os.path.join(ROOT, "slambench", "run.py"),
                          "--workload", cell, "--seed", str(2**31 + 97), "--seconds", "5",
                          "--trace", "0", *extra], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    line["stderr"] = res.stderr
    return line


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_its_control_is_not(card, cell):
    import torch

    c = spec.load_cell(ROOT, cell)
    if torch.cuda.device_count() < c.chips:
        pytest.skip(f"{cell} needs {c.chips} cards")
    run = _run(cell)
    assert run["correct"], run["stderr"][-3000:]
    ctl = _run(cell, "--with-control")
    assert not ctl["correct"], ctl["stderr"][-3000:]
    assert any(v["value"] > v["limit"] for v in ctl["checks"].values()), ctl["checks"]


@pytest.mark.card
def test_ba_reordering_reads_over_the_cost_limit_as_the_control_does(card):
    """The BA control run's float32 reordering (the same sums in another
    order, same precision) reads over the cost limit as TF32 does: the
    comparison holds the state after 20 LM iterations, which another order
    of summation moves as far as TF32 does, so the program's summation has
    to stay bit for bit the reference's."""
    ctl = _run("euroc_mh.joint_ba", "--with-control")
    limit = ctl["checks"]["ba_cost_rel_gap"]["limit"]
    assert ctl["checks"]["ba_cost_rel_gap"]["value"] > limit
    driver = spec.load_cell(ROOT, "euroc_mh.joint_ba").driver()
    head = driver.REORDERING + " against the reference: "
    (line,) = [ln for ln in ctl["stderr"].splitlines() if ln.startswith(head)]
    reo = {k: float(v) for k, v in (kv.split("=") for kv in line[len(head):].split())}
    assert reo["ba_cost_rel_gap"] > limit, reo


@pytest.mark.card
def test_device_trace_and_spans_share_a_clock(card, tracer):
    """On the card: a sleep kernel's end falls inside the wait span of the
    synchronise that waits for it, within 0.1 ms, once the span is brought
    onto the profiler's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    tracer.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(50_000_000)
        with tracer.span("sync.wait", wait=True):
            torch.cuda.synchronize()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ((_, a, b, _, _, _),) = spans.stretch_spans(t0, 60.0)
    end = max(e.time_range.end for e in prof.events() if e.device_type == cuda)
    print(f"sleep kernel ends at {end:.1f} us; the wait span {a:.1f}-{b:.1f} us: "
          f"{end - a:.1f} us after its start, {b - end:.1f} us before its end")
    assert a - 100.0 <= end <= b + 100.0
