"""On the card: each cell runs and is correct, and a control run of it (the
control, the reference in the next precision below the configuration's, put
in the program's place: TF32 for the bundle adjustment, the particle state
in bfloat16 for the filter) comes out not correct, by its limits, on the
same seed. Skips without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from slambench.harness import spec
from slambench.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.benchmark_json(ROOT)["workloads"]]


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
