"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is
found by name, and BENCHMARK.json keeps to the benchmark's contract."""

from __future__ import annotations

import json
import os
import re

import pytest

from slambench.harness import spec
from slambench.tests.conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = spec.load_cell(ROOT, cell)
    assert c.chips in (1, 4)
    assert os.path.exists(os.path.join(spec.HERE, "drivers", f"{c.kind}.py"))
    assert callable(c.driver().run)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names, f"{m['name']} moves {m['moves']}, which {cell} lacks"
    assert c.workload["limits"], "every cell compares something"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_and_silent_without_a_trace(metric):
    from slambench.harness import cli

    read = spec.metric_reader(metric)
    cell = spec.load_cell(ROOT, CELLS[0])
    run = cli.Run(cell=cell, root=ROOT, seed=1, seconds=1, trace=True, t0_wall=0.0)
    assert read(run) is None


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(cfg):
    path = os.path.join(ROOT, cfg["file"])
    assert path.startswith(os.path.join(ROOT, "slambench") + os.sep)
    data = json.load(open(path))
    assert data["name"] == cfg["name"]
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    for key in cfg["reduced"]:
        assert not key.endswith(("_dim", "_rank")), "widths are never cut"
    # the port builds its configuration from the file's `run` section
    pc = spec.port_config(data)
    assert pc.filter.num_particles == data["run"]["filter"]["num_particles"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slambench"] and BENCH["command"][1].startswith("slambench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert 1 <= cells <= 24 and four <= max(1, cells // 4)
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == cells
    assert len(json.dumps(BENCH)) < 64 * 1024
