"""Everything a run needs, found by name.

A cell `<name>` of BENCHMARK.json is `slambench/workloads/<name>.json`; it
names its configuration, `slambench/configs/<config>.json`, and its traffic
mix, `slambench/traffic/<traffic>.json`, whose `kind` names the driver that
generates and serves it, `slambench/drivers/<kind>.py`. A per-layer metric
`<metric>` is read by `slambench/metrics/<metric>.py`. The metrics a cell
reports are the entries of BENCHMARK.json that list the cell under
`workloads`, or every cell when they list none."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the Python file at `path` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def driver(self):
        return load_module(os.path.join(HERE, "drivers", f"{self.kind}.py"),
                           f"slambench_driver_{self.kind}")


def benchmark_json(root: str) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` with its configuration, traffic and metrics."""
    bench = benchmark_json(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"slambench: no cell {name!r} in BENCHMARK.json")
    workload = _load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise SystemExit(f"slambench: {name}: {key} {workload[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    return Cell(name=name, chips=int(entry["chips"]), workload=workload, config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """The `read(run)` function of per-layer metric `name`."""
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       "slambench_metric_" + name.replace(".", "_")).read


def dotted(section: dict, prefix: str = "") -> dict:
    """A nested configuration section as dotted-key overrides
    ({"filter": {"num_particles": 8}} -> {"filter.num_particles": 8})."""
    out = {}
    for k, v in section.items():
        if isinstance(v, dict):
            out.update(dotted(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def port_config(config: dict):
    """The port's `SLAMConfig` of a configuration file's `run` section (the
    repo's YAML preset as it is run), built through the port's own
    dotted-key overrides."""
    from parakeet_slam_tpu_torch.core.config import SLAMConfig, apply_overrides

    return apply_overrides(SLAMConfig(), dotted(config["run"]))
