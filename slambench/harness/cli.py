"""The command: parse, set the environment, find the cell, check the cards,
run the cell's driver, and print the result.

Standard output's last line is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1` also
`breakdown`, and last `checks`: each number the correctness comparison
made, beside its limit. The same numbers are the last lines of standard
error. A run on a machine without the cards the cell asks for, or whose
process holds JAX or the JAX package after the window, prints no result
and exits with another code than 0."""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

from slambench.harness import env, guard, spec


@dataclass
class Check:
    """One number of the correctness comparison and its limit: the run is
    correct only where value <= limit (a gap, a count of differences)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Run:
    """What a driver is given and fills in."""

    cell: spec.Cell
    root: str
    seed: int
    seconds: float
    trace: bool
    t0_wall: float
    rank: int = 0
    world: int = 1
    device: str = "cuda"
    # a control run: the control (the reference in the next lower
    # precision) is put in the program's place and its numbers are held to
    # the limits, so the run comes out not correct; the program's numbers
    # are only printed
    with_control: bool = False
    e2e: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    notes: list = field(default_factory=list)
    stretch: object = None        # trace.Summary of the traced stretch
    counters: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    busy_s: float | None = None   # averaged over the ranks
    window_s: float | None = None

    def note(self, line: str) -> None:
        self.notes.append(line)

    def hold(self, program: list, control: list | None = None) -> None:
        """Hold the largest of each number compared over the checked frames
        or solves (dicts of the comparison's numbers) to its limit: the
        program's, or in a control run the control's in its place."""
        limits = self.cell.workload["limits"]
        held = control if self.with_control else program
        for name, limit in limits.items():
            self.checks.append(Check(name, max(x[name] for x in held), limit))
        if self.with_control:
            for name, limit in limits.items():
                self.note(f"program (not held in a control run): {name} "
                          f"{max(x[name] for x in program)!r} limit {limit!r}")

    def setup_done(self) -> float:
        """setup_s, from the process's start to now (the window's start)."""
        self.e2e["setup_s"] = time.time() - self.t0_wall
        return self.e2e["setup_s"]


def parse(argv):
    ap = argparse.ArgumentParser(prog="slambench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the launcher of a cell on several cards, for each rank
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    # the correctness control held in the program's place (not a benchmark run)
    ap.add_argument("--with-control", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv, root: str) -> int:
    t0 = float(os.environ.get("SLAMBENCH_T0", time.time()))
    args = parse(argv)
    env.fix_caches(root)
    cell = spec.load_cell(root, args.workload)
    if cell.chips > 1 and args.rank is None:
        from slambench.harness import ranks

        return ranks.launch(argv, cell, root, t0)
    why = env.card_check(cell.chips)
    if why is not None:
        print(f"slambench: {why}; no result", file=sys.stderr)
        return 2
    run = Run(cell=cell, root=root, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), t0_wall=t0, rank=args.rank or 0, world=cell.chips,
              with_control=args.with_control)
    cell.driver().run(run)
    return after_window(run)


def after_window(run: Run) -> int:
    """Rank 0 prints the result (`finish`); every other rank only looks
    for JAX once its window has closed."""
    if run.rank == 0:
        return finish(run)
    return _forbidden(run)


def _forbidden(run: Run) -> int:
    """3 where the process holds JAX or the JAX package (a rank that exits
    so makes the launcher print no result), else 0."""
    bad = guard.forbidden_loaded()
    if bad:
        print(f"slambench: rank {run.rank} holds {', '.join(bad)} after the window; no result",
              file=sys.stderr)
        return 3
    return 0


def _metrics(run: Run) -> dict:
    out = {}
    if not run.trace:
        for m in run.cell.end_to_end:
            if m["name"] not in run.e2e:
                run.errors.append(f"the driver measured no {m['name']}")
                continue
            out[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
        return out
    for m in run.cell.per_layer:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def correct(run: Run) -> bool:
    """Every number compared within its limit, no failed frame or solve,
    and nothing else that went wrong."""
    return (not run.errors and run.failed == 0 and bool(run.checks)
            and all(c.ok for c in run.checks))


def finish(run: Run) -> int:
    import torch

    metrics = _metrics(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": False, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    if run.trace:
        if run.stretch is None:
            run.errors.append("the traced run profiled no stretch")
        else:
            device["busy_s"] = run.busy_s if run.busy_s is not None else run.stretch.busy_s
            device["window_s"] = run.window_s if run.window_s is not None else run.stretch.wall_s
            result["breakdown"] = run.stretch.breakdown()
    if _forbidden(run):
        return 3
    result["correct"] = correct(run)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    for line in run.notes:
        print(line, file=sys.stderr)
    for e in run.errors:
        print(f"not correct: {e}", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILS'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
