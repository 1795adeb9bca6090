"""Nothing under slambench/ imports JAX, the JAX package, chip_smoke or the
port's eval package, compared by whole top-level names (the port's name,
parakeet_slam_tpu_torch, begins with the JAX package's); the reference
imports nothing of the port either."""

from __future__ import annotations

import ast
import os

from slambench.harness import guard
from slambench.tests.conftest import ROOT

BENCH_DIR = os.path.join(ROOT, "slambench")
BANNED = {"jax", "jaxlib", "flax", "parakeet_slam_tpu", "chip_smoke"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_nor_the_jax_package_nor_the_ports_eval():
    bad = []
    for path in _sources():
        for mod in _imports(path):
            top = mod.split(".", 1)[0]
            if top in BANNED or mod.startswith("parakeet_slam_tpu_torch.eval"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_port():
    bad = [(os.path.relpath(p, ROOT), m) for p in _sources("reference") for m in _imports(p)
           if m.split(".", 1)[0] == "parakeet_slam_tpu_torch"]
    assert not bad, bad


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["parakeet_slam_tpu_torch", "parakeet_slam_tpu_torch.system",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["parakeet_slam_tpu.system", "jax._src", "flax"]) == [
        "flax", "jax", "parakeet_slam_tpu"]
