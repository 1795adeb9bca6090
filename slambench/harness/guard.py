"""The port runs without JAX: after the window the process that prints the
result must hold none of these modules, compared by whole top-level names
(`parakeet_slam_tpu_torch` is the port, not the JAX package)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "parakeet_slam_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)
