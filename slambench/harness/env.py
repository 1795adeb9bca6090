"""The run's environment: every build and kernel cache at a fixed path
inside the checkout (so that only a cell's first run there builds), set
before torch is imported. The port builds its kernels into
`<checkout>/build/parakeet_slam_tpu_torch/<hash>/` by itself."""

from __future__ import annotations

import os


def fix_caches(root: str) -> None:
    cache = os.path.join(root, "build", "slambench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    # a library that would load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def card_check(chips: int) -> str | None:
    """Why the run cannot go on (no CUDA, or fewer cards than the cell
    asks for), or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}"
    return None


def _smi(query: str) -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def card_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    return _smi("name,power.limit")


def card_clocks() -> str:
    """The card's SM clock, its maximum, temperature and power draw now."""
    return "sm " + _smi("clocks.sm,clocks.max.sm,temperature.gpu,power.draw")
