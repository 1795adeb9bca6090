"""Build and load the port's hand-written CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` to an object (one `nvcc`
per source, all started together) and links them into one shared library
with a plain C interface, `build/parakeet_slam_tpu_torch/<hash>/libkernels.so`
under the repository root; the hash covers the sources and the flags, so an
edited source builds anew. The library is loaded with `ctypes`. Nothing
here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / _PKG.name

# -fmad=false: no multiply-add contraction, so the kernels round exactly as
# the plain PyTorch twins (one op per rounding) and masks/lanes agree bit
# for bit on the card.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ekf_update_2d_launch": [_P] * 12 + [_I] * 4 + [_F] * 8 + [_I] * 3 + [_P],
    "gather_rows_launch": [_P, _P, _P, _I, _P, _I, _P],
    "score_3d_launch": [_P] * 9 + [_I] * 5 + [_P, _P],
    "ekf_update_3d_launch": [_P] * 14 + [_I] * 9 + [_P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libkernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        t0 = time.perf_counter()
        nvcc = _nvcc()
        jobs = []
        for src in srcs:
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        outputs = [proc.communicate() for _, _, proc in jobs]  # all finish before a raise
        for (_, cmd, proc), (out, err) in zip(jobs, outputs):
            _raise_on_failure(cmd, proc.returncode, out + err)
        tmp = out_dir / f"libkernels.{tag}.so"
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for obj, _, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _raise_on_failure(cmd, res.returncode, res.stdout + res.stderr)
        os.replace(tmp, so)
        library.build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


library.build_seconds = 0.0


def _raise_on_failure(cmd, returncode, output):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{output}")


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (launch refused etc.)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def float_array(values) -> ctypes.Array:
    """A host float32 array for a `const float*` parameter block."""
    return (ctypes.c_float * len(values))(*values)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
