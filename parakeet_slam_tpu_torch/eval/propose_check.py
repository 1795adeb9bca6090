"""On the card: the FastSLAM 2.0 proposal kernel (`kernels/propose_3d.py`,
`csrc/propose_3d.cu`) against its twin, the loop `propose_3d.refine`, bit
for bit.

    python -m parakeet_slam_tpu_torch.eval.propose_check [--parts rules,edges,filter,system,capture,time]

Parts (each prints its lines and raises on a difference):
  rules   every product, reduction, cross product, division and maths
          function that the loop runs, recorded from the loop itself (a
          TorchFunctionMode around the twin) on one frame's operands at
          kitti00's shape (stereo_3d, P=2048, L=10240, Z=128) and config 2's
          (pinhole_3d, P=512, L=1024, Z=64), recomputed by a probe kernel
          under candidate orders of rounding; prints, for each operation,
          the candidates that equal torch's result bit for bit. The kernel's
          rule is candidate 0 of each.
  filter  `FastSLAM2._propose` through the kernel and through the twin from
          the same state and draws, at both shapes: refined log-weights and
          the sampled poses with torch.equal, over filter frames of the
          drive world.
  system  the eager online system on rendered frames (kitti00's stereo
          pairs of the drive world, config 2's desk world), every frame's
          proposal through the kernel and the twin: pose, P_cov and log_w
          with torch.equal.
  edges   crafted frames: an unmatched observation, a lane under
          weight_min_count, |delta| >= 1, a non-finite S, a landmark at the
          MIN_DEPTH clamp, a particle with no valid lane, invalid slots.
  capture the captured online system on kitti00's rendered frames: one
          propose_3d launch a frame graph replay.
  time    the kernel alone (device time) and its twin at both shapes, with
          the bound (bytes at 3.35 TB/s, operations at 67 TFLOP/s).

The probe kernels are built here with `nvcc` (the kernel library's flags)
into `build/propose_probe/`.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import os
import subprocess
import time

import numpy as np
import torch

from parakeet_slam_tpu_torch.kernels import _build
from parakeet_slam_tpu_torch.kernels import propose_3d as pk

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
SHAPES = {  # config file, overrides
    "kitti00": ("configs/kitti_00.yaml", {}),
    "config2": ("configs/tum_fr1_desk.yaml", {}),
}

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <math.h>
// Candidate orders of a batched product C = A B (A [nb, M, K], B [nb, K, N]
// strided, C contiguous): 0 an fma chain over ascending k from 0 (the
// kernel's rule), 1 descending, 2 products rounded and added in ascending
// order, 3 the first product rounded alone then fma, 4 two fma chains over
// even and odd k, added, 5 rounded products summed by halving trees.
__device__ float tree(const float* v, int n) {
  if (n == 1) return v[0];
  int h = (n + 1) / 2;
  return tree(v, h) + tree(v + h, n - h);
}
__global__ void mm_k(const float* A, const float* B, float* C, int nb, int M, int K, int N,
                     long long a0, long long a1, long long a2, long long b0, long long b1,
                     long long b2, int mode) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nb * M * N) return;
  int j = t % N, i = (t / N) % M;
  long long b = t / ((long long)M * N);
  const float* a = A + b * a0 + i * a1;
  const float* bb = B + b * b0 + j * b2;
  float acc = 0.0f, e = 0.0f, o = 0.0f, prods[64];
  for (int k = 0; k < K; ++k) prods[k] = a[k * a2] * bb[k * b1];
  switch (mode) {
    case 0: for (int k = 0; k < K; ++k) acc = __fmaf_rn(a[k * a2], bb[k * b1], acc); break;
    case 1: for (int k = K - 1; k >= 0; --k) acc = __fmaf_rn(a[k * a2], bb[k * b1], acc); break;
    case 2: acc = prods[0]; for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, prods[k]); break;
    case 3: acc = prods[0]; for (int k = 1; k < K; ++k) acc = __fmaf_rn(a[k * a2], bb[k * b1], acc); break;
    case 4:
      for (int k = 0; k < K; k += 2) e = __fmaf_rn(a[k * a2], bb[k * b1], e);
      for (int k = 1; k < K; k += 2) o = __fmaf_rn(a[k * a2], bb[k * b1], o);
      acc = e + o; break;
    default: acc = tree(prods, K);
  }
  C[t] = acc;
}
// Every order of a dot product of length 2 or 3 (p_k = a_k b_k rounded,
// F(k, x) = fma(a_k, b_k, x)), for products whose one side is a vector.
// K = 3: 0 (p0+p1)+p2, 1 (p0+p2)+p1, 2 (p1+p2)+p0, 3 F(2,p0+p1),
// 4 F(1,p0+p2), 5 F(0,p1+p2), 6 F(2,F(1,p0)), 7 F(1,F(2,p0)), 8 F(2,F(0,p1)),
// 9 F(0,F(2,p1)), 10 F(1,F(0,p2)), 11 F(0,F(1,p2)), 12 F(0,p1)+p2,
// 13 F(1,p0)+p2, 14 F(0,p2)+p1, 15 F(2,p0)+p1, 16 F(1,p2)+p0, 17 F(2,p1)+p0.
// K = 2: 0 p0+p1, 1 F(1,p0), 2 F(0,p1).
__global__ void dot_k(const float* A, const float* B, float* C, int nb, int M, int K, int N,
                      long long a0, long long a1, long long a2, long long b0, long long b1,
                      long long b2, int form) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nb * M * N) return;
  int j = t % N, i = (t / N) % M;
  long long b = t / ((long long)M * N);
  const float* a = A + b * a0 + i * a1;
  const float* bb = B + b * b0 + j * b2;
  float x[3], y[3], p[3];
  for (int k = 0; k < K; ++k) { x[k] = a[k * a2]; y[k] = bb[k * b1]; p[k] = x[k] * y[k]; }
#define F(k, v) __fmaf_rn(x[k], y[k], (v))
  float r;
  if (K == 2) {
    r = form == 0 ? p[0] + p[1] : form == 1 ? F(1, p[0]) : F(0, p[1]);
  } else {
    switch (form) {
      case 0: r = (p[0] + p[1]) + p[2]; break;
      case 1: r = (p[0] + p[2]) + p[1]; break;
      case 2: r = (p[1] + p[2]) + p[0]; break;
      case 3: r = F(2, p[0] + p[1]); break;
      case 4: r = F(1, p[0] + p[2]); break;
      case 5: r = F(0, p[1] + p[2]); break;
      case 6: r = F(2, F(1, p[0])); break;
      case 7: r = F(1, F(2, p[0])); break;
      case 8: r = F(2, F(0, p[1])); break;
      case 9: r = F(0, F(2, p[1])); break;
      case 10: r = F(1, F(0, p[2])); break;
      case 11: r = F(0, F(1, p[2])); break;
      case 12: r = F(0, p[1]) + p[2]; break;
      case 13: r = F(1, p[0]) + p[2]; break;
      case 14: r = F(0, p[2]) + p[1]; break;
      case 15: r = F(2, p[0]) + p[1]; break;
      case 16: r = F(1, p[2]) + p[0]; break;
      default: r = F(2, p[1]) + p[0];
    }
  }
#undef F
  C[t] = r;
}
// Reductions over the last dim of X [nb, n] (strided) of x or x*x: 0 torch's
// split over two threads (element k to thread k mod 2, each thread's
// elements alternating between two slots, slot 0 + slot 1, then thread 0 +
// thread 1), 1 an fma / add chain, 2 rounded terms added in order, 3 a
// halving tree of rounded terms.
__global__ void red_k(const float* X, float* out, int nb, int n, long long s0, long long s1,
                      int square, int mode, int root) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const float* x = X + (long long)b * s0;
  float v[64], acc = 0.0f;
  for (int k = 0; k < n; ++k) v[k] = square ? x[k * s1] * x[k * s1] : x[k * s1];
  if (mode == 0) {
    float th[2] = {0.0f, 0.0f};
    for (int t = 0; t < 2 && t < n; ++t) {
      float slot[2] = {v[t], t + 2 < n ? v[t + 2] : 0.0f};
      for (int k = t + 4; k < n; k += 2) slot[((k - t) / 2) % 2] = slot[((k - t) / 2) % 2] + v[k];
      th[t] = t + 2 < n ? slot[0] + slot[1] : slot[0];
    }
    acc = n > 1 ? th[0] + th[1] : th[0];
  } else if (mode == 1) {
    for (int k = 0; k < n; ++k) acc = square ? __fmaf_rn(x[k * s1], x[k * s1], acc) : acc + x[k * s1];
  } else if (mode == 2) {
    acc = v[0];
    for (int k = 1; k < n; ++k) acc = acc + v[k];
  } else {
    acc = tree(v, n);
  }
  out[b] = root ? sqrtf(acc) : acc;
}
// a x b over the last dim: 0 fma(a1, b2, -(a2 b1)), 1 fma(-a2, b1, a1 b2), 2 rounded products
__global__ void cross_k(const float* a, const float* b, float* c, int nb, long long sa,
                        long long sb, int mode) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb) return;
  const float* x = a + (long long)t * sa;
  const float* y = b + (long long)t * sb;
  for (int r = 0; r < 3; ++r) {
    int i = (r + 1) % 3, j = (r + 2) % 3;
    float v;
    if (mode == 0) v = __fmaf_rn(x[i], y[j], -(x[j] * y[i]));
    else if (mode == 1) v = __fmaf_rn(-x[j], y[i], x[i] * y[j]);
    else v = x[i] * y[j] - x[j] * y[i];
    c[(long long)t * 3 + r] = v;
  }
}
// the maths library on contiguous x: 0 sinf 1 cosf 2 logf 3 sqrtf 4 1/x
__global__ void unary_k(const float* x, float* y, long long n, int op) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float v = x[t];
  y[t] = op == 0 ? sinf(v) : op == 1 ? cosf(v) : op == 2 ? logf(v) : op == 3 ? sqrtf(v) : 1.0f / v;
}
__global__ void div_k(const float* a, const float* b, float* y, long long n) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) y[t] = a[t] / b[t];
}
extern "C" {
int probe_mm(const float* A, const float* B, float* C, int nb, int M, int K, int N,
             long long a0, long long a1, long long a2, long long b0, long long b1, long long b2,
             int mode) {
  long long n = (long long)nb * M * N;
  mm_k<<<(n + 127) / 128, 128>>>(A, B, C, nb, M, K, N, a0, a1, a2, b0, b1, b2, mode);
  return (int)cudaDeviceSynchronize();
}
int probe_dot(const float* A, const float* B, float* C, int nb, int M, int K, int N,
              long long a0, long long a1, long long a2, long long b0, long long b1, long long b2,
              int form) {
  long long n = (long long)nb * M * N;
  dot_k<<<(n + 127) / 128, 128>>>(A, B, C, nb, M, K, N, a0, a1, a2, b0, b1, b2, form);
  return (int)cudaDeviceSynchronize();
}
int probe_reduce(const float* X, float* out, int nb, int n, long long s0, long long s1,
                 int square, int mode, int root) {
  red_k<<<(nb + 127) / 128, 128>>>(X, out, nb, n, s0, s1, square, mode, root);
  return (int)cudaDeviceSynchronize();
}
int probe_cross(const float* a, const float* b, float* c, int nb, long long sa, long long sb,
                int mode) {
  cross_k<<<(nb + 127) / 128, 128>>>(a, b, c, nb, sa, sb, mode);
  return (int)cudaDeviceSynchronize();
}
int probe_unary(const float* x, float* y, long long n, int op) {
  unary_k<<<(n + 127) / 128, 128>>>(x, y, n, op);
  return (int)cudaDeviceSynchronize();
}
int probe_div(const float* a, const float* b, float* y, long long n) {
  div_k<<<(n + 127) / 128, 128>>>(a, b, y, n);
  return (int)cudaDeviceSynchronize();
}
}
"""

MM_MODES = ("asc-fma", "desc-fma", "asc-rounded", "first-rounded+fma", "even/odd-fma",
            "tree")
RED_MODES = ("two-threads", "chain", "rounded-chain", "tree")
CROSS_MODES = ("fma(a1,b2,-a2b1)", "fma(-a2,b1,a1b2)", "rounded")


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(f"propose_check FAILED: {msg}")


def probe_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the probe kernels."""
    h = hashlib.sha256((PROBE_SRC + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "propose_probe", h)
    so = os.path.join(out, "libprobe.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        src = os.path.join(out, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE_SRC)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _build._raise_on_failure(cmd, res.returncode, res.stdout + res.stderr)
    lib = ctypes.CDLL(so)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_mm.argtypes = [P, P, P] + [I] * 4 + [L] * 6 + [I]
    lib.probe_dot.argtypes = [P, P, P] + [I] * 4 + [L] * 6 + [I]
    lib.probe_reduce.argtypes = [P, P, I, I, L, L, I, I, I]
    lib.probe_cross.argtypes = [P, P, P, I, L, L, I]
    lib.probe_unary.argtypes = [P, P, L, I]
    lib.probe_div.argtypes = [P, P, P, L]
    return lib


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> int:
    """Number of elements whose float32 bits differ (-0 against +0 counts)."""
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


# ---------------------------------------------------------------------------
# The filter and its frames
# ---------------------------------------------------------------------------


def _filter(shape, device, camera=None):
    """(cfg, slam) of the shape's configuration; `camera` (a world) puts
    its intrinsics, baseline and image size in the configuration's place,
    with a landmark range prior and a range for its street's depths."""
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.filter.fastslam2 import FastSLAM2, make_filter

    path, ov = SHAPES[shape]
    if camera is not None:
        ov = {**ov, "frontend.intrinsics": list(camera.intrinsics),
              "frontend.baseline": camera.baseline, "frontend.image_size": list(camera.image_size),
              "filter.init_range_prior": 15.0, "filter.init_range_sigma": 10.0,
              "filter.max_range": 60.0}
    cfg = load_config(os.path.join(ROOT, path), ov)
    slam = make_filter(cfg.filter, cfg.frontend)
    check(isinstance(slam, FastSLAM2) and slam.propose_kernel and slam._hoist_association(),
          f"{shape}: not the hoisted FastSLAM 2.0 kernel route")
    return cfg, slam


def _filter_frames(shape, device, frames=3, seed=0):
    """(slam, states [frames + 1], per-frame (u, obs, noise, u0)) of the
    filter stepped eagerly over the drive world's synthetic observations
    (the measurement model's first Dz channels, the world's camera and, for
    a monocular model, the world's depth range as its landmark prior), from
    seed's draws."""
    from parakeet_slam_tpu_torch.core.state import Observation
    from parakeet_slam_tpu_torch.data.synth_vision import make_drive_world
    from parakeet_slam_tpu_torch.eval.kernel_inputs import drive_observations
    from parakeet_slam_tpu_torch.filter.runner import draw_noise

    world = make_drive_world(num_steps=frames + 1)
    cfg, slam = _filter(shape, device, camera=world)
    fc = cfg.filter
    Z, W, Dz = fc.max_observations, fc.desc_words, slam.model.obs_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    state = slam.init_state(init_pose=world.gt_pose[0], device=device)
    states, inputs = [state], []
    for t in range(frames):
        z, desc, valid = drive_observations(world, t, Z, W, seed=0)
        obs = Observation(z=torch.as_tensor(np.ascontiguousarray(z[:, :Dz]), device=device),
                          sig=torch.zeros(Z, 0, device=device),
                          desc=torch.as_tensor(desc.view(np.int32), device=device),
                          valid=torch.as_tensor(valid, device=device))
        u = torch.as_tensor(world.odom[t], device=device)
        noise, u0 = draw_noise(1, fc.num_particles, slam.noise_dim, gen, device)
        inputs.append((u, obs, noise[0], u0[0]))
        state = slam.step(state, u, obs, noise[0], u0[0])[0]
        states.append(state)
    return slam, states, inputs


def proposal_inputs(slam, state, u, obs):
    """The wrapper's positional inputs and keywords for one frame, as
    `FastSLAM2._propose` builds them."""
    c = slam.cfg
    pose, P_cov = slam.motion_mean_cov(state.pose, u, c.motion_noise)
    best, best_ll = slam._frame_scores(state.replace(pose=pose), obs)
    args = (pose, P_cov, state.log_w, best, best_ll, state.lm_mean, state.lm_cov,
            state.lm_count, state.lm_valid.any(dim=-1), obs.z, obs.valid)
    kw = dict(measurement=slam.model, retract=slam.retract, camera=slam._camera,
              r_var=slam._meas_var(assoc=True), log_p0=slam._log_p0_assoc(),
              unmatched_w=0.0 if c.weight_only_matched else c.new_landmark_loglik,
              weight_min_count=c.weight_min_count)
    return args, kw


def twin(*args, **kw):
    kw.pop("camera")
    return pk.propose_3d_reference(*args, **kw)


def _compare(what, got, ref, names=("pose", "P_cov", "log_w")):
    for name, a, b in zip(names, got, ref):
        n = _bits_equal(a, b)
        check(torch.equal(a, b) and n == 0,
              f"{what}: {name} differs in {n} of {a.numel()} elements, max |diff| "
              f"{float((a - b).abs().max()):.3g}")


def _matched_steps(args, kw):
    """Observations that pass the match test before the algebra, [P, Z]."""
    best, best_ll, lm_count, any_valid, valid = args[3], args[4], args[7], args[8], args[10]
    m = valid[None, :] & any_valid[:, None] & (best_ll >= float(np.float32(kw["log_p0"])))
    if kw["weight_min_count"] > 0:
        m &= torch.gather(lm_count, 1, best.long()) >= kw["weight_min_count"]
    return m


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


class _Recorder(torch.overrides.TorchFunctionMode):
    """Records the loop's products, reductions, cross products, divisions
    and maths functions with their operands and torch's results."""

    NAMES = {"matmul": "matmul", "__matmul__": "matmul", "einsum": "einsum",
             "linalg_vector_norm": "norm", "sum": "sum", "linalg_cross": "cross", "sin": "sin",
             "cos": "cos",
             "log": "log", "sqrt": "sqrt", "reciprocal": "reciprocal", "div": "div",
             "__truediv__": "div", "__rdiv__": "rdiv", "__rtruediv__": "rdiv"}

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = self.NAMES.get(getattr(func, "__name__", ""))
        if name == "div" and not isinstance(args[1], torch.Tensor):
            name = None  # torch multiplies by the scalar's reciprocal
        if name is not None:
            self.records.append((name, args, kwargs, out))
        return out


def _mm_candidates(lib, A, B):
    nb, M, K = A.shape
    N = B.shape[-1]
    outs = []
    for mode in range(len(MM_MODES)):
        C = torch.empty(nb, M, N, dtype=torch.float32, device=A.device)
        _build.check(lib.probe_mm(A.data_ptr(), B.data_ptr(), C.data_ptr(), nb, M, K, N,
                                  *A.stride(), *B.stride(), mode), "probe_mm")
        outs.append(C)
    return outs


DOT_FORMS = {2: ("p0+p1", "F1(p0)", "F0(p1)"),
             3: ("(p0+p1)+p2", "(p0+p2)+p1", "(p1+p2)+p0", "F2(p0+p1)", "F1(p0+p2)",
                 "F0(p1+p2)", "F2(F1(p0))", "F1(F2(p0))", "F2(F0(p1))", "F0(F2(p1))",
                 "F1(F0(p2))", "F0(F1(p2))", "F0(p1)+p2", "F1(p0)+p2", "F0(p2)+p1",
                 "F2(p0)+p1", "F1(p2)+p0", "F2(p1)+p0")}


def _dot_candidates(lib, A, B):
    nb, M, K = A.shape
    N = B.shape[-1]
    outs = []
    for form in range(len(DOT_FORMS[K])):
        C = torch.empty(nb, M, N, dtype=torch.float32, device=A.device)
        _build.check(lib.probe_dot(A.data_ptr(), B.data_ptr(), C.data_ptr(), nb, M, K, N,
                                   *A.stride(), *B.stride(), form), "probe_dot")
        outs.append(C)
    return outs


def _red_candidates(lib, X, square, root):
    X2 = X.reshape(-1, X.shape[-1])
    outs = []
    for mode in range(len(RED_MODES)):
        y = torch.empty(X2.shape[0], dtype=torch.float32, device=X.device)
        _build.check(lib.probe_reduce(X2.data_ptr(), y.data_ptr(), X2.shape[0], X2.shape[1],
                                      *X2.stride(), int(square), mode, int(root)), "probe_reduce")
        outs.append(y)
    return outs


ORDER_SHIFT = {"knu": 0, "vv": 2, "vm": 4, "dot": 6}  # csrc/propose_3d.cu kOrder*
ORDER_NAMES = ("chunked", "interleaved", "sequential")
# DOT_FORMS index of each order, over 3 and over 2 entries
ORDER_FORM = {3: (13, 15, 6), 2: (1, 0, 1)}


def _rules_of_records(lib, records, word):
    """{operation key: {"diffs": mismatching elements per candidate, "total",
    "rule": the kernel's candidate}} over records; `word` is the kernel's
    orders word at this batch count."""
    table = {}

    def add(key, cands, ref, rule=0):
        """Count each candidate's differing elements; `rule` is the
        kernel's candidate (None: not the kernel's rule to hold)."""
        row = table.setdefault(key, {"diffs": [0] * len(cands), "total": 0, "rule": rule})
        for k, c in enumerate(cands):
            row["diffs"][k] += _bits_equal(c.reshape(ref.shape), ref)
        row["total"] += ref.numel()

    def dot_rule(site, K):
        """The kernel's order (a DOT_FORMS index) of a product with a vector
        side at `site`, as the orders word has it."""
        return ORDER_FORM[K][(word >> ORDER_SHIFT[site]) & 3]

    for name, args, kw, out in records:
        if name == "matmul":
            a, b = args
            if a.dim() != 3 or b.dim() != 3:
                continue
            key = (f"matmul [{a.shape[1]},{a.shape[2]}]@[{b.shape[1]},{b.shape[2]}]"
                   f"{' A^T' if a.stride(1) == 1 and a.shape[1] > 1 else ''}"
                   f"{' B^T' if b.stride(1) == 1 and b.shape[1] > 1 else ''}")
            vector = a.shape[1] == 1 or b.shape[2] == 1
            add(key, _mm_candidates(lib, a, b), out, None if vector else 0)
            if vector and a.shape[2] in DOT_FORMS:
                site = "vv" if a.shape[1] == 3 else "knu"  # V v in se3_exp, else K nu
                add(f"{key} dot forms {DOT_FORMS[a.shape[2]]}", _dot_candidates(lib, a, b), out,
                    dot_rule(site, a.shape[2]))
        elif name == "einsum":
            nu, inv, nu2 = args[1:] if isinstance(args[0], str) else args[0][1:]
            lhs, rhs = nu[:, None, :].contiguous(), nu2[:, :, None].contiguous()
            D = nu.shape[-1]
            # the two bmm paths of torch itself, then each stage's forms
            first = torch.bmm(torch.bmm(lhs, inv), rhs)
            second = torch.bmm(lhs, torch.bmm(inv, rhs))
            add(f"einsum D={D} against torch.bmm: (nu^T S) nu, nu^T (S nu)", [first, second],
                out)
            t = torch.bmm(lhs, inv)
            add(f"einsum D={D} stage [1,{D}]@[{D},{D}] dot forms {DOT_FORMS[D]}",
                _dot_candidates(lib, lhs, inv.contiguous()), t, dot_rule("vm", D))
            add(f"einsum D={D} stage [1,{D}]@[{D},1] dot forms {DOT_FORMS[D]}",
                _dot_candidates(lib, t, rhs), torch.bmm(t, rhs), dot_rule("dot", D))
        elif name in ("norm", "sum"):
            x = args[0]
            key = f"{name} over {x.shape[-1]}"
            add(key, _red_candidates(lib, x, name == "norm", name == "norm"), out)
        elif name == "cross":
            a, b = (t.contiguous() for t in torch.broadcast_tensors(*args[:2]))
            cands = []
            for mode in range(len(CROSS_MODES)):
                c = torch.empty_like(a)
                _build.check(lib.probe_cross(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                             a.numel() // 3, 3, 3, mode), "probe_cross")
                cands.append(c)
            add("cross", cands, out)
        elif name in ("sin", "cos", "log", "sqrt", "reciprocal"):
            x = args[0].contiguous()
            y = torch.empty_like(x)
            op = ("sin", "cos", "log", "sqrt", "reciprocal").index(name)
            _build.check(lib.probe_unary(x.data_ptr(), y.data_ptr(), x.numel(), op), name)
            add(name, [y], out)
        elif name == "rdiv":  # c / x is torch's reciprocal(x) * c
            x = args[0].contiguous()
            y = torch.empty_like(x)
            _build.check(lib.probe_unary(x.data_ptr(), y.data_ptr(), x.numel(), 4), name)
            add("c / x", [y * args[1]], out)
        elif name == "div":
            a, b = (t.contiguous() for t in torch.broadcast_tensors(*args[:2]))
            y = torch.empty_like(a)
            _build.check(lib.probe_div(a.data_ptr(), b.data_ptr(), y.data_ptr(), a.numel()),
                         "div")
            add("div", [y], out)
    return table


def part_rules(device, n_obs=12):
    """The loop's operations on one frame's operands at both shapes against
    the probe's candidates. Returns {shape: table}."""
    lib = probe_library()
    print(f"rules: torch {torch.__version__}, cuBLAS TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, opt_einsum "
          f"{torch.backends.opt_einsum.is_available() and torch.backends.opt_einsum.enabled}")
    tables = {}
    frames = {shape: None for shape in SHAPES}
    frames.update({f"edges P={P}": P for P in EDGE_RULES_P})
    for shape, P in frames.items():
        if P is None:
            slam, states, inputs = _filter_frames(shape, device, frames=2)
            u, obs = inputs[-1][:2]
            args, kw = proposal_inputs(slam, states[-2], u, obs)
        else:
            slam, args, kw = edge_frame(device, P=P)
        Z = args[9].shape[0]
        cut = list(args)
        n = min(n_obs, Z)
        cut[3], cut[4], cut[9], cut[10] = (args[3][:, :n].contiguous(),
                                           args[4][:, :n].contiguous(), args[9][:n], args[10][:n])
        rec = _Recorder()
        with rec:
            twin(*cut, **dict(kw))
        P, Dz = args[0].shape[0], args[9].shape[1]
        word = int(pk.orders(P, Dz, device).item())
        check(not word & (1 << 16), f"rules {shape}: an order matched no candidate ({word:#x})")
        table = _rules_of_records(lib, rec.records, word)
        tables[shape] = table
        m = _matched_steps(cut, kw)
        sites = ", ".join(f"{k} {ORDER_NAMES[(word >> b) & 3]}" for k, b in ORDER_SHIFT.items())
        print(f"rules {shape} (P={P}, first {n} of Z={Z} observations, {int(m.sum())} matched "
              f"steps, {len(rec.records)} operations recorded; vector products: {sites}):")
        for key, row in sorted(table.items()):
            total, diffs = row["total"], row["diffs"]
            names = (None if "forms" in key or key.startswith("einsum") else
                     MM_MODES if key.startswith("matmul") else
                     RED_MODES if key.startswith(("norm", "sum")) else
                     CROSS_MODES if key == "cross" else None)
            cands = ", ".join(f"{names[k] if names else k}={d}" for k, d in enumerate(diffs))
            exact = [names[k] if names else k for k, d in enumerate(diffs) if d == 0]
            rule = row["rule"]
            mine = "" if rule is None else f"; the kernel's: {names[rule] if names else rule}"
            print(f"  {key}: {total} elements; bit-equal: {exact}{mine}; differing bits per "
                  f"candidate: {cands}")
    bad = [(s, k) for s, t in tables.items() for k, row in t.items()
           if row["rule"] is not None and row["diffs"][row["rule"]] != 0]
    check(not bad, f"rules: the kernel's rule (candidate 0) is not torch's for {bad}")
    return tables


# ---------------------------------------------------------------------------
# filter, system, edges
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _twin_route():
    saved = pk.propose_3d
    pk.propose_3d = twin
    try:
        yield
    finally:
        pk.propose_3d = saved


def _first_divergence(args, kw):
    """(n, particles, fields): the fewest leading observations after which
    kernel and twin differ (bisection), the particles and outputs that
    differ there."""
    def differ(n):
        a = list(args)
        a[3], a[4], a[9], a[10] = (args[3][:, :n].contiguous(), args[4][:, :n].contiguous(),
                                   args[9][:n], args[10][:n])
        got, ref = pk.propose_3d(*a, **kw), twin(*a, **kw)
        rows = [(g.reshape(g.shape[0], -1).view(torch.int32)
                 != r.reshape(r.shape[0], -1).view(torch.int32)).any(dim=1) for g, r in zip(got, ref)]
        return rows, got, ref

    lo, hi = 0, args[9].shape[0]
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if any(bool(r.any()) for r in differ(mid)[0]):
            hi = mid
        else:
            lo = mid
    rows, got, ref = differ(hi)
    bad = torch.nonzero(rows[0] | rows[1] | rows[2])[:, 0][:8].tolist()
    fields = {n: [(g[i].tolist(), r[i].tolist()) for i in bad[:2]]
              for n, g, r, row in zip(("pose", "P_cov", "log_w"), got, ref, rows) if row.any()}
    return hi, bad, fields


def _compare_or_locate(what, args, kw):
    got, ref = pk.propose_3d(*args, **kw), twin(*args, **kw)
    if all(_bits_equal(a, b) == 0 for a, b in zip(got, ref)):
        return
    n, bad, fields = _first_divergence(args, kw)
    print(f"{what}: first divergence after {n} observations, particles {bad}, "
          f"matched there {_matched_steps(args, kw)[bad, n - 1].tolist()}:")
    for name, pairs in fields.items():
        for g, r in pairs:
            print(f"  {name} kernel {g}\n  {name} twin   {r}")
    _compare(what, got, ref)


def part_filter(device, frames=8):
    """_propose through the kernel and through the twin from each frame's
    state and draws: the sampled poses and the log-weights."""
    for shape in SHAPES:
        slam, states, inputs = _filter_frames(shape, device, frames=frames)
        steps = 0
        for t in range(frames):
            u, obs, noise, _ = inputs[t]
            args, kw = proposal_inputs(slam, states[t], u, obs)
            _compare_or_locate(f"filter {shape} frame {t} refinement", args, kw)
            got, _ = slam._propose(states[t], u, obs, noise)
            with _twin_route():
                ref, _ = slam._propose(states[t], u, obs, noise)
            _compare(f"filter {shape} frame {t} sampled", (got.pose, got.log_w),
                     (ref.pose, ref.log_w), ("sampled pose", "log_w"))
            steps += int(_matched_steps(args, kw).sum())
        check(steps > 0, f"filter {shape}: no matched step in {frames} frames")
        print(f"filter {shape}: {frames} frames, {steps} matched steps: refined pose, P_cov, "
              f"log_w and the sampled poses bit-equal")


def _system_frames(shape, device, frames):
    from parakeet_slam_tpu_torch import cli
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.data.synth_vision import make_desk_world, make_drive_world

    path = SHAPES[shape][0]
    cfg = load_config(os.path.join(ROOT, path))
    if shape == "kitti00":
        world = make_drive_world(num_steps=frames + 1)
        pairs = [world.render_stereo(i) for i in range(frames)]
        left, right = [p[0] for p in pairs], [p[1] for p in pairs]
    else:
        world = make_desk_world(num_steps=frames + 1)
        left, right = [world.render(i) for i in range(frames)], None
    odom = cli._make_odometry(cfg.data, world.gt_pose, frames)
    return cfg, left, right, odom


def part_system(device, frames=(10, 40)):
    """The eager online system on rendered frames, every frame's proposal
    through the kernel and the twin."""
    from parakeet_slam_tpu_torch import cli, system

    for shape, n in zip(SHAPES, frames):
        cfg, left, right, odom = _system_frames(shape, device, n)
        seen = []
        kernel = pk.propose_3d

        def checked(*args, **kw):
            got = kernel(*args, **kw)
            _compare(f"system {shape} frame {len(seen)}", got, twin(*args, **kw))
            seen.append(int(_matched_steps(args, kw).sum()))
            return got

        checked.launches = 0
        sys_ = system.SLAMSystem(cfg, device=device, capture=False)
        pk.propose_3d = checked
        try:
            cli.run_image_sequence(sys_, left, odom, right=right)
            sys_.flush_flags()
        finally:
            pk.propose_3d = kernel
        check(len(seen) == n and sum(seen) > 0,
              f"system {shape}: {len(seen)} proposals in {n} frames, matched steps {seen}")
        print(f"system {shape} on rendered frames: {n} frames, matched steps a frame {seen}: "
              f"pose, P_cov and log_w bit-equal every frame")


def part_capture(device, frames=4):
    """The captured online system on kitti00's rendered frames: its frame
    graph counts one propose_3d launch a replay, and the filter's launches
    a frame are one."""
    from parakeet_slam_tpu_torch import cli, system

    cfg, left, right, odom = _system_frames("kitti00", device, frames)
    before = pk.propose_3d.launches
    sys_ = system.SLAMSystem(cfg, device=device)
    cli.run_image_sequence(sys_, left, odom, right=right)
    sys_.flush_flags()
    per_replay = [cs.launches_per_replay for cs in sys_._frame_steps.values()]
    launches = pk.propose_3d.launches - before
    check(per_replay and all(c.get("propose_3d") == 1 for c in per_replay),
          f"capture: frame graphs count {per_replay}")
    check(launches == frames, f"capture: {launches} propose_3d launches in {frames} frames")
    print(f"capture kitti00: {frames} frames, frame graphs' launches per replay {per_replay}, "
          f"propose_3d launches {launches}")
    return per_replay


def random_frame(shape, P, L, Z, seed=0, device="cpu"):
    """A random frame of the shape's measurement model: poses near the
    origin, lanes holding landmarks 5-20 m in front with small covariances
    (shared by the particles up to 5 cm), observation i of lane b_i as
    particle 0's pose sees it with pixel noise, each particle's best lane
    b_i (one in ten another lane), scores around log_p0 and counts 0-9.
    Returns (slam, args, kw): the wrapper's inputs."""
    from parakeet_slam_tpu_torch.core import geometry

    cfg, slam = _filter(shape, device)
    g = torch.Generator().manual_seed(seed)
    pose = torch.zeros(P, 7)
    pose[:, :3] = torch.randn(P, 3, generator=g) * 0.05
    pose[:, 3:] = geometry.quat_normalize(torch.tensor([0.0, 0.0, 0.0, 1.0]) +
                                          0.01 * torch.randn(P, 4, generator=g))
    A = torch.randn(P, 6, 6, generator=g) * 0.05
    P_cov = A @ A.transpose(-1, -2) + 1e-3 * torch.eye(6)
    lm = torch.stack([torch.randn(L, generator=g) * 2, torch.randn(L, generator=g),
                      5 + 15 * torch.rand(L, generator=g)], -1)
    lm_mean = lm + 0.05 * torch.randn(P, L, 3, generator=g)
    B = torch.randn(P, L, 3, 3, generator=g) * 0.05
    lm_cov = B @ B.transpose(-1, -2) + 1e-3 * torch.eye(3)
    lanes = torch.randint(0, L, (Z,), generator=g)
    best = lanes.expand(P, Z).clone()
    other = torch.rand(P, Z, generator=g) < 0.1
    best[other] = torch.randint(0, L, (int(other.sum()),), generator=g)
    log_p0 = slam._log_p0_assoc()
    best_ll = log_p0 + 6.0 + 4.0 * torch.randn(P, Z, generator=g)
    lm_count = torch.randint(0, 10, (P, L), generator=g, dtype=torch.int32)
    zhat = slam.model.h(pose[:1].expand(Z, 7), lm_mean[0, lanes])
    z = zhat + torch.randn(zhat.shape, generator=g)
    valid = torch.rand(Z, generator=g) < 0.9
    lm_valid = torch.rand(P, L, generator=g) < 0.9
    args = (pose, P_cov, torch.randn(P, generator=g), best.to(torch.int32), best_ll, lm_mean,
            lm_cov, lm_count, lm_valid.any(dim=-1), z.contiguous(), valid)
    kw = dict(measurement=slam.model, retract=slam.retract, camera=slam._camera,
              r_var=slam._meas_var(assoc=True), log_p0=log_p0,
              unmatched_w=0.0 if cfg.filter.weight_only_matched else cfg.filter.new_landmark_loglik,
              weight_min_count=cfg.filter.weight_min_count)
    return slam, tuple(t.to(device) for t in args), kw


def edge_frame(device, P=512, L=16, Z=10, seed=3):
    """`random_frame` at kitti00's stereo model, with crafted observations
    (see `part_edges`). Returns (slam, args, kw)."""
    from parakeet_slam_tpu_torch.core import geometry

    slam, args, kw = random_frame("kitti00", P, L, Z, seed)
    pose, P_cov, log_w, best, best_ll, lm_mean, lm_cov, lm_count, _, z, valid = (
        t.clone() for t in args)
    rows = torch.arange(P)
    best_ll[:] = kw["log_p0"] + 5.0
    lm_count[:] = 9
    valid[:] = True
    lm_valid = torch.ones(P, L, dtype=torch.bool)
    # 1: unmatched observation (score under log_p0)
    best_ll[:, 1] = -1e4
    # 2: the matched lane's count under weight_min_count
    lm_count[rows, best[:, 2].long()] = 1
    # 3: |delta| >= 1: a wide pose covariance and a far-off observation
    z[3] = z[3] + torch.tensor([400.0, -300.0, 20.0])
    P_cov[: P // 4] *= 1e4
    # 4: a non-finite S (an infinite landmark covariance), and a NaN one
    half = P // 2
    lm_cov[rows[:half], best[:half, 4].long()] = float("inf")
    lm_cov[rows[half:], best[half:, 4].long()] = float("nan")
    # 5: a landmark at the MIN_DEPTH clamp (just in front of, and behind, the camera)
    near = geometry.se3_apply(pose, torch.tensor([0.3, -0.2, 0.05]).expand(P, 3))
    behind = geometry.se3_apply(pose, torch.tensor([0.3, -0.2, -2.0]).expand(P, 3))
    lm_mean[rows, best[:, 5].long()] = torch.where(rows[:, None] % 2 == 0, near, behind)
    # 6: particles with no valid lane
    lm_valid[-4:] = False
    # 7: invalid observation slots
    valid[7] = False
    valid[9] = False
    args = (pose, P_cov, log_w, best, best_ll, lm_mean, lm_cov, lm_count, lm_valid.any(dim=-1),
            z, valid)
    kw = dict(kw, unmatched_w=slam.cfg.new_landmark_loglik)
    return slam, tuple(t.to(device) for t in args), kw


def part_edges(device, batches=(64, 512, 2048)):
    """The crafted frame, kernel against twin, at several batch counts (the
    vector products' orders change with it)."""
    for P in batches[:-1]:
        _compare_or_locate(f"edges P={P}", *edge_frame(device, P=P)[1:])
    slam, args, kw = edge_frame(device, P=batches[-1])
    _compare_or_locate(f"edges P={batches[-1]}", args, kw)
    # each crafted case took its branch in the twin: count the particles
    # whose step i changed the pose, by running the twin one observation at a time
    changed = []
    pose, P_cov, log_w = args[0], args[1], args[2]
    for i in range(args[9].shape[0]):
        a = list(args)
        a[0], a[1], a[2] = pose, P_cov, log_w
        a[3], a[4], a[9], a[10] = (args[3][:, i:i + 1].contiguous(),
                                   args[4][:, i:i + 1].contiguous(), args[9][i:i + 1],
                                   args[10][i:i + 1])
        npose, P_cov, log_w = twin(*a, **kw)
        changed.append(int((npose != pose).any(dim=-1).sum()))
        pose = npose
    for wmc, uw in ((0, kw["unmatched_w"]), (kw["weight_min_count"], 0.0)):
        k = dict(kw, weight_min_count=wmc, unmatched_w=uw)
        _compare(f"edges weight_min_count={wmc}", pk.propose_3d(*args, **k), twin(*args, **k))
    print(f"edges (P={', '.join(map(str, batches))}; at P={args[0].shape[0]} the particles "
          f"updated by each observation {changed}: 1 unmatched, 2 under weight_min_count, 3 |delta| >= 1 for the wide quarter, "
          f"4 non-finite S, 5 at the MIN_DEPTH clamp, 7 and 9 invalid, the last 4 particles "
          f"with no valid lane): kernel == twin bit for bit, also at weight_min_count 0 and "
          f"unmatched weight 0")
    check(changed[1] == 0 and changed[2] == 0 and changed[4] == 0 and changed[7] == 0
          and changed[9] == 0 and changed[0] > 0,
          f"edges: the crafted cases did not take their branches: {changed}")


# ---------------------------------------------------------------------------
# time
# ---------------------------------------------------------------------------


def step_ops(Dz):
    """Float operations of one matched step (an fma counts 2), counted from
    the kernel's arithmetic: the products of Q, S, K, delta and the Joseph
    form, the model's two 3x3 products, and ~400 more (camera point,
    inverse, symmetrisation, likelihood, norm, retraction)."""
    fma = (Dz * 3 * 3 + Dz * Dz * 3 + Dz * 6 * 6 + Dz * Dz * 6 + 6 * Dz * 6 + 6 * Dz * Dz
           + 6 * Dz + 6 * 6 * Dz + 2 * 6 * 6 * 6 + 6 * Dz * Dz + 6 * 6 * Dz + 2 * Dz * 3 * 3)
    return 2 * fma + 400


def bound_ms(args, kw):
    m = _matched_steps(args, kw)
    P, Z = m.shape
    Dz = args[9].shape[1]
    n_bytes = (int(m.sum()) * (12 * 4 + 4) + P * Z * 8 + P * (7 + 36 + 1) * 4 * 2
               + Z * (Dz * 4 + 1))
    ops = int(m.sum()) * step_ops(Dz)
    tb, to = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def part_time(device, reps=20):
    """The kernel's device time (queued behind a sleep), a single call's,
    and the twin's, on the 8th of 8 filter frames at each shape."""
    from parakeet_slam_tpu_torch.eval.profiling import queued, timed

    out = {}
    for shape in SHAPES:
        slam, states, inputs = _filter_frames(shape, device, frames=8)
        u, obs = inputs[-1][:2]
        args, kw = proposal_inputs(slam, states[-2], u, obs)
        kern = queued(lambda i: pk.propose_3d(*args, **kw), reps=reps)
        single = timed(lambda: pk.propose_3d(*args, **kw), reps=reps)[0]
        plain = timed(lambda: twin(*args, **kw), reps=3)[0]
        bnd = bound_ms(args, kw)
        m = _matched_steps(args, kw)
        P, Z = m.shape
        out[shape] = dict(ms=kern, ms_single_call=single, plain_ms=plain, bound_ms=bnd[0],
                          bound_by=bnd[1], matched_steps=int(m.sum()))
        print(f"time {shape} (P={P}, Z={Z}, {int(m.sum())} matched steps): kernel device "
              f"{kern:.4f} ms, single call {single:.4f} ms; twin {plain:.2f} ms; bound "
              f"{bnd[0]:.5f} ms ({bnd[1]})")
    return out


EDGE_RULES_P = (64, 256, 512, 1024, 2048)  # batch counts of the rules part's edge frames

PARTS = {"rules": part_rules, "filter": part_filter, "system": part_system,
         "edges": part_edges, "capture": part_capture, "time": part_time}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    a = ap.parse_args(argv)
    check(torch.cuda.is_available(), "needs a CUDA card")
    device = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    results = {}
    for part in a.parts.split(","):
        t = time.perf_counter()
        results[part] = PARTS[part](device)
        print(f"{part}: {time.perf_counter() - t:.1f} s")
    print(f"propose_check: all parts passed in {time.perf_counter() - t0:.1f} s")
    return results


if __name__ == "__main__":
    main()
