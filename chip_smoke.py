#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`parakeet_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. Phases:
  1. environment: torch/CUDA versions, card name and power limit, TF32 flags;
  2. build both hand-written kernels from `parakeet_slam_tpu_torch/csrc`;
  3. each kernel against its plain PyTorch twin on the card, at the corridor
     shape (P=64, L=192, Z=16, S=3) and the real-size shape (P=2048,
     L=10240, Z=32, S=3): masks, counts, target lanes and n_match equal,
     floats within rtol=atol=1e-5 (log_w atol=1e-4), the gather bit-exact;
     median times of kernel and twin with CUDA events; then the update
     kernel's other options (S=0, cull_unseen, no cull, no weight update,
     full and empty maps, L=130, Z=64) at small shapes;
  4. the main path, config 1 (configs/corridor.yaml) for 500 frames and
     filter seeds 0-4: every frame through the update kernel, every resample
     through the gather kernel, each ATE < 0.5 m, the 5-seed mean in the JAX
     reference band [0.136, 0.264] m;
  5. the main path at the real-size shape for 30 frames: finite, both
     kernels launched, frames/s and peak device memory.
Exits non-zero at the first failed check, and without a result when there
is no CUDA device or no package beside the script. The last line is
{"ok": true, "device": {...}}, the line before it the kernels' JSON record
and the line before that the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CORRIDOR_SHAPE = (64, 192, 16, 3)
REAL_SHAPE = (2048, 10240, 32, 3)
ATE_BAND = (0.136, 0.264)  # JAX reference: 0.2004 +- 0.0636 m over 5 seeds
STATE_KEYS = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_valid", "lm_count")


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps, prepare=None):
    """Median milliseconds of fn() on the card over `reps` timed calls."""
    from parakeet_slam_tpu_torch.eval.profiling import timed

    return timed(fn, reps=reps, prepare=prepare)[0]


def phase_environment():
    import torch

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    import parakeet_slam_tpu_torch  # noqa: F401  sets the TF32 flags

    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is enabled")
    return card


def phase_build():
    from parakeet_slam_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.library.build_seconds:.2f} s) sources={[s.name for s in _build.sources()]}")


# Options of the update kernel that the main path does not take, held
# against the twin at small shapes: (shape, map fill, flags).
UPDATE_VARIANTS = (
    ((64, 192, 16, 0), "holes", {}),
    ((64, 192, 16, 3), "holes", {"cull_unseen": True}),
    ((64, 192, 16, 3), "holes", {"cull": False}),
    ((64, 192, 16, 3), "holes", {"update_weights": False}),
    ((64, 192, 16, 3), "full", {}),
    ((64, 192, 16, 3), "empty", {}),
    ((8, 130, 8, 3), "holes", {}),
    ((16, 300, 64, 4), "holes", {}),
)


def _update_inputs(shape, seed, device, fill="holes"):
    import torch

    from parakeet_slam_tpu_torch.eval.kernel_inputs import prefilled_frame

    P, L, Z, S = shape
    fr = prefilled_frame(P, L, Z, S, seed, fill=fill)
    return {k: torch.as_tensor(v, device=device) for k, v in fr.items()}


def check_update_kernel(shape, device, fill="holes", timed=True, **flags):
    import torch

    from parakeet_slam_tpu_torch.kernels import ekf_update

    P, L, Z, S = shape
    T = _update_inputs(shape, seed=sum(shape), device=device, fill=fill)
    kw = dict(sig_dim=S, r_var=(0.01, 0.0009), sig_var=0.25, log_p0=-8.0,
              init_infl=1.0, max_range=6.5, fov_half=2.5, cull=True)
    kw.update(flags)
    state = [T[k] for k in STATE_KEYS]
    obs = [T["z"], T["sig"], T["valid"]]
    ref = ekf_update.measurement_update_2d_reference(*state, *obs, **kw)
    work = [t.clone() for t in state]
    got = ekf_update.measurement_update_2d(*work, *obs, **kw)
    torch.cuda.synchronize()
    names = ("log_w", "lm_mean", "lm_cov", "lm_sig", "lm_valid", "lm_count", "n_match", "target")
    err = 0.0
    for name, g, r in zip(names, got, ref):
        if name in ("lm_valid", "lm_count", "n_match", "target"):
            n_bad = int((g != r).sum())
            check(n_bad == 0, f"ekf_update_2d {shape} {fill} {flags}: {name} differs in {n_bad} entries")
        else:
            d = float((g - r).abs().max()) if g.numel() else 0.0
            err = max(err, d)
            tol = dict(rtol=0.0, atol=1e-4) if name == "log_w" else dict(rtol=1e-5, atol=1e-5)
            check(torch.allclose(g, r, **tol), f"ekf_update_2d {shape} {fill} {flags}: {name} max |diff| {d}")
    n_upd = int((ref[7] >= 0).sum())
    n_coll = int(sum(int((t >= 0).sum()) - len(set(t[t >= 0].tolist())) for t in ref[7].cpu()))

    if not timed:
        print(f"ekf_update_2d P={P} L={L} Z={Z} S={S} fill={fill} {flags}: targets={n_upd} "
              f"collisions={n_coll} max_abs_err={err:.3g} agrees")
        return err, None, None

    def reset():
        for w, s in zip(work, state):
            w.copy_(s)

    reps = 20 if P < 1024 else 10
    ms = cuda_ms(lambda: ekf_update.measurement_update_2d(*work, *obs, **kw), reps, reset)
    plain = cuda_ms(lambda: ekf_update.measurement_update_2d_reference(*state, *obs, **kw), reps)
    print(f"ekf_update_2d P={P} L={L} Z={Z} S={S}: targets={n_upd} collisions={n_coll} "
          f"max_abs_err={err:.3g} kernel={ms:.4f} ms twin={plain:.4f} ms")
    return err, ms, plain


def check_gather_kernel(shape, device):
    import torch

    from parakeet_slam_tpu_torch.core.state import ParticleState
    from parakeet_slam_tpu_torch.kernels import resample, resample_cuda

    P, L, Z, S = shape
    T = _update_inputs(shape, seed=sum(shape) + 1, device=device)
    st = ParticleState(
        **{k: T[k] for k in STATE_KEYS},
        lm_desc=torch.zeros(P, L, 0, dtype=torch.int32, device=device),
    )
    g = torch.Generator(device=device).manual_seed(0)
    log_w = 3.0 * torch.randn(P, generator=g, device=device)
    idx = resample.systematic_resample_indices(log_w, 0.37 / P)
    got = resample_cuda.gather_state(st, idx)
    ref = resample_cuda.gather_state_reference(st, idx)
    torch.cuda.synchronize()
    err = 0.0
    for k in STATE_KEYS + ("lm_desc",):
        a, b = getattr(got, k), getattr(ref, k)
        check(torch.equal(a, b), f"gather_rows {shape}: {k} differs")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    n_bytes = sum(t.numel() * t.element_size() for t in st.__dict__.values() if t is not st.log_w)
    # Resampling indices repeat rows, and a repeated row is read from L2; a
    # permutation reads every row once, the full traffic. The record keeps
    # the permutation's times.
    perm = torch.randperm(P, generator=g, device=device)
    for name, ix in (("resample idx", idx), ("permutation", perm)):
        ms = cuda_ms(lambda: resample_cuda.gather_state(st, ix), 20)
        plain = cuda_ms(lambda: resample_cuda.gather_state_reference(st, ix), 20)
        print(f"gather_rows P={P} L={L} S={S} {name} ({len(set(ix.tolist()))} distinct rows): "
              f"{n_bytes / 1e9:.4f} GB per copy, kernel={ms:.4f} ms "
              f"({2 * n_bytes / ms / 1e9:.3f} TB/s) twin={plain:.4f} ms")
    return err, ms, plain


def phase_kernels(device):
    res = {}
    for shape in (CORRIDOR_SHAPE, REAL_SHAPE):
        res[("ekf", shape)] = check_update_kernel(shape, device)
        res[("gather", shape)] = check_gather_kernel(shape, device)
    err = max(res[("ekf", s)][0] for s in (CORRIDOR_SHAPE, REAL_SHAPE))
    for shape, fill, flags in UPDATE_VARIANTS:
        err = max(err, check_update_kernel(shape, device, fill, timed=False, **flags)[0])
    return res, err


def _reset_counts():
    from parakeet_slam_tpu_torch.kernels import ekf_update, resample_cuda

    ekf_update.measurement_update_2d.launches = 0
    resample_cuda.gather_state.launches = 0


def _counts():
    from parakeet_slam_tpu_torch.kernels import ekf_update, resample_cuda

    return ekf_update.measurement_update_2d.launches, resample_cuda.gather_state.launches


def phase_corridor(device):
    from parakeet_slam_tpu_torch.cli import measure_corridor

    steps, seeds = 500, range(5)
    _reset_counts()
    r = measure_corridor(device, steps, seeds)
    launches = _counts()
    for s, a, f, n in zip(seeds, r["ates"], r["fps_runs"], r["resamples"]):
        print(f"corridor seed {s}: ate={a:.4f} m fps={f:.1f} resamples={n}")
    print(f"corridor config 1: ate mean={r['ate']:.4f} m std={r['ate_std']:.4f} m "
          f"fps median={r['fps']:.1f} launches ekf={launches[0]} gather={launches[1]}")
    check(r["est_finite"], "corridor trajectory not finite")
    check(launches[0] == steps * len(seeds), f"ekf launches {launches[0]} != {steps * len(seeds)}")
    n_res = sum(r["resamples"])
    check(launches[1] == n_res and n_res > 0, f"gather launches {launches[1]}, resamples {n_res}")
    check(all(a < 0.5 for a in r["ates"]), f"ATE >= 0.5 m: {r['ates']}")
    check(ATE_BAND[0] <= r["ate"] <= ATE_BAND[1], f"5-seed ATE {r['ate']:.4f} outside {ATE_BAND}")
    return launches


def phase_real_size(device):
    import dataclasses

    import torch

    from parakeet_slam_tpu_torch.cli import corridor_config, run_corridor
    from parakeet_slam_tpu_torch.data import make_corridor
    from parakeet_slam_tpu_torch.filter import make_filter

    P, L, Z, _ = REAL_SHAPE
    cfg = dataclasses.replace(
        corridor_config(), num_particles=P, max_landmarks=L, max_observations=Z
    )
    sim = make_corridor(num_landmarks=100, num_steps=30, max_obs=Z, seed=7)
    slam = make_filter(cfg)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    run = run_corridor(slam, sim, 0, device)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"real size P={P} L={L} Z={Z}: 30 frames fps={run['fps']:.2f} ate={run['ate']:.4f} m "
          f"peak_mem={peak / 2**30:.3f} GiB launches ekf={launches[0]} gather={launches[1]}")
    check(bool(torch.isfinite(run["est"]).all()), "real-size trajectory not finite")
    check(launches[0] == 30 and launches[1] >= 1, f"real-size launches {launches}")


def main():
    if not os.path.isdir(os.path.join(HERE, "parakeet_slam_tpu_torch", "csrc")):
        raise SystemExit("chip_smoke FAILED: run from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    card = phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    k, ekf_err = phase_kernels(device)
    launches = phase_corridor(device)
    phase_real_size(device)

    pkg = "parakeet_slam_tpu_torch"
    record = {"kernels": [
        {"name": "ekf_update_2d", "route": "cuda", "source": f"{pkg}/csrc/ekf_update_2d.cu",
         "replaces": "parakeet_slam_tpu/kernels/ekf_update.py:443", "launches": launches[0],
         "max_abs_err": ekf_err,
         "ms": k[("ekf", REAL_SHAPE)][1], "plain_ms": k[("ekf", REAL_SHAPE)][2],
         "ms_corridor": k[("ekf", CORRIDOR_SHAPE)][1],
         "plain_ms_corridor": k[("ekf", CORRIDOR_SHAPE)][2]},
        {"name": "gather_rows", "route": "cuda", "source": f"{pkg}/csrc/gather_rows.cu",
         "replaces": "parakeet_slam_tpu/kernels/resample_pallas.py:32", "launches": launches[1],
         "max_abs_err": max(k[("gather", s)][0] for s in (CORRIDOR_SHAPE, REAL_SHAPE)),
         "ms": k[("gather", REAL_SHAPE)][1], "plain_ms": k[("gather", REAL_SHAPE)][2],
         "ms_corridor": k[("gather", CORRIDOR_SHAPE)][1],
         "plain_ms_corridor": k[("gather", CORRIDOR_SHAPE)][2]},
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
