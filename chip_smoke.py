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
     kernels launched, frames/s and peak device memory;
  6. the two 3-D kernels (measurement_update_3d, score_3d) against their
     twins: each model at the bench shape (P=1024, L=8192, Z=32) and stereo
     at the KITTI shape (P=2048, L=10240, Z=128), with median times, then
     the options (external scores, no weight update, freeze, cull_unseen,
     no cull, full and empty maps, L=1100, Z=128 past the 64-slot cap) at
     small shapes. Masks, counts, target lanes, n_match, descriptors and
     score lanes equal; scores, means and covariances within
     rtol=atol=1e-5, log_w within atol=2e-3 + rtol=1e-6 (sums over up to
     128 observations in another order); the update fed score_3d's scores
     equal to the update that scores itself;
  7. the vision path at full width, driver config 3 (configs/kitti_00.yaml:
     FastSLAM 2.0, stereo_3d, P=2048, L=10240, Z=128) for 30 frames of the
     synthetic drive world: one score_3d and one measurement_update_3d
     launch per frame, one gather per resample, a finite trajectory,
     frames/s, peak device memory, ATE against ground truth and dead
     reckoning (printed, not gated); the kernel path and the twin path
     give equal masks and counts over the first 3 frames from the same
     draws;
  8. the ekf_update_3d, fs1_step and fs2_step rows of the kernel bench.
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


# --------------------------------------------------------------------------
# Slice 2: the 3-D vision filter
# --------------------------------------------------------------------------

BENCH_3D = (1024, 8192, 32)
KITTI_3D = (2048, 10240, 128)
STATE_3D = ("pose", "log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid", "lm_count")
NOISE_3D = {"pinhole_3d": (2.0, 2.0), "stereo_3d": (1.5, 1.5, 1.0), "equirect_3d": (3.0, 3.0)}
# (model, (P, L, Z), map fill, options) of the small-shape variants
UPDATE_3D_VARIANTS = (
    ("stereo_3d", (64, 512, 32), "holes", {"ext": True}),
    ("pinhole_3d", (64, 512, 32), "holes", {"update_weights": False}),
    ("stereo_3d", (64, 512, 32), "holes", {"freeze": 4}),
    ("equirect_3d", (64, 512, 32), "holes", {"cull_unseen": True}),
    ("pinhole_3d", (64, 512, 32), "holes", {"cull": False}),
    ("equirect_3d", (64, 512, 32), "full", {}),
    ("stereo_3d", (64, 512, 32), "empty", {}),
    ("pinhole_3d", (16, 1100, 8), "holes", {}),
    ("stereo_3d", (16, 256, 128), "empty", {}),
)


def _kw_3d(model, **flags):
    from parakeet_slam_tpu_torch.eval.kernel_inputs import camera_par

    kw = dict(model=model, desc_words=8, par=camera_par(model),
              r_var=tuple(v * v for v in NOISE_3D[model]), desc_weight=0.5, log_p0=-30.0,
              init_infl=1.0, init_range_prior=8.0, init_range_sigma=3.0, max_range=35.0,
              cull=True)
    kw.update(flags)
    return kw


def _score_kw(kw):
    return {k: kw[k] for k in ("model", "desc_words", "par", "r_var", "desc_weight")}


def _frame_3d(model, shape, fill, device):
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.eval.kernel_inputs import prefilled_frame_3d

    P, L, Z = shape
    fr = prefilled_frame_3d(P, L, Z, model, seed=P + L + Z, fill=fill)
    return {k: torch.as_tensor(v.view(np.int32) if v.dtype == np.uint32 else v, device=device)
            for k, v in fr.items()}


def _compare_3d(what, got, ref):
    """Equal masks, counts, lanes and descriptors; floats within the stated
    tolerances. Returns the largest float difference."""
    import torch

    names = ("log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid", "lm_count", "n_match", "target")
    err = 0.0
    for name, g, r in zip(names, got, ref):
        if name in ("lm_desc", "lm_valid", "lm_count", "n_match", "target"):
            n_bad = int((g != r).sum())
            check(n_bad == 0, f"{what}: {name} differs in {n_bad} entries")
            continue
        d = float((g - r).abs().max()) if g.numel() else 0.0
        err = max(err, d)
        tol = dict(rtol=1e-6, atol=2e-3) if name == "log_w" else dict(rtol=1e-5, atol=1e-5)
        check(torch.allclose(g, r, **tol), f"{what}: {name} max |diff| {d}")
    return err


def check_update_3d(model, shape, device, fill="holes", timed=True, ext=False, **flags):
    """measurement_update_3d and score_3d against their twins on one frame."""
    import torch

    from parakeet_slam_tpu_torch.kernels import ekf_update_3d as E

    T = _frame_3d(model, shape, fill, device)
    kw = _kw_3d(model, **flags)
    state = [T[k] for k in STATE_3D]
    obs = [T["z"], T["desc"], T["valid"]]
    score_args = (T["pose"], T["lm_mean"], T["lm_cov"], T["lm_desc"], T["lm_valid"],
                  T["z"], T["desc"])
    sk = _score_kw(kw)
    ll, ix = E.score_3d(*score_args, **sk)
    r_ll, r_ix = E.score_3d_reference(*score_args, **sk)
    torch.cuda.synchronize()
    what = f"{model} P,L,Z={shape} {fill} {flags}{' ext' if ext else ''}"
    check(torch.equal(ix, r_ix), f"score_3d {what}: lanes differ in {int((ix != r_ix).sum())}")
    s_err = float((ll - r_ll).abs().max())
    check(torch.allclose(ll, r_ll, rtol=1e-5, atol=1e-5), f"score_3d {what}: ll max |diff| {s_err}")
    extra = (ll, ix) if ext else ()
    ref = E.measurement_update_3d_reference(*state, *obs, *((r_ll, r_ix) if ext else ()), **kw)
    work = [t.clone() for t in state]
    got = E.measurement_update_3d(*work, *obs, *extra, **kw)
    torch.cuda.synchronize()
    err = max(s_err, _compare_3d(f"measurement_update_3d {what}", got, ref))
    n_upd = int((ref[7] >= 0).sum())
    if not ext:  # the update fed score_3d's scores == the update that scores itself
        fed = [t.clone() for t in state]
        out = E.measurement_update_3d(*fed, *obs, ll, ix, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid",
                               "lm_count", "n_match", "target"), out, got):
            check(torch.equal(a, b), f"{what}: update with score_3d scores differs in {name}")
    if not timed:
        print(f"ekf_update_3d {what}: targets={n_upd} max_abs_err={err:.3g} agrees")
        return err, None
    P = shape[0]
    reps_k, reps_t = (10, 5) if P <= 1024 else (5, 3)

    def reset():
        for w, s in zip(work, state):
            w.copy_(s)

    t = {
        "update": cuda_ms(lambda: E.measurement_update_3d(*work, *obs, **kw), reps_k, reset),
        "update_twin": cuda_ms(lambda: E.measurement_update_3d_reference(*state, *obs, **kw), reps_t),
        "score": cuda_ms(lambda: E.score_3d(*score_args, **sk), reps_k),
        "score_twin": cuda_ms(lambda: E.score_3d_reference(*score_args, **sk), reps_t),
    }
    print(f"ekf_update_3d {what}: targets={n_upd} max_abs_err={err:.3g} "
          f"update kernel={t['update']:.4f} ms twin={t['update_twin']:.4f} ms | "
          f"score_3d kernel={t['score']:.4f} ms twin={t['score_twin']:.4f} ms")
    return err, t


def phase_kernels_3d(device):
    res = {}
    for model in ("pinhole_3d", "stereo_3d", "equirect_3d"):
        res[model] = check_update_3d(model, BENCH_3D, device)
    res["kitti"] = check_update_3d("stereo_3d", KITTI_3D, device)
    err = max(r[0] for r in res.values())
    for model, shape, fill, flags in UPDATE_3D_VARIANTS:
        err = max(err, check_update_3d(model, shape, device, fill, timed=False, **flags)[0])
    return res, err


def _reset_counts_3d():
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d, resample_cuda

    ekf_update_3d.score_3d.launches = 0
    ekf_update_3d.measurement_update_3d.launches = 0
    resample_cuda.gather_state.launches = 0


def _counts_3d():
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d, resample_cuda

    return (ekf_update_3d.score_3d.launches, ekf_update_3d.measurement_update_3d.launches,
            resample_cuda.gather_state.launches)


def vision_sequence(world, frames, Z, W, device):
    """(odom, obs_z, obs_sig, obs_valid, obs_desc) of the first `frames`
    frames of a drive world, on `device`."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.eval.kernel_inputs import drive_observations

    obs = [drive_observations(world, t, Z, W, seed=0) for t in range(frames)]
    T = lambda a: torch.as_tensor(np.stack(a), device=device)  # noqa: E731
    return (T(world.odom[:frames]), T([o[0] for o in obs]),
            torch.zeros(frames, Z, 0, device=device), T([o[2] for o in obs]),
            T([o[1].view(np.int32) for o in obs]))


def _twin_path():
    """Route the filter through the plain twins (the check of the kernel path)."""
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d, resample_cuda

    saved = (ekf_update_3d.measurement_update_3d, ekf_update_3d.score_3d,
             resample_cuda.gather_state)
    ekf_update_3d.measurement_update_3d = ekf_update_3d.measurement_update_3d_reference
    ekf_update_3d.score_3d = ekf_update_3d.score_3d_reference
    resample_cuda.gather_state = resample_cuda.gather_state_reference

    def restore():
        (ekf_update_3d.measurement_update_3d, ekf_update_3d.score_3d,
         resample_cuda.gather_state) = saved

    return restore


def phase_vision(device, frames=30, config="configs/kitti_00.yaml", check_frames=3):
    import torch

    from parakeet_slam_tpu_torch.core import geometry
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.data import make_drive_world
    from parakeet_slam_tpu_torch.eval import ate_rmse
    from parakeet_slam_tpu_torch.filter import run_sequence
    from parakeet_slam_tpu_torch.filter.fastslam2 import FastSLAM2, make_filter
    from parakeet_slam_tpu_torch.filter.runner import draw_noise

    cfg = load_config(os.path.join(HERE, config))
    fc = cfg.filter
    slam = make_filter(fc, cfg.frontend)
    check(isinstance(slam, FastSLAM2) and slam.model.name == "stereo_3d", f"{config}: {slam}")
    P, L, Z, W = fc.num_particles, fc.max_landmarks, fc.max_observations, fc.desc_words
    world = make_drive_world(num_steps=frames)
    data = vision_sequence(world, frames, Z, W, device)
    state0 = slam.init_state(init_pose=world.gt_pose[0], device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts_3d()
    t0 = time.perf_counter()
    _, est, metrics = run_sequence(slam, state0, *data[:4], generator=gen, obs_desc=data[4])
    est = est.cpu()
    dt = time.perf_counter() - t0
    launches = _counts_3d()
    peak = torch.cuda.max_memory_allocated()
    n_res = sum(m.resampled for m in metrics)
    gt = torch.as_tensor(world.gt_pose[:frames])
    dr = [gt[0]]
    for t in range(1, frames):
        dr.append(geometry.se3_compose(dr[-1], geometry.se3_exp(torch.as_tensor(world.odom[t]))))
    ate = float(ate_rmse(est[:, :3], gt[:, :3]))
    ate_dr = float(ate_rmse(torch.stack(dr)[:, :3], gt[:, :3]))
    n_obs = int(data[3].sum())
    print(f"vision config 3 (FastSLAM 2.0 stereo_3d P={P} L={L} Z={Z}): {frames} frames "
          f"fps={frames / dt:.3f} peak_mem={peak / 2**30:.3f} GiB obs={n_obs} "
          f"landmarks/particle={float(metrics[-1].num_landmarks):.1f} resamples={n_res} "
          f"launches score_3d={launches[0]} update_3d={launches[1]} gather={launches[2]}")
    print(f"vision config 3: ate={ate:.4f} m dead_reckoning_ate={ate_dr:.4f} m (not gated)")
    check(bool(torch.isfinite(est).all()), "vision trajectory not finite")
    check(launches[0] == frames and launches[1] == frames,
          f"vision launches score_3d={launches[0]} update_3d={launches[1]}, frames {frames}")
    check(launches[2] == n_res, f"vision gather launches {launches[2]}, resamples {n_res}")

    # kernel path vs twin path over the first frames, from the same draws
    noise, u0 = draw_noise(check_frames, P, slam.noise_dim, gen, device)
    short = [a[:check_frames] for a in data]
    kernel_final, kernel_est, _ = run_sequence(slam, state0, *short[:4], motion_noise=noise,
                                               resample_u0=u0, obs_desc=short[4])
    restore = _twin_path()
    try:
        twin_final, twin_est, _ = run_sequence(slam, state0, *short[:4], motion_noise=noise,
                                               resample_u0=u0, obs_desc=short[4])
    finally:
        restore()
    for k in ("lm_valid", "lm_count"):
        a, b = getattr(kernel_final, k), getattr(twin_final, k)
        check(torch.equal(a, b), f"vision kernel vs twin path: {k} differs in {int((a != b).sum())}")
    pose_err = float((kernel_est - twin_est).abs().max())
    print(f"vision kernel vs twin path, {check_frames} frames: lm_valid and lm_count equal "
          f"({int(kernel_final.lm_valid.sum())} live lanes), est max |diff| {pose_err:.3g}")
    return {"fps": frames / dt, "launches": launches, "ate": ate, "ate_dr": ate_dr,
            "peak_gib": peak / 2**30}


def phase_bench_rows(device):
    from parakeet_slam_tpu_torch.eval import bench_kernels

    return {r["kernel"]: r for r in bench_kernels.run(
        ["ekf_update_3d", "fs1_step", "fs2_step"], device)}


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
    k3, err3 = phase_kernels_3d(device)
    vision = phase_vision(device)
    phase_bench_rows(device)

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
        {"name": "measurement_update_3d", "route": "cuda", "source": f"{pkg}/csrc/ekf_update_3d.cu",
         "replaces": "parakeet_slam_tpu/kernels/ekf_update_3d.py:664",
         "launches": vision["launches"][1], "max_abs_err": err3,
         "ms": k3["kitti"][1]["update"], "plain_ms": k3["kitti"][1]["update_twin"],
         "ms_bench_equirect": k3["equirect_3d"][1]["update"],
         "plain_ms_bench_equirect": k3["equirect_3d"][1]["update_twin"]},
        {"name": "score_3d", "route": "cuda", "source": f"{pkg}/csrc/ekf_update_3d.cu",
         "replaces": "parakeet_slam_tpu/kernels/ekf_update_3d.py:920",
         "launches": vision["launches"][0], "max_abs_err": err3,
         "ms": k3["kitti"][1]["score"], "plain_ms": k3["kitti"][1]["score_twin"],
         "ms_bench_equirect": k3["equirect_3d"][1]["score"],
         "plain_ms_bench_equirect": k3["equirect_3d"][1]["score_twin"]},
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
