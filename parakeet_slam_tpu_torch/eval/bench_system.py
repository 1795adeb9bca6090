"""End-to-end vision-pipeline throughput (port of
`parakeet_slam_tpu.eval.bench_system`): frontend -> filter -> keyframe
backend frames/s on the synthetic worlds, the online-system analog of the
corridor benchmark's filter-only number.

Frames are rendered before the timed loop, in worker processes (in threads
the renderer's Python loop holds the interpreter lock often enough to stall
a caller's own host loop many times over: measured on the card's host), so
the measurement is the online system's work (detect, describe, disparity,
the fused update, resampling, keyframes and closures), not the numpy
renderer's. The timing fence is `torch.cuda.synchronize`.

    python -m parakeet_slam_tpu_torch.eval.bench_system --config pano|stereo [--frames N]

runs on the card, and refuses without one; `bench_system(...,
device="cpu")` runs on the CPU through the kernels' plain twins.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import torch

WARMUP = 5  # untimed frames before the timed ones


def _pano_cfg(P=256, L=2048, Z=64, H=512, W=1024):
    from parakeet_slam_tpu_torch.core.config import (
        BackendConfig, FilterConfig, FrontendConfig, SLAMConfig,
    )

    return SLAMConfig(
        filter=FilterConfig(
            num_particles=P, max_landmarks=L, max_observations=Z,
            lm_dim=3, obs_dim=2, pose_dim=7, sig_dim=0, desc_words=8,
            measurement_model="equirect_3d", motion_model="se3_odometry",
            motion_noise=(0.02, 0.01), meas_noise=(2.0, 2.0),
            new_landmark_loglik=-12.0, max_range=60.0, use_pallas=True,
        ),
        frontend=FrontendConfig(
            detector="fast", max_features=Z, fast_threshold=0.10,
            camera="equirect", image_size=(H, W),
        ),
        backend=BackendConfig(max_keyframes=256, keyframe_translation=0.5),
    )


def _stereo_cfg(P=256, L=2048, Z=64, H=376, W=1241):
    from parakeet_slam_tpu_torch.core.config import (
        BackendConfig, FilterConfig, FrontendConfig, SLAMConfig,
    )

    fx = 718.856
    return SLAMConfig(
        filter=FilterConfig(
            num_particles=P, max_landmarks=L, max_observations=Z,
            lm_dim=3, obs_dim=3, pose_dim=7, sig_dim=0, desc_words=8,
            measurement_model="stereo_3d", motion_model="se3_odometry",
            motion_noise=(0.02, 0.01), meas_noise=(2.0, 2.0, 1.5),
            new_landmark_loglik=-14.0, max_range=80.0, use_pallas=True,
        ),
        frontend=FrontendConfig(
            detector="fast", max_features=Z, fast_threshold=0.10,
            camera="stereo", baseline=0.537,
            intrinsics=(fx, fx, 607.19, 185.22), image_size=(H, W),
        ),
        backend=BackendConfig(max_keyframes=256, keyframe_translation=1.0),
    )


def bench_world(kind: str, frames: int, **size_kw):
    """(cfg, world, render, args): the configuration of `kind`, its world of
    frames + 5 steps (the reference's trajectory for that many frames), and
    the renderer with each frame's arguments: equirect images ("pano") or
    (left, right) pairs ("stereo")."""
    from parakeet_slam_tpu_torch.data.panoramic import make_panoramic_world

    n = frames + WARMUP
    if kind == "pano":
        cfg = _pano_cfg(**size_kw)
        world = make_panoramic_world(num_landmarks=400, num_steps=n,
                                     image_size=cfg.frontend.image_size, camera="equirect", seed=7)
        return cfg, world, world.render, [(t,) for t in range(n)]
    if kind == "stereo":
        cfg = _stereo_cfg(**size_kw)
        world = make_panoramic_world(num_landmarks=400, num_steps=n,
                                     image_size=cfg.frontend.image_size, camera="pinhole",
                                     radius=10.0, seed=7)
        return cfg, world, world.render_stereo, [(t, cfg.frontend.baseline) for t in range(n)]
    raise ValueError(f"unknown bench_system kind {kind!r} (pano | stereo)")


def render_pool(n_frames: int) -> ProcessPoolExecutor:
    """Worker processes for `n_frames` renders: all cores but two."""
    workers = max(1, min(n_frames, (os.cpu_count() or 2) - 2))
    return ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))


def bench_frames(kind: str, frames: int, **size_kw):
    """(cfg, world, inputs): `bench_world`'s frames, all rendered."""
    cfg, world, render, args = bench_world(kind, frames, **size_kw)
    with render_pool(len(args)) as ex:
        inputs = list(ex.map(render, *zip(*args)))
    return cfg, world, inputs


def frame_step(kind: str, world, inputs):
    """step(system, t): frame t through the system's entry point."""
    if kind == "pano":
        return lambda s, t: s.process_frame(inputs[t], world.odom[t])
    return lambda s, t: s.process_stereo_frame(*inputs[t], world.odom[t])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_bench(kind: str, cfg, world, inputs, frames: int, device="cuda"):
    """The timed run on pre-rendered inputs: 5 untimed frames, then `frames`
    frames, fenced by `torch.cuda.synchronize`. Returns (the result, whose
    keys are the reference's and whose `device` is the card's name or
    "cpu"; the system after the run)."""
    from parakeet_slam_tpu_torch.system import SLAMSystem

    step = frame_step(kind, world, inputs)
    sys_ = SLAMSystem(cfg, device=device)
    for t in range(WARMUP):
        step(sys_, t)
    _sync(device)
    t0 = time.perf_counter()
    for t in range(WARMUP, WARMUP + frames):
        step(sys_, t)
    _sync(device)
    dt = (time.perf_counter() - t0) / frames
    name = torch.cuda.get_device_name(torch.device(device)) if torch.device(
        device).type == "cuda" else "cpu"
    return {
        "pipeline": kind,
        "particles": cfg.filter.num_particles,
        "max_landmarks": cfg.filter.max_landmarks,
        "image": list(cfg.frontend.image_size),
        "fps_per_chip": round(1.0 / dt, 1),
        "ms_per_frame": round(dt * 1e3, 2),
        "keyframes": len(sys_.keyframes),
        "device": name,
    }, sys_


def bench_system(kind: str = "pano", frames: int = 30, device="cuda", **size_kw) -> dict:
    """Frames/s of the online system: `kind` "pano" (`process_frame` on
    equirect frames, FastSLAM 1.0 equirect_3d) or "stereo"
    (`process_stereo_frame` on stereo pairs, FastSLAM 1.0 stereo_3d), at
    the reference's widths unless `size_kw` (P, L, Z, H, W) says otherwise."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_system: no CUDA device (pass device='cpu' for the CPU)")
    cfg, world, inputs = bench_frames(kind, frames, **size_kw)
    return run_bench(kind, cfg, world, inputs, frames, device)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="parakeet_slam_tpu_torch.eval.bench_system")
    ap.add_argument("--config", default="pano", choices=["pano", "stereo"])
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_system: no CUDA device")
    print(json.dumps(bench_system(args.config, args.frames)))


if __name__ == "__main__":
    main()
