"""Per-kernel benchmarks (port of `parakeet_slam_tpu.eval.bench_kernels`):
the rows ekf_update, ekf_update_3d, resample, fs1_step, fs2_step, match,
schur and ba_iteration at the reference's shapes, one JSON row each.

On the card each call is timed with CUDA events (median of `reps` after a
warm-up), with the state restored untimed before every call, because the
kernels update it in place. Each row gives the bytes moved and FLOP/s by
the reference's own accounting and the share of the card's peak bandwidth
(H100: 3.35 TB/s). `--device cpu` times the plain twins with the host clock
and reports no device share. `python -m parakeet_slam_tpu_torch.cli bench
--kernel NAME` is the front door.
"""

from __future__ import annotations

import json
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

from parakeet_slam_tpu_torch.eval.kernel_inputs import (
    BA_BENCH_CAMERA,
    ba_bench_problem,
    bench_frame_3d,
    camera_par,
    schur_blocks,
)

# Published peaks (device memory GB/s, float32 TFLOP/s outside the tensor
# cores) by card name; SXM parts at their full power limit.
_PEAKS = {"H100": (3350.0, 67.0), "H200": (4800.0, 67.0)}

STATE_KEYS = ("pose", "log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid", "lm_count")


def _peak(device):
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in _PEAKS.items() if k in name), None)


def time_call(fn, device, reps, prepare=None):
    """Median milliseconds of fn(): CUDA events on the card, the host clock
    on the CPU; `prepare()` runs untimed before every call."""
    if device.type == "cuda":
        from parakeet_slam_tpu_torch.eval.profiling import timed

        return timed(fn, reps=reps, prepare=prepare)[0]
    times = []
    for i in range(1 + reps):
        if prepare is not None:
            prepare()
        t0 = time.perf_counter()
        fn()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _tensors(frame, device):
    out = {}
    for k, v in frame.items():
        a = v.view(np.int32) if v.dtype == np.uint32 else v
        out[k] = torch.as_tensor(a, device=device)
    return out


def _restorer(work, saved):
    def restore():
        for w, s in zip(work, saved):
            w.copy_(s)

    return restore


def bench_ekf(device, P=2048, L=10240, Z=32, reps=5):
    """The fused 2-D update at KITTI-config scale, every lane valid."""
    from parakeet_slam_tpu_torch.kernels import ekf_update

    rng = np.random.default_rng(0)
    f32 = np.float32
    T = _tensors(dict(
        pose=rng.normal(size=(P, 3)).astype(f32), log_w=np.zeros(P, f32),
        lm_mean=(5.0 * rng.normal(size=(P, L, 2))).astype(f32),
        lm_cov=np.broadcast_to(0.1 * np.eye(2, dtype=f32), (P, L, 2, 2)).copy(),
        lm_sig=np.zeros((P, L, 0), f32), lm_valid=np.ones((P, L), bool),
        lm_count=np.ones((P, L), np.int32), z=rng.uniform(1.0, 5.0, (Z, 2)).astype(f32),
        sig=np.zeros((Z, 0), f32), valid=np.ones(Z, bool),
    ), device)
    keys = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_valid", "lm_count")
    saved = [T[k] for k in keys]
    work = [t.clone() for t in saved]
    kw = dict(sig_dim=0, r_var=(0.01, 0.001), sig_var=1.0, log_p0=-8.0, init_infl=1.0,
              max_range=50.0, fov_half=3.2, cull=True)
    ms = time_call(lambda: ekf_update.measurement_update_2d(
        *work, T["z"], T["sig"], T["valid"], **kw), device, reps, _restorer(work, saved))
    return ms, P * L * 4 * 7 * 2, Z * P * L * 60


def _ekf3d_kwargs(model):
    Dz = 3 if model == "stereo_3d" else 2
    return dict(model=model, desc_words=8, par=camera_par(model),
                r_var=(4.0, 4.0, 2.25)[:Dz], desc_weight=0.1, log_p0=-30.0, init_infl=1.0,
                init_range_prior=5.0, init_range_sigma=2.5, max_range=60.0, cull=True)


def bench_ekf3d(device, P=1024, L=8192, Z=32, model="equirect_3d", reps=5):
    """The fused 3-D update at panoramic-config scale, every lane valid."""
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d

    T = _tensors(bench_frame_3d(P, L, Z, model), device)
    saved = [T[k] for k in STATE_KEYS]
    work = [t.clone() for t in saved]
    ms = time_call(lambda: ekf_update_3d.measurement_update_3d(
        *work, T["z"], T["desc"], T["valid"], **_ekf3d_kwargs(model)),
        device, reps, _restorer(work, saved))
    return ms, P * L * 4 * (11 + 8) * 2, Z * P * L * 200


def bench_fs_step(device, P=1024, L=8192, Z=32, algorithm="fastslam1", reps=5):
    """One whole filter step (proposal, measurement update, resample) at
    panoramic scale on a dense pre-seeded map, equirect_3d."""
    from parakeet_slam_tpu_torch.core.config import FilterConfig, FrontendConfig
    from parakeet_slam_tpu_torch.core.state import Observation, state_from_numpy
    from parakeet_slam_tpu_torch.filter import make_filter

    cfg = FilterConfig(
        num_particles=P, max_landmarks=L, max_observations=Z, lm_dim=3, obs_dim=2,
        pose_dim=7, sig_dim=0, desc_words=8, measurement_model="equirect_3d",
        motion_model="se3_odometry", motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0),
        init_range_prior=14.0, init_range_sigma=8.0, new_landmark_loglik=-14.0,
        max_range=60.0, algorithm=algorithm,
    )
    slam = make_filter(cfg, FrontendConfig(camera="equirect", image_size=(1024, 2048)))
    fr = bench_frame_3d(P, L, Z, "equirect_3d")
    fields = {k: fr[k] for k in STATE_KEYS}
    fields["pose"] = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (P, 1))
    fields["lm_sig"] = np.zeros((P, L, 0), np.float32)
    saved = state_from_numpy(SimpleNamespace(**fields), device=device)
    st = saved.clone()
    T = _tensors({k: fr[k] for k in ("z", "desc", "valid")}, device)
    obs = Observation(z=T["z"], sig=torch.zeros(Z, 0, device=device), desc=T["desc"],
                      valid=T["valid"])
    u = torch.zeros(6, device=device)
    u[0] = 0.05
    gen = torch.Generator(device=device).manual_seed(7)
    noise = torch.randn(P, slam.noise_dim, generator=gen, device=device)
    u0 = torch.rand((), generator=gen, device=device) / P

    def restore():
        for k in STATE_KEYS + ("lm_sig",):
            getattr(st, k).copy_(getattr(saved, k))

    ms = time_call(lambda: slam.step(st, u, obs, noise, u0), device, reps, restore)
    n_sweeps = 2 if algorithm == "fastslam2" else 1
    return ms, P * L * 4 * (11 + 8) * 2 * n_sweeps, Z * P * L * 200 * n_sweeps


def bench_resample(device, P=2048, L=10240, reps=5):
    """The resampling gather of a full map footprint (7 floats per lane)."""
    from parakeet_slam_tpu_torch.core.state import ParticleState
    from parakeet_slam_tpu_torch.kernels import resample_cuda

    g = torch.Generator(device=device).manual_seed(0)
    z = lambda *s, **kw: torch.zeros(*s, device=device, **kw)  # noqa: E731
    st = ParticleState(
        pose=z(P, 0), log_w=z(P), lm_mean=torch.randn(P, L, 7, generator=g, device=device),
        lm_cov=z(P, 0, 0, 0), lm_sig=z(P, 0, 0), lm_desc=z(P, 0, 0, dtype=torch.int32),
        lm_valid=z(P, 0, dtype=torch.bool), lm_count=z(P, 0, dtype=torch.int32),
    )
    idx = torch.randint(0, P, (P,), generator=g, device=device)
    ms = time_call(lambda: resample_cuda.gather_state(st, idx), device, reps)
    return ms, P * L * 7 * 4 * 2, 0


def bench_match(device, N=1024, M=131072, W=8, reps=10):
    """Hamming top-2 of N packed 256-bit queries over an all-valid database
    of M rows. Bytes: the packed database and queries read once, three
    int32 results written; operations by the reference's accounting (its
    bit-dot runs 2 * 32W per pair)."""
    from parakeet_slam_tpu_torch.kernels import match

    rng = np.random.default_rng(0)
    qd = torch.as_tensor(rng.integers(-2**31, 2**31, (N, W), dtype=np.int64).astype(np.int32),
                         device=device)
    db = torch.as_tensor(rng.integers(-2**31, 2**31, (M, W), dtype=np.int64).astype(np.int32),
                         device=device)
    valid = torch.ones(M, dtype=torch.bool, device=device)
    ms = time_call(lambda: match.hamming_top2(qd, db, valid), device, reps)
    return ms, (M + N) * W * 4 + M + 3 * N * 4, N * M * 2 * W * 32


def bench_schur(device, N=262144, reps=10):
    """The landmark-block inverse-apply y = C^-1 u on N blocks. Bytes: C and
    u read once as they lie (36 + 12 bytes a block), y written once; 60
    float operations a block by the reference bench's accounting (the
    cofactor form itself is 46)."""
    from parakeet_slam_tpu_torch.kernels import schur

    C, u = (torch.as_tensor(a, device=device) for a in schur_blocks(N))
    ms = time_call(lambda: schur.cinv_apply(C, u), device, reps)
    return ms, N * (9 + 3 + 3) * 4, N * 60


def bench_ba(device, C=64, Pts=50000, obs_per_cam=2000, iters=4, pcg_iters=25, reps=3):
    """Whole Schur/PCG bundle-adjustment iterations at EuRoC-config scale: C
    cameras, Pts landmarks, C * obs_per_cam residuals. The problem is packed
    once outside the timed call; ms is per LM iteration of the captured
    solve (the reference's jitted program: on the card one CUDA graph an
    iteration, captured in the warm-up call), `ms_eager` the same of the
    eager twin; bytes and operations by the reference's accounting."""
    from parakeet_slam_tpu_torch.backend import ba, graph
    from parakeet_slam_tpu_torch.frontend.camera import Pinhole

    prob = graph.make_ba_problem(**ba_bench_problem(C, Pts, obs_per_cam), device=device)
    bk = graph.pack_buckets(prob)
    cam = Pinhole(*BA_BENCH_CAMERA)
    ms = {mode: time_call(lambda: ba.optimize_ba(cam, bk, iters=iters, pcg_iters=pcg_iters,
                                                 huber_delta=50.0, capture=mode), device, reps)
          for mode in (True, False)}
    O = C * obs_per_cam
    return (ms[True] / iters, (1 + pcg_iters) * O * (2 + 12 + 6) * 4,
            O * (500 + pcg_iters * 120), {"ms_eager": round(ms[False] / iters, 3)})


BENCHES = {
    "ekf_update": bench_ekf,
    "ekf_update_3d": bench_ekf3d,
    "resample": bench_resample,
    "fs1_step": lambda device, **kw: bench_fs_step(device, algorithm="fastslam1", **kw),
    "fs2_step": lambda device, **kw: bench_fs_step(device, algorithm="fastslam2", **kw),
    "match": bench_match,
    "schur": bench_schur,
    "ba_iteration": bench_ba,
}


_SHAPE_KEYS = {"match": ("N", "M"), "schur": ("N",), "ba_iteration": ("C", "Pts", "obs_per_cam")}


def run(names, device, shape=None) -> list[dict]:
    """Print and return one JSON row per bench. `shape` overrides the
    (P, L, Z) of the benches that take them (resample takes P and L, match
    N and M, schur N, ba_iteration C, Pts and obs_per_cam)."""
    peak = _peak(device)
    rows = []
    for name in names:
        kw = {}
        if shape:
            kw = dict(zip(_SHAPE_KEYS.get(name, ("P", "L", "Z")), shape))
            if name == "resample":
                kw.pop("Z", None)
        # a bench may add fields of its own to its row
        ms, bytes_moved, flops, *more = BENCHES[name](device, **kw)
        gbs = bytes_moved / ms / 1e6
        row = {
            "kernel": name, "ms": round(ms, 3), "GB/s": round(gbs, 1),
            "sol_bw_frac": round(gbs / peak[0], 3) if peak else None,
            "TFLOP/s": round(flops / ms / 1e9, 2),
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            **(more[0] if more else {}),
        }
        print(json.dumps(row))
        rows.append(row)
    return rows
