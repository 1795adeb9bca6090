#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`parakeet_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. Phases:
  1. environment: torch/CUDA versions, card name and power limit, TF32 flags;
  2. build the hand-written kernels from `parakeet_slam_tpu_torch/csrc` (five
     sources);
  2b. the 2-D update kernel's bearing wrap against the twin's
     torch.atan2(torch.sin(a), torch.cos(a)), bit for bit, over all 2^32
     float32 values;
  3. each kernel against its plain PyTorch twin on the card, at the corridor
     shape (P=64, L=192, Z=16, S=3) and the real-size shape (P=2048,
     L=10240, Z=32, S=3): masks, counts, target lanes and n_match equal,
     floats within rtol=atol=1e-5 (log_w atol=1e-4), the gather bit-exact
     on the resample indices and on a permutation; median times of kernel
     as the device's time alone (runs queued behind a sleep kernel, the
     update's state restored outside each call's events), in turns with the
     twin's (around single calls: a twin's thousands of launches overflow
     the launch queue behind a sleep), and around single calls; then the
     update kernel's other options (S=0, cull_unseen, no cull, no weight
     update, full and empty maps, L=130, Z=64) at small shapes, and the
     gather on descriptor rows of W=8 words and on one row repeated P times;
  4. the main path, config 1 (configs/corridor.yaml) for 500 frames and
     filter seeds 0-4: every frame through the update kernel, every resample
     through the gather kernel, each ATE < 0.5 m, the 5-seed mean in the JAX
     reference band [0.136, 0.264] m;
  5. the main path at the real-size shape for 30 frames: finite, both
     kernels launched, frames/s and peak device memory;
  6. the two 3-D kernels (measurement_update_3d, score_3d) against their
     twins: each model at the bench shape (P=1024, L=8192, Z=32), stereo at
     the KITTI shape (P=2048, L=10240, Z=128) and equirect at the panoramic
     config's shape (P=1024, L=8192, Z=128), the update scoring the frame
     itself; the update fed score_3d's scores, as FastSLAM 2.0 runs it, at
     the KITTI shape and config 2's (pinhole, P=512, L=1024, Z=64); then
     the options (external scores, no weight update, freeze, cull_unseen,
     no cull, full and empty maps, L=1100, Z=128 past the 64-slot cap,
     L=2^18) at small shapes. Masks, counts, target lanes, n_match,
     descriptors and score lanes equal; scores, means and covariances within
     rtol=atol=1e-5, log_w within atol=2e-3 + rtol=1e-6 (sums over up to
     128 observations in another order); the update fed score_3d's scores
     equal to the update that scores itself (so score_3d's scores equal the
     update's own pass bit for bit); each kernel timed as the device's time
     alone, in turns with its twin (around single calls), and around single
     calls; the update fed scores against the bound of what that mode reads
     and writes;
  7. the vision path at full width, benchmark config 3 (configs/kitti_00.yaml:
     FastSLAM 2.0, stereo_3d, P=2048, L=10240, Z=128) for 30 frames of the
     synthetic drive world: one score_3d and one measurement_update_3d
     launch per frame, one gather per resample, a finite trajectory,
     frames/s, peak device memory, ATE against ground truth and dead
     reckoning (printed, not gated); the kernel path and the twin path
     give equal masks and counts over the first 3 frames from the same
     draws;
  8. the ekf_update_3d, fs1_step and fs2_step rows of the kernel bench;
  9. the two matcher kernels (hamming_top2, l2_top2) against their twins:
     Hamming at the bench shape (N=1024, M=131072, W=8; all valid, and 1 in
     5 invalid), both batched directions of the loop-closure match (F=256
     against K=64 and 128 stored keyframes; F=512 against the panoramic
     config's store of 2048 with the first 1025 eligible), and the edge
     cases (all-invalid database, one valid row, exact duplicates, M not a
     tile multiple, N=1, N>M, five whole tiles invalid), idx/best/second
     bit-equal; Hamming timed as the device's time alone in turns with its
     twin at the bench shape and both directions of config 2's and the
     panoramic closure shape; L2 at N=1024, M=131072, D=128 and
     seven edge cases (all invalid, one valid row, D=33 with M=999, D=7 with
     N>M, exact duplicates with idx equal in every row and second == best,
     M=131073, best and second within the gap), best and second within
     atol=1e-3 + rtol=1e-5, idx equal wherever the twin's second - best
     exceeds 1e-2; median times of kernel and twin (L2's as the device's
     time alone, in turns, and around single calls); then the match_l2 front
     door (its one l2_top2 launch);
  10. the online monocular system at full width, benchmark config 2
     (configs/tum_fr1_desk.yaml: FastSLAM 2.0, pinhole_3d, P=512, L=1024,
     Z=64, 256 FAST + BRIEF features, 640x480), `cli run`'s TUM loop over
     120 frames of the in-memory desk world (two orbits, the second revisits
     the first): a finite trajectory, >= 2 keyframes, hamming_top2 launched
     twice per closure dispatch (forward and reverse) and at least once,
     one score_3d and one measurement_update_3d launch per frame, one gather
     per resample; frames/s (from frame 3), keyframes, dispatches, accepted
     closures, peak device memory, and the corrected, online and
     dead-reckoning ATE (Sim(3), not gated); then the same run again from
     the same seed: keyframe count, resample count, estimates and pose-graph
     poses equal bit for bit;
  11. every keyframe-store match of phase 10, replayed through the twin:
     forward and reverse tables equal;
  12. the landmark-block inverse-apply kernel (apply_cinv) against its twin:
     the bench shape N=262144, a bucket-sized N=46080, N=1, N=1000, a
     non-contiguous C with a broadcast u, and blocks with |det| < eps, a
     negative det and a 1e12 damping diagonal; within rtol=1e-6 (bit-equal
     is expected and reported); times of kernel, twin and
     `torch.linalg.solve_ex` (the solve without its host-side error check)
     with the launches queued behind a sleep kernel and the operands rotated
     past the L2 cache;
  13. bundle adjustment at full width: the bench's problem (64 cameras,
     50,000 points, 128,000 observations) solved by `ba.optimize_ba` with
     the backend settings of configs/euroc_mh.yaml (20 LM iterations, 100
     PCG iterations, bucketed, pcg): finite costs, the final cost below the
     initial one, apply_cinv launched gn_iters x buckets x (pcg_iters + 3)
     times, seconds per LM iteration, peak device memory; the first 2
     iterations again through the twin (costs within rtol=1e-5); a profile
     of 2 iterations (launches, device busy time, idle share); the schur
     and ba_iteration rows of the kernel bench;
  14. `run_ba(iters=20)` on phase 10's system (40 keyframes, the pose
     graph's edges fused; LM rejects about its first ten iterations from
     the config's damping of 1e-4, as the reference does): hamming_top2
     launched once per keyframe by the point dedup, and the dedup run again
     through the twin on the same snapshots gives equal point ids, store,
     count and dropped count; apply_cinv launched, finite keyframe poses,
     final cost <= first cost; points, observations, dropped points,
     seconds, and the corrected ATE before and after (printed, not gated).
Every kernel's record carries its bound: the larger of the bytes it must
move (inputs read once, outputs written once) over 3.35 TB/s and its
operations over the card's peak for their type (67 TFLOP/s float32, 1,979
TOP/s int8, 495 TFLOP/s TF32 at three products per multiply-add for l2_top2,
whose record keeps the float32 figure as bound_ms_fp32), counted from the
inputs of this run and from the arithmetic of the plain twins (OPS_2D,
OPS_3D, CINV_OPS).
Exits non-zero at the first failed check, and without a result when there
is no CUDA device or no package beside the script. The last line is
{"ok": true, "device": {...}}, the line before it the kernels' JSON record
(the seven kernels: ekf_update_2d, gather_rows, measurement_update_3d,
score_3d, hamming_top2, l2_top2, apply_cinv) and the line before that the
card's name and power limit.
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


# Published peaks of one H100 SXM at its full power limit: device memory
# bytes/s, float32 operations/s outside the tensor cores, int8 tensor-core
# operations/s, TF32 tensor-core operations/s.
PEAK_BYTES, PEAK_F32, PEAK_INT8, PEAK_TF32 = 3.35e12, 67e12, 1979e12, 495e12


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops, peak_ops=PEAK_F32):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move n_bytes and do ops operations, and which of the two binds."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Operations of the update functions, counted from the arithmetic of their
# plain twins (which the kernels follow operation for operation). One
# operation is one add, subtract, multiply, divide, negate, compare, select,
# xor, popcount, or one sqrt/log/trig call; work that a function needs once
# per lane is counted once per lane, however often a kernel redoes it.
#   pair:   one observation scored against one valid lane: residual,
#           Mahalanobis form, log-likelihood, finite test and running argmax,
#           without the signature or descriptor term (`appearance_ops`);
#   lane:   a valid lane's scoring geometry (projection, Jacobian, innovation
#           covariance, its inverse and log-determinant);
#   update: the EKF update of one matched lane; init: one new landmark;
#   cull:   the field-of-view test and count of one valid, unmatched lane;
#   obs:    the association decision and weight term of one valid observation.
OPS_2D = {"pair": 22, "lane": 57, "update": 131, "init": 55, "cull": 18, "obs": 12}
OPS_3D = {
    "pinhole_3d": {"pair": 19, "lane": 118, "update": 279, "init": 102, "cull": 38, "obs": 12},
    "stereo_3d": {"pair": 31, "lane": 201, "update": 429, "init": 216, "cull": 38, "obs": 12},
    "equirect_3d": {"pair": 23, "lane": 149, "update": 314, "init": 102, "cull": 27, "obs": 12},
}


def appearance_ops(width):
    """Operations per pair of the appearance term: `width` signature
    differences squared and summed, or `width` descriptor words xor-ed,
    popcounted and summed; then the scaling and the subtraction."""
    return 3 * width + 3 if width else 0


def update_ops(counts, width, lm_valid, target, n_obs, n_valid_obs):
    """(operations of the score pass, operations of the whole frame update,
    operations of the update fed scores) for this frame: `lm_valid` [P, L]
    before the frame, `target` [P, Z] the lanes the twin wrote, `n_obs`
    observations scored against every valid lane by the score function and
    `n_valid_obs` of them by the update. Fed scores, the update does no pair
    and no lane geometry: association, apply and cull."""
    import torch

    lanes = int(lm_valid.sum())
    pair = counts["pair"] + appearance_ops(width)
    hit = target >= 0
    updated = torch.gather(lm_valid.bool(), 1, target.clamp(min=0).long()) & hit
    n_update = int(updated.sum())
    n_init = int(hit.sum()) - n_update
    sweep = counts["lane"] * lanes
    rest = (counts["obs"] * n_valid_obs * lm_valid.shape[0] + counts["update"] * n_update
            + counts["init"] * n_init + counts["cull"] * (lanes - n_update))
    return pair * n_obs * lanes + sweep, pair * n_valid_obs * lanes + sweep + rest, rest


def ext_update_bytes(valid0, count0, valid1, count1, target, kw, *frame):
    """Bytes the update fed scores must move, worked out from the state
    before the frame (`valid0`, `count0` [P, L]) and the twin's result
    (`valid1`, `count1`, `target` [P, Z]): each particle's flags up to its
    high-watermark read, and written where they change; the counts of the
    valid lanes read (the cull's test; an updated lane's too), and written
    where they change; the mean of every valid lane the frame leaves
    unmatched read for the field-of-view test (unless `cull_unseen`); an
    updated lane's mean and covariance read and written, an allocated
    lane's written, the descriptor of both written; `frame` (observations,
    descriptors, their flags, ext_ll, ext_ix, n_match, target) once, and
    log_w read and written when the weights update."""
    import torch

    P, L = valid0.shape
    valid0 = valid0.bool()
    lanes = torch.arange(1, L + 1, device=valid0.device)
    hwm = int(torch.where(valid0, lanes, 0).max(dim=1).values.sum())
    matched = torch.zeros_like(valid0)
    hit = target >= 0
    rows = torch.arange(P, device=target.device)[:, None].expand_as(target)
    matched[rows[hit], target[hit].long()] = True
    n_upd, n_alloc = int((matched & valid0).sum()), int((matched & ~valid0).sum())
    cull = kw.get("cull", True)
    n_count_read = int(valid0.sum()) if cull else n_upd
    n_mean_read = int((valid0 & ~matched).sum()) if cull and not kw.get("cull_unseen") else 0
    geometry, desc = (3 + 9) * 4, kw["desc_words"] * 4
    return (hwm + int((valid0 != valid1.bool()).sum()) + 4 * n_count_read
            + 4 * int((count0 != count1).sum()) + 12 * n_mean_read
            + n_upd * (2 * geometry + desc) + n_alloc * (geometry + desc) + nbytes(*frame)
            + (2 * 4 * P if kw.get("update_weights", True) else 0))


def queued_ms(call, reps=20, batches=5, prepare=None):
    """Median milliseconds per call of `call(i)` on the device alone: runs of
    `reps` back-to-back calls queued behind a sleep kernel (see
    `eval.profiling.queued`; `prepare(i)` restores an in-place kernel's
    inputs outside the call's own events). `call` must not wait for the
    device."""
    from parakeet_slam_tpu_torch.eval.profiling import queued

    return queued(call, reps=reps, batches=batches, prepare=prepare)


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


def phase_wrap(device):
    """The 2-D update kernel's bearing wrap (its own device function, which
    takes sin and cos from one sincosf for |a| <= 8) against the twin's
    torch.atan2(torch.sin(a), torch.cos(a)) on the card, bit for bit, over
    every float32 bit pattern: |a| <= 8, the rest, +-inf and the NaNs (a NaN
    equals a NaN)."""
    import torch

    from parakeet_slam_tpu_torch.kernels import ekf_update

    chunk = 1 << 28
    n_bad = n_bad_small = 0
    first = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(-2**31, 2**31, chunk):
        a = torch.arange(start, start + chunk, dtype=torch.int64, device=device).to(torch.int32)
        a = a.view(torch.float32)
        got = ekf_update.wrap_angle(a)
        want = torch.atan2(torch.sin(a), torch.cos(a))
        bad = (got.view(torch.int32) != want.view(torch.int32)) & ~(got.isnan() & want.isnan())
        n = int(bad.sum())
        n_bad += n
        n_bad_small += int((bad & (a.abs() <= 8.0)).sum())
        if n and first is None:
            first = float(a[bad][0])
    dt = time.perf_counter() - t0
    print(f"wrap: the kernels' atan2(sin a, cos a) against torch's over all 2^32 float32 values "
          f"(+-inf and NaN included) in {dt:.2f} s: {n_bad} differ ({n_bad_small} with |a| <= 8)"
          + (f", the first at a={first!r}" if first is not None else ""))
    check(n_bad == 0, f"the kernels' wrap differs from the twin's in {n_bad} values")


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
        return err, None, None, None, None
    # bound: the state and the frame read once, the results written once; the
    # operations this frame needs (OPS_2D: 34 per pair of a valid observation
    # and a valid lane at S=3, 57 per lane, the updates, inits and the cull)
    n_valid_obs = int(T["valid"].sum())
    _, ops, _ = update_ops(OPS_2D, S, T["lm_valid"], ref[7], n_valid_obs, n_valid_obs)
    bnd = bound(nbytes(*state, *obs) + nbytes(*got), ops)

    def reset(i=0):
        for w, s in zip(work, state):
            w.copy_(s)

    # the kernel's time on the device alone (the state restored before each
    # call, outside its events) in turns with the twin's; the twin's ~5,000
    # launches a call overflow the launch queue behind a sleep, so it is
    # timed around single calls (host-bound). Then the kernel around single
    # calls, with the host's work before its launch.
    reps = 20 if P < 1024 else 10
    kernel = lambda i=0: ekf_update.measurement_update_2d(*work, *obs, **kw)  # noqa: E731
    twin = lambda i=0: ekf_update.measurement_update_2d_reference(*state, *obs, **kw)  # noqa: E731
    turns = [queued_ms(kernel, reps=reps, prepare=reset), cuda_ms(twin, 3),
             queued_ms(kernel, reps=reps, prepare=reset), cuda_ms(twin, 3)]
    ms, plain = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
    single = cuda_ms(kernel, reps, reset)
    print(f"ekf_update_2d P={P} L={L} Z={Z} S={S}: targets={n_upd} collisions={n_coll} "
          f"max_abs_err={err:.3g} kernel={turns[0]:.4f}; {turns[2]:.4f} ms twin={turns[1]:.4f}; "
          f"{turns[3]:.4f} ms (device time, in turns); single calls with their host time: "
          f"kernel={single:.4f} ms; bound={bnd[0]:.4f} ms ({bnd[1]})")
    return err, ms, plain, bnd, single


def _gather_state(shape, device, desc_words=0):
    """A 2-D state at `shape` from the kernel inputs; with `desc_words`,
    random descriptors of that many words per lane beside it."""
    import torch

    from parakeet_slam_tpu_torch.core.state import ParticleState

    P, L, _, _ = shape
    T = _update_inputs(shape, seed=sum(shape) + 1, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    desc = torch.randint(-2**31, 2**31, (P, L, desc_words), generator=g, device=device,
                         dtype=torch.int64).to(torch.int32)
    return ParticleState(**{k: T[k] for k in STATE_KEYS}, lm_desc=desc)


def check_gather_equal(what, st, idx):
    """gather_state against its twin on `idx`: every leaf bit-equal."""
    import torch

    from parakeet_slam_tpu_torch.kernels import resample_cuda

    got = resample_cuda.gather_state(st, idx)
    ref = resample_cuda.gather_state_reference(st, idx)
    torch.cuda.synchronize()
    err = 0.0
    for k in STATE_KEYS + ("lm_desc",):
        a, b = getattr(got, k), getattr(ref, k)
        check(torch.equal(a, b), f"gather_rows {what}: {k} differs")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def check_gather_kernel(shape, device):
    """The gather against `index_select` per leaf (its twin, and the library
    call for this function) on the resample indices and on a permutation,
    then kernel, twin, kernel, twin timed in turns. Returns (max |diff|,
    kernel ms, twin ms, bound, single-call kernel ms, single-call twin ms)
    on the permutation: the first two times are the device's alone (runs of
    calls queued behind a sleep kernel), the last two bracket single calls
    and hold the host's work before the first launch, as the records of the
    earlier kernel did."""
    import torch

    from parakeet_slam_tpu_torch.kernels import resample, resample_cuda

    P, L, Z, S = shape
    st = _gather_state(shape, device)
    g = torch.Generator(device=device).manual_seed(0)
    log_w = 3.0 * torch.randn(P, generator=g, device=device)
    idx = resample.systematic_resample_indices(log_w, 0.37 / P)
    # Resampling indices repeat rows, and a repeated row is read from L2; a
    # permutation reads every row once, the full traffic. The record keeps
    # the permutation's times.
    perm = torch.randperm(P, generator=g, device=device)
    err = max(check_gather_equal(f"{shape} resample idx", st, idx),
              check_gather_equal(f"{shape} permutation", st, perm))
    n_bytes = sum(t.numel() * t.element_size() for t in st.__dict__.values() if t is not st.log_w)
    for name, ix in (("resample idx", idx), ("permutation", perm)):
        kernel = lambda i=0: resample_cuda.gather_state(st, ix)  # noqa: E731
        twin = lambda i=0: resample_cuda.gather_state_reference(st, ix)  # noqa: E731
        turns = [queued_ms(f, reps=10) for f in (kernel, twin, kernel, twin)]
        ms, plain = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
        single, single_plain = cuda_ms(kernel, 20), cuda_ms(twin, 20)
        print(f"gather_rows P={P} L={L} S={S} {name} ({len(set(ix.tolist()))} distinct rows): "
              f"{n_bytes / 1e9:.4f} GB per copy, kernel={turns[0]:.4f}; {turns[2]:.4f} ms "
              f"({2 * n_bytes / ms / 1e9:.3f} TB/s) twin={turns[1]:.4f}; {turns[3]:.4f} ms "
              f"(device time, in turns); single calls with their host time: "
              f"kernel={single:.4f} ms twin={single_plain:.4f} ms")
    # bound: every leaf read once and written once, plus the indices
    return err, ms, plain, bound(2 * n_bytes + nbytes(idx), 0), single, single_plain


def check_gather_variants(device):
    """Shapes of the gather that the 2-D paths do not give it: descriptor
    rows of a 3-D state (W=8 words: 320 KB a row at L=10240), and one row
    repeated P times."""
    import torch

    shape = (256, 10240, 8, 3)
    st = _gather_state(shape, device, desc_words=8)
    g = torch.Generator(device=device).manual_seed(2)
    err = check_gather_equal("W=8 permutation", st, torch.randperm(shape[0], generator=g,
                                                                   device=device))
    row = st.lm_desc[0].numel() * st.lm_desc.element_size()
    print(f"gather_rows P={shape[0]} L={shape[1]} W=8 (descriptor rows of {row} bytes): bit-equal")
    st = _gather_state(CORRIDOR_SHAPE, device)
    for what, s_ in (("corridor", st), ("real size", _gather_state(REAL_SHAPE, device))):
        P = s_.num_particles
        idx = torch.full((P,), P // 3, dtype=torch.int64, device=device)
        err = max(err, check_gather_equal(f"{what} one row repeated", s_, idx))
        print(f"gather_rows {what}: row {P // 3} repeated {P} times: bit-equal")
    return err


def phase_kernels(device):
    res = {}
    for shape in (CORRIDOR_SHAPE, REAL_SHAPE):
        res[("ekf", shape)] = check_update_kernel(shape, device)
        res[("gather", shape)] = check_gather_kernel(shape, device)
    err = max(res[("ekf", s)][0] for s in (CORRIDOR_SHAPE, REAL_SHAPE))
    for shape, fill, flags in UPDATE_VARIANTS:
        err = max(err, check_update_kernel(shape, device, fill, timed=False, **flags)[0])
    res["gather_variants"] = check_gather_variants(device)
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

STATE_3D = ("pose", "log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid", "lm_count")
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
    ("pinhole_3d", (4, 1 << 18, 16), "holes", {}),  # the largest L: a 32 KB lane bitmap
)


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

    from parakeet_slam_tpu_torch.eval import kernel_inputs as KI
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d as E

    T = _frame_3d(model, shape, fill, device)
    kw = KI.update_3d_kwargs(model, **flags)
    state = [T[k] for k in STATE_3D]
    obs = [T["z"], T["desc"], T["valid"]]
    score_args = (T["pose"], T["lm_mean"], T["lm_cov"], T["lm_desc"], T["lm_valid"],
                  T["z"], T["desc"])
    sk = {k: kw[k] for k in KI.SCORE_3D_KEYS}
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

    def reset(i=0):
        for w, s in zip(work, state):
            w.copy_(s)

    # bounds: operands read once, results written once; the operations this
    # frame needs (OPS_3D: 58 per pair for stereo with 8 descriptor words, 46
    # pinhole, 50 equirect, plus the per-lane geometry). score_3d scores all Z
    # observations, the update the valid ones and then applies and culls.
    # Fed scores, the update reads only what its association, apply and cull
    # need (`ext_update_bytes`) and does their operations alone.
    score_ops, update_ops_, ext_ops = update_ops(OPS_3D[model], kw["desc_words"], T["lm_valid"],
                                                 ref[7], shape[2], int(T["valid"].sum()))
    # the update on the device alone (its state restored outside each call's
    # events), in turns with its twin (around single calls: the twin's
    # launches overflow the queue behind a sleep)
    update = lambda i=0: E.measurement_update_3d(*work, *obs, *extra, **kw)  # noqa: E731
    update_twin = lambda i=0: E.measurement_update_3d_reference(  # noqa: E731
        *state, *obs, *((r_ll, r_ix) if ext else ()), **kw)
    u_turns = [queued_ms(update, reps=reps_k, prepare=reset), cuda_ms(update_twin, reps_t),
               queued_ms(update, reps=reps_k, prepare=reset), cuda_ms(update_twin, reps_t)]
    t = {
        "update": (u_turns[0] + u_turns[2]) / 2,
        "update_twin": (u_turns[1] + u_turns[3]) / 2,
        "update_single": cuda_ms(update, reps_k, reset),
    }
    if ext:
        t["update_bound"] = bound(ext_update_bytes(
            T["lm_valid"], T["lm_count"], ref[4], ref[5], ref[7], kw, *obs, ll, ix, got[6],
            got[7]), ext_ops)
        print(f"ekf_update_3d {what}: targets={n_upd} max_abs_err={err:.3g} "
              f"update fed scores kernel={u_turns[0]:.4f}; {u_turns[2]:.4f} ms "
              f"twin={u_turns[1]:.4f}; {u_turns[3]:.4f} ms (device time, in turns), single "
              f"calls kernel={t['update_single']:.4f} ms | bound "
              f"{t['update_bound'][0]:.4f} ms ({t['update_bound'][1]})")
        return err, t
    t["update_bound"] = bound(nbytes(*state, *obs) + nbytes(*got), update_ops_)
    t["score_bound"] = bound(nbytes(*score_args) + nbytes(ll, ix), score_ops)
    # score_3d on the device alone, in turns with its twin
    score = lambda i=0: E.score_3d(*score_args, **sk)  # noqa: E731
    score_twin = lambda i=0: E.score_3d_reference(*score_args, **sk)  # noqa: E731
    turns = [queued_ms(score, reps=reps_k), cuda_ms(score_twin, reps_t),
             queued_ms(score, reps=reps_k), cuda_ms(score_twin, reps_t)]
    t.update(score=(turns[0] + turns[2]) / 2, score_twin=(turns[1] + turns[3]) / 2,
             score_single=cuda_ms(score, reps_k))
    print(f"ekf_update_3d {what}: targets={n_upd} max_abs_err={err:.3g} "
          f"update kernel={u_turns[0]:.4f}; {u_turns[2]:.4f} ms twin={u_turns[1]:.4f}; "
          f"{u_turns[3]:.4f} ms (device time, in turns), single calls kernel="
          f"{t['update_single']:.4f} ms | score_3d kernel={turns[0]:.4f}; {turns[2]:.4f} ms "
          f"twin={turns[1]:.4f}; {turns[3]:.4f} ms (device time, in turns), single calls "
          f"kernel={t['score_single']:.4f} ms | bounds "
          f"update={t['update_bound'][0]:.4f} ms ({t['update_bound'][1]}) "
          f"score={t['score_bound'][0]:.4f} ms ({t['score_bound'][1]})")
    return err, t


def phase_kernels_3d(device):
    from parakeet_slam_tpu_torch.eval import kernel_inputs as KI

    res = {}
    for model in ("pinhole_3d", "stereo_3d", "equirect_3d"):
        res[model] = check_update_3d(model, KI.BENCH_3D, device)
    # KITTI and the panoramic config scoring the frame itself; KITTI and
    # config 2 fed score_3d's scores, as FastSLAM 2.0 (configs 2, 3, 4) runs it
    for what, model, shape, ext in KI.UPDATE_3D_CASES:
        if what != "bench":  # timed above for every model
            res[what + ("_ext" if ext else "")] = check_update_3d(model, shape, device, ext=ext)
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


# --------------------------------------------------------------------------
# Slice 3: descriptor matching and the online monocular system
# --------------------------------------------------------------------------

L2_BENCH = (1024, 131072, 128)
DESK_FRAMES = 120  # two orbits of 60 frames: the second revisits the first
# L2: float sums in another order than the twin's matmul. best/second within
# atol=L2_ATOL + rtol=L2_RTOL; idx equal wherever the twin's second - best
# exceeds L2_GAP (closer pairs may swap under a rounding difference).
L2_ATOL, L2_RTOL, L2_GAP = 1e-3, 1e-5, 1e-2


def check_hamming(what, qd, db, valid, timed=False):
    """hamming_top2 against its twin: idx, best and second bit-equal."""
    import torch

    from parakeet_slam_tpu_torch.kernels import match

    got = match.hamming_top2(qd, db, valid)
    ref = match.hamming_top2_reference(qd, db, valid)
    torch.cuda.synchronize()
    for name, g, r in zip(("idx", "best", "second"), got, ref):
        check(torch.equal(g, r.to(g.dtype)), f"hamming_top2 {what}: {name} differs in "
              f"{int((g != r).sum())} of {g.numel()}")
    n_tie = int((ref[1] == ref[2]).sum())
    if not timed:
        print(f"hamming_top2 {what}: bit-equal (ties {n_tie})")
        return None, None, None
    # the device's time alone, in turns with the twin (around single calls)
    kernel = lambda i=0: match.hamming_top2(qd, db, valid)  # noqa: E731
    twin = lambda i=0: match.hamming_top2_reference(qd, db, valid)  # noqa: E731
    turns = [queued_ms(kernel, reps=20), cuda_ms(twin, 3), queued_ms(kernel, reps=20),
             cuda_ms(twin, 3)]
    ms, plain = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
    # bound: operands read once, three results written; per pair of a query
    # and a valid row the reference's bit-dot count (2 operations a bit) at
    # the int8 tensor-core rate, the fastest unit that can do it
    pairs = qd.shape[-2] * int(valid.sum()) * (qd.shape[0] if qd.dim() == 3 and valid.dim() == 1
                                               else 1)
    bnd = bound(nbytes(qd, db, valid, *got), pairs * 2 * 32 * qd.shape[-1], PEAK_INT8)
    print(f"hamming_top2 {what}: bit-equal (ties {n_tie}) kernel={turns[0]:.4f}; "
          f"{turns[2]:.4f} ms twin={turns[1]:.4f}; {turns[3]:.4f} ms (device time, in turns) "
          f"bound={bnd[0]:.4f} ms ({bnd[1]})")
    return ms, plain, bnd


def check_l2(what, qd, db, valid, timed=False, exact_idx=False):
    """l2_top2 against its twin within the stated tolerances; with
    `exact_idx`, idx equal in every row whatever the gap. Returns (max |diff|
    of best/second, kernel ms, twin ms, bound, float32 bound ms, single-call
    kernel ms, single-call twin ms)."""
    import torch

    from parakeet_slam_tpu_torch.kernels import match

    gi, g1, g2 = match.l2_top2(qd, db, valid)
    ri, r1, r2 = match.l2_top2_reference(qd, db, valid)
    torch.cuda.synchronize()
    err = max(float((g1 - r1).abs().max()), float((g2 - r2).abs().max()))
    for name, g, r in (("best", g1, r1), ("second", g2, r2)):
        check(torch.allclose(g, r, rtol=L2_RTOL, atol=L2_ATOL),
              f"l2_top2 {what}: {name} max |diff| {err}")
    clear = torch.ones_like(gi, dtype=torch.bool) if exact_idx else (r2 - r1) > L2_GAP
    n_bad = int(((gi != ri) & clear).sum())
    check(n_bad == 0, f"l2_top2 {what}: idx differs in {n_bad} rows" +
          ("" if exact_idx else " with a clear gap"))
    n_swap = int((gi != ri).sum())
    n_close = int(((r2 - r1) <= L2_GAP).sum())
    if not timed:
        print(f"l2_top2 {what}: max_abs_err={err:.3g} idx equal where gap > {L2_GAP} "
              f"({n_close} rows within it, {n_swap} near-tie swaps)")
        return err, None, None, None, None, None, None
    kernel = lambda i=0: match.l2_top2(qd, db, valid)  # noqa: E731
    twin = lambda i=0: match.l2_top2_reference(qd, db, valid)  # noqa: E731
    # the device's time alone (runs of calls queued behind a sleep kernel), in
    # turns; then single calls with the host's work before the first launch,
    # as the records of the earlier kernel were taken
    turns = [queued_ms(f, reps=reps) for f, reps in ((kernel, 10), (twin, 5)) * 2]
    ms, plain = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
    single, single_plain = cuda_ms(kernel, 10), cuda_ms(twin, 5)
    # bound: operands read once, results written; a multiply and an add per
    # dimension and pair of a query and a valid row. One TF32 product would
    # move the argmins, so the fastest unit that can do it is the tensor
    # cores at three TF32 products per multiply-add (3xTF32); the float32
    # rate outside the tensor cores gives the bound of the earlier records.
    # The twin is the matmul form: the library yardstick.
    n_bytes = nbytes(qd, db, valid, gi, g1, g2)
    ops = 2 * qd.shape[0] * int(valid.sum()) * qd.shape[1]
    bnd, bnd_fp32 = bound(n_bytes, 3 * ops, PEAK_TF32), bound(n_bytes, ops)[0]
    print(f"l2_top2 {what}: max_abs_err={err:.3g} idx equal where gap > {L2_GAP} "
          f"({n_close} rows within it, {n_swap} near-tie swaps) kernel={turns[0]:.4f}; "
          f"{turns[2]:.4f} ms twin={turns[1]:.4f}; {turns[3]:.4f} ms (device time, in turns); "
          f"single calls with their host time: kernel={single:.4f} ms twin={single_plain:.4f} ms; "
          f"bound={bnd[0]:.4f} ms ({bnd[1]}, 3xTF32) float32 bound={bnd_fp32:.4f} ms")
    return err, ms, plain, bnd, bnd_fp32, single, single_plain


def phase_match(device):
    """Both matcher kernels against their twins, then the L2 front door."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.eval import kernel_inputs as KI
    from parakeet_slam_tpu_torch.kernels import match

    T = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    N, M = KI.HAMMING_BENCH
    qd, db, v5 = (T(a) for a in KI.hamming_bench())
    res = {"ham": check_hamming(f"N={N} M={M} all valid", qd, db,
                                torch.ones(M, dtype=torch.bool, device=device), timed=True)}
    check_hamming(f"N={N} M={M} 1 in 5 invalid", qd, db, v5)
    # the loop-closure shapes: one keyframe against the stacked store, both
    # ways: config 2's (F=256, a store of 64) and the panoramic config's
    # (F=512, a store of 2048 with the first 1025 keyframes eligible: the
    # forward match skips the ineligible half); untimed, config 2's store
    # grown to 128
    for what, F, cap, written, eligible in KI.CLOSURE_SHAPES + (("grown", 256, 128, 128, 121),):
        q, qv, store, sv = (T(a) for a in KI.closure_match(F, cap, written, eligible, seed=cap))
        timed = what != "grown"
        shape = f"F={F} K={cap} written={written} eligible={eligible}"
        fwd = check_hamming(f"{what} closure forward {shape}", q, store, sv, timed=timed)
        rev = check_hamming(f"{what} closure reverse {shape}", store, q, qv, timed=timed)
        if timed:
            res[f"closure_{what}"] = (fwd, rev)
        del store, sv
    rng = np.random.default_rng(9)
    # edge cases
    for what, n, m, vfn, pool in (
        ("all invalid", 50, 300, lambda m: np.zeros(m, bool), 0),
        ("one valid row", 50, 300, lambda m: np.arange(m) == 137, 0),
        ("exact duplicates", 300, 700, lambda m: np.ones(m, bool), 5),
        ("M=1000 not a tile multiple", 130, 1000, lambda m: rng.random(m) >= 0.5, 0),
        ("N=1", 1, 5000, lambda m: np.ones(m, bool), 0),
        ("N>M", 600, 37, lambda m: np.ones(m, bool), 20),
        ("rows 128-767 invalid: five whole tiles skipped", 200, 1000,
         lambda m: (np.arange(m) < 128) | (np.arange(m) >= 768), 10),
    ):
        check_hamming(what, T(KI.descriptors(rng, (n, 8), pool)),
                      T(KI.descriptors(rng, (m, 8), pool)), T(vfn(m)))
    # L2: the bench shape, then small edge cases
    N2, M2, D2 = L2_BENCH
    dbf = rng.normal(size=(M2, D2)).astype(np.float32)
    vf = rng.random(M2) >= 0.2
    # the first quarter of the queries are noisy copies of valid rows
    planted = rng.choice(np.flatnonzero(vf), N2 // 4, replace=False)
    qf = rng.normal(size=(N2, D2)).astype(np.float32)
    qf[: N2 // 4] = dbf[planted] + 0.05 * qf[: N2 // 4]
    qf, dbf, vf = T(qf), T(dbf), T(vf)
    res["l2"] = check_l2(f"N={N2} M={M2} D={D2} 1 in 5 invalid", qf, dbf, vf, timed=True)
    err = res["l2"][0]
    for what, n, m, d, vfn in (
        ("all invalid", 40, 300, 32, lambda m: np.zeros(m, bool)),
        ("one valid row", 40, 300, 32, lambda m: np.arange(m) == 11),
        ("N=1 D=33 M=999", 1, 999, 33, lambda m: np.ones(m, bool)),
        ("N>M D=7", 100, 9, 7, lambda m: np.ones(m, bool)),
    ):
        err = max(err, check_l2(what, T(rng.normal(size=(n, d)).astype(np.float32)),
                                T(rng.normal(size=(m, d)).astype(np.float32)), T(vfn(m)))[0])
    # exact duplicates: every database row has many copies, so copies give
    # bit-equal distances: the smallest valid index wins, second == best
    pool = rng.normal(size=(5, 64)).astype(np.float32)
    dup_db, dup_v = T(pool[rng.integers(0, 5, 700)]), T(rng.random(700) >= 0.2)
    dup_q = T(rng.normal(size=(300, 64)).astype(np.float32))
    err = max(err, check_l2("exact duplicates D=64", dup_q, dup_db, dup_v, exact_idx=True)[0])
    _, d1, d2 = match.l2_top2(dup_q, dup_db, dup_v)
    check(torch.equal(d1, d2), "l2_top2 exact duplicates: second != best")
    # one row past a tile, and that row is query 5's exact copy
    ext_db = torch.cat([dbf, qf[5:6]])
    ext_v = torch.cat([vf, torch.ones(1, dtype=torch.bool, device=device)])
    err = max(err, check_l2(f"N={N2} M={M2 + 1} D={D2} one row past a tile", qf, ext_db,
                            ext_v)[0])
    check(int(match.l2_top2(qf, ext_db, ext_v)[0][5]) == M2, "l2_top2: the last row was not found")
    del ext_db
    # best and second closer than L2_GAP: neighbours may swap, values hold
    near = rng.normal(size=(1000, D2)).astype(np.float32)
    near[1::2] = near[0::2] + 1e-4 * rng.normal(size=(500, D2)).astype(np.float32)
    near_q = near[0:400:2] + 0.05 * rng.normal(size=(200, D2)).astype(np.float32)
    err = max(err, check_l2("best and second within the gap", T(near_q), T(near),
                            torch.ones(1000, dtype=torch.bool, device=device))[0])
    # the L2 kernel's own path: the match_l2 front door a user calls
    match.l2_top2.launches = 0
    idx, _ = match.match_l2(qf, torch.ones(N2, dtype=torch.bool, device=device), dbf, vf)
    torch.cuda.synchronize()
    l2_launches = match.l2_top2.launches
    idx = idx.cpu().numpy()
    n_found = int((idx[: N2 // 4] == planted).sum())
    print(f"match_l2 front door N={N2} M={M2}: {int((idx >= 0).sum())} matches, "
          f"{n_found} of {N2 // 4} planted pairs found, l2_top2 launches={l2_launches}")
    check(l2_launches == 1, f"match_l2 launched l2_top2 {l2_launches} times")
    check(n_found == N2 // 4 and (idx[N2 // 4:] < 0).all(), "match_l2 front door: wrong matches")
    return res, err, l2_launches


def phase_desk(device, frames=DESK_FRAMES, config="configs/tum_fr1_desk.yaml"):
    """Benchmark config 2 at full width: `cli run`'s TUM loop over the
    in-memory desk world. Captures every keyframe-store match for phase 11."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import cli, system
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.data.synth_vision import make_desk_world
    from parakeet_slam_tpu_torch.kernels import match

    cfg = load_config(os.path.join(HERE, config))
    fc, fe = cfg.filter, cfg.frontend
    world = make_desk_world(num_steps=frames)
    check(tuple(world.image_size) == tuple(fe.image_size), f"world {world.image_size} vs {fe}")
    t0 = time.perf_counter()
    images = [world.render(i) for i in range(frames)]
    t_render = time.perf_counter() - t0
    odom = cli._make_odometry(cfg.data, world.gt_pose, frames)
    calls = []
    kf_match = system._batched_kf_match

    def capture(qd, qv, db, dbv, ratio):
        fwd, rev = kf_match(qd, qv, db, dbv, ratio)
        calls.append(tuple(t.clone() for t in (qd, qv, db, dbv, fwd, rev)) + (ratio,))
        return fwd, rev

    def run():
        resampled = []
        sys_ = system.SLAMSystem(cfg, device=device)
        sys_.metrics.log = lambda frame, **rec: resampled.append(rec["resampled"])
        est, fps, wall = cli.run_tum_sequence(sys_, images, odom)
        sys_.flush_flags()
        sys_.flush_metrics()
        return sys_, est, fps, wall, sum(resampled), sys_.graph.poses.cpu().numpy()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts_3d()
    match.hamming_top2.launches = 0
    system._batched_kf_match = capture
    try:
        sys_, est, fps, wall, n_res, graph_poses = run()
        launches = _counts_3d() + (match.hamming_top2.launches,)
    finally:
        system._batched_kf_match = kf_match
    peak = torch.cuda.max_memory_allocated()
    # the same run again from the same seed: bit for bit the same
    sys2, est2, _, _, n_res2, graph_poses2 = run()
    same = {"keyframes": len(sys2.keyframes) == len(sys_.keyframes), "resamples": n_res2 == n_res,
            "estimates": np.array_equal(est2, est), "graph poses": np.array_equal(graph_poses2,
                                                                                 graph_poses)}
    print(f"desk config 2 repeated: keyframes {len(sys_.keyframes)} / {len(sys2.keyframes)}, "
          f"resamples {n_res} / {n_res2}, estimates and graph poses "
          f"{'bit-equal' if same['estimates'] and same['graph poses'] else 'differ'}")
    check(all(same.values()), f"config 2 is not repeatable: {same}")
    del sys2
    est_opt, ates = cli.tum_ate(sys_, est, world.gt_pose, odom, cfg)
    print(f"desk config 2 (FastSLAM 2.0 pinhole_3d P={fc.num_particles} L={fc.max_landmarks} "
          f"Z={fc.max_observations}, {fe.max_features} features {fe.image_size[1]}x"
          f"{fe.image_size[0]}): {frames} frames fps={fps:.3f} (steady, from frame 3) "
          f"wall={wall:.2f}s render={t_render:.2f}s peak_mem={peak / 2**30:.3f} GiB")
    print(f"desk config 2: keyframes={len(sys_.keyframes)} dispatches={len(calls)} "
          f"loop_closures={len(sys_.loop_closures)} resamples={n_res} "
          f"launches score_3d={launches[0]} update_3d={launches[1]} gather={launches[2]} "
          f"hamming_top2={launches[3]}")
    print(f"desk config 2: ate corrected={ates[0]:.4f} m online={ates[1]:.4f} m "
          f"dead_reckoning={ates[2]:.4f} m (Sim(3), not gated)")
    check(bool(np.isfinite(est).all()) and bool(np.isfinite(est_opt).all()),
          "desk trajectory not finite")
    check(len(sys_.keyframes) >= 2, f"desk keyframes {len(sys_.keyframes)}")
    per = system.MATCH_LAUNCHES_PER_DISPATCH
    check(len(calls) >= 1 and launches[3] == per * len(calls),
          f"hamming_top2 launches {launches[3]}, dispatches {len(calls)} x {per}")
    check(launches[0] == frames and launches[1] == frames,
          f"desk launches score_3d={launches[0]} update_3d={launches[1]}, frames {frames}")
    check(launches[2] == n_res, f"desk gather launches {launches[2]}, resamples {n_res}")
    return {"fps": fps, "launches": launches, "calls": calls, "ates": ates,
            "closures": len(sys_.loop_closures), "peak_gib": peak / 2**30,
            "system": sys_, "est": est, "gt": world.gt_pose, "cfg": cfg}


def phase_desk_replay(calls):
    """Every keyframe-store match of phase 10 replayed through the twin:
    forward and reverse tables equal."""
    import torch

    from parakeet_slam_tpu_torch import system
    from parakeet_slam_tpu_torch.kernels import match

    kernel = match.hamming_top2
    match.hamming_top2 = match.hamming_top2_reference
    try:
        for i, (qd, qv, db, dbv, fwd, rev, ratio) in enumerate(calls):
            t_fwd, t_rev = system._batched_kf_match(qd, qv, db, dbv, ratio)
            for name, a, b in (("forward", fwd, t_fwd), ("reverse", rev, t_rev)):
                check(torch.equal(a, b), f"replay {i} (K={db.shape[0]}): {name} table "
                      f"differs in {int((a != b).sum())} entries")
    finally:
        match.hamming_top2 = kernel
    n_match = sum(int((c[4] >= 0).sum()) + int((c[5] >= 0).sum()) for c in calls)
    print(f"desk replay: {len(calls)} keyframe-store matches, forward and reverse tables "
          f"equal to the twin's ({n_match} matched entries)")


# --------------------------------------------------------------------------
# Slice 4: bundle adjustment
# --------------------------------------------------------------------------

CINV_BENCH = 262144   # the kernel bench's N (BASELINE.md:142)
CINV_BUCKET = 46080   # a bucket of the full-width problem: 90 x 512 rows
CINV_RTOL = 1e-6      # bit-equal is expected (-fmad=false, IEEE division)
CINV_OPS = 46         # operations per block, counted from csrc/schur.cu
BA_TWIN_ITERS = 2
BA_TWIN_RTOL = 1e-5
# run_ba on the config 2 system: twice the config's gn_iters, because LM
# from the config's lm_damping_init = 1e-4 rejects about its first ten
# iterations on this problem while the damping climbs (the reference does
# the same on the same problem).
BA_SYSTEM_ITERS = 20


def check_cinv(what, C, u):
    """apply_cinv against its twin; returns the largest |difference|."""
    import torch

    from parakeet_slam_tpu_torch.kernels import schur

    got = schur.apply_cinv(C, u)
    ref = schur.apply_cinv_reference(C, u)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.is_contiguous(), f"apply_cinv {what}: shape {got.shape}")
    check(bool(torch.isfinite(ref).all()), f"apply_cinv {what}: the twin is not finite")
    n_diff = int((got != ref).sum())
    err = float((got - ref).abs().max())
    check(torch.allclose(got, ref, rtol=CINV_RTOL, atol=0.0),
          f"apply_cinv {what}: {n_diff} entries differ, max |diff| {err}")
    print(f"apply_cinv {what}: "
          f"{'bit-equal' if n_diff == 0 else f'{n_diff} entries differ'} max_abs_err={err:.3g}")
    return err


def phase_cinv(device):
    """The inverse-apply kernel against its twin, then the three times."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.eval.kernel_inputs import schur_blocks
    from parakeet_slam_tpu_torch.kernels import schur

    T = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    err = 0.0
    for n in (CINV_BENCH, CINV_BUCKET, 1, 1000):
        C, u = schur_blocks(n, seed=n)
        err = max(err, check_cinv(f"N={n}", T(C), T(u)))
    # the blocks the solver makes: an invalid point (1e12 damping on a tiny
    # block), |det| < eps (replaced by eps), a negative det (sign kept)
    C, u = schur_blocks(4096, seed=3)
    C[::7] = 1e-3 * C[::7] + (1e12 + 1e-6) * np.eye(3, dtype=np.float32)
    C[1::7] = 1e-5 * np.eye(3, dtype=np.float32)
    C[2::7] = -C[2::7]
    err = max(err, check_cinv("N=4096 damped, |det|<eps and negative-det blocks", T(C), T(u)))
    # a C that is a view into a wider tensor, and a u broadcast from one row
    C, u = schur_blocks(5000, seed=4)
    wide = torch.zeros(5000, 4, 5, device=device)
    wide[:, :3, 1:4] = T(C)
    err = max(err, check_cinv("N=5000 strided C, broadcast u", wide[:, :3, 1:4],
                              T(u[:1]).expand(5000, 3)))

    # times at the bench shape: 8 operand sets (126 MB) in turn, so that no
    # launch finds its operands in the 50 MB L2
    sets = [tuple(T(a) for a in schur_blocks(CINV_BENCH, seed=100 + i)) for i in range(8)]
    pick = lambda i: sets[i % len(sets)]  # noqa: E731
    # The library call is `solve_ex` without its error check: `linalg.solve`
    # copies its status to the host in every call, and would be timed with
    # that round trip. The twin (~35 launches) and the solve get few calls per
    # run, so that the host has them all enqueued while the sleep still runs.
    solve = lambda C, u: torch.linalg.solve_ex(C, u[..., None], check_errors=False)[0]  # noqa: E731
    ms = queued_ms(lambda i: schur.apply_cinv(*pick(i)))
    plain = queued_ms(lambda i: schur.apply_cinv_reference(*pick(i)), reps=5)
    lib = queued_ms(lambda i: solve(*pick(i)), reps=5)
    C, u = sets[0]
    lib_err = float((solve(C, u)[..., 0] - schur.apply_cinv(C, u)).abs().max())
    # bound: the function needs the upper triangle of each block (24 of its
    # 36 bytes), u and y; 46 operations per block (24 multiplies, 14 adds and
    # subtracts, 2 negations, 3 divisions, the |det| test). Beside it the
    # bound with all of C as it lies in memory.
    bnd = bound(nbytes(C) * 2 // 3 + nbytes(u, u), CINV_OPS * CINV_BENCH)
    bnd_laid_out = bound(nbytes(C, u, u), CINV_OPS * CINV_BENCH)
    small = tuple(T(a) for a in schur_blocks(CINV_BUCKET, seed=5))
    ms_bucket = queued_ms(lambda i: schur.apply_cinv(*small))
    print(f"apply_cinv N={CINV_BENCH}: kernel={ms:.5f} ms ({nbytes(C, u, u) / ms / 1e9:.3f} TB/s "
          f"of C, u and y as laid out) twin={plain:.5f} ms linalg.solve_ex={lib:.5f} ms "
          f"(max |solve - kernel| {lib_err:.3g}) bound={bnd[0]:.5f} ms ({bnd[1]}, upper "
          f"triangle of C; {bnd_laid_out[0]:.5f} ms with all 36 B of a block); "
          f"N={CINV_BUCKET}: kernel={ms_bucket:.5f} ms")
    return {"err": err, "ms": ms, "plain": plain, "library": lib, "bound": bnd,
            "bound_laid_out": bnd_laid_out[0], "ms_bucket": ms_bucket}


def _profile(fn):
    """(launches, device busy ms, wall ms, the five device activities with
    the most time as (name, ms, count)) of fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev, "torch.profiler recorded no device activity")
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(((name, ms, n) for name, (ms, n) in by_name.items()), key=lambda r: -r[1])[:5]
    return len(dev), sum(e.time_range.elapsed_us() for e in dev) / 1e3, wall, top


def phase_ba(device):
    """Bundle adjustment at full width with configs/euroc_mh.yaml's backend."""
    import torch

    from parakeet_slam_tpu_torch.backend import ba, graph
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.eval import bench_kernels
    from parakeet_slam_tpu_torch.eval.kernel_inputs import BA_BENCH_CAMERA, ba_bench_problem
    from parakeet_slam_tpu_torch.frontend.camera import Pinhole
    from parakeet_slam_tpu_torch.kernels import schur

    be = load_config(os.path.join(HERE, "configs/euroc_mh.yaml")).backend
    check(be.solver == "pcg", f"euroc_mh.yaml solver {be.solver}")
    cam = Pinhole(*BA_BENCH_CAMERA)
    prob = graph.make_ba_problem(**ba_bench_problem(), device=device)
    t0 = time.perf_counter()
    bk = graph.pack_buckets(prob)
    t_pack = time.perf_counter() - t0
    shapes = [tuple(p.shape) for p in bk.p_cam]
    kw = dict(lam=be.lm_damping_init, pcg_iters=be.pcg_iters, huber_delta=be.huber_delta,
              solver=be.solver, step_clamp=(be.ba_step_clamp_cam, be.ba_step_clamp_pt))
    cost0 = float(ba.ba_cost(cam, prob, be.huber_delta))
    ba.optimize_ba(cam, bk, iters=1, **kw)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    schur.apply_cinv.launches = 0
    t0 = time.perf_counter()
    res = ba.optimize_ba(cam, bk, iters=be.gn_iters, **kw)
    costs = res.costs.cpu()
    dt = time.perf_counter() - t0
    launches = schur.apply_cinv.launches
    peak = torch.cuda.max_memory_allocated()
    want = be.gn_iters * len(shapes) * (be.pcg_iters + 3)
    print(f"ba full width (C={prob.num_cams} points={prob.num_points} obs={prob.num_obs}, "
          f"buckets {shapes}, packed in {t_pack:.2f} s; lam0={be.lm_damping_init} "
          f"iters={be.gn_iters} pcg_iters={be.pcg_iters} huber={be.huber_delta}): "
          f"{dt:.3f} s, {dt / be.gn_iters * 1e3:.1f} ms per LM iteration, "
          f"peak_mem={peak / 2**30:.3f} GiB, apply_cinv launches={launches}")
    print(f"ba full width: cost {cost0:.1f} -> {float(costs[0]):.1f} -> {float(costs[-1]):.1f}, "
          f"accepted {int((costs[1:] < costs[:-1]).sum()) + int(costs[0] < cost0)} of "
          f"{be.gn_iters}, last pcg residual {float(res.pcg_residuals[-1]):.3g}")
    check(bool(torch.isfinite(costs).all()), f"ba costs not finite: {costs}")
    check(float(costs[-1]) < cost0 and float(costs[-1]) <= float(costs[0]),
          f"ba cost did not fall: {cost0} -> {costs}")
    check(bool(torch.isfinite(res.problem.cam_pose).all() & torch.isfinite(res.problem.points).all()),
          "ba result not finite")
    check(launches == want, f"apply_cinv launches {launches} != {be.gn_iters} x {len(shapes)} x "
          f"({be.pcg_iters} + 3) = {want}")

    # the first iterations again, the kernel path against the twin path
    kernel = ba.optimize_ba(cam, bk, iters=BA_TWIN_ITERS, **kw)
    dispatch = schur.cinv_apply
    schur.cinv_apply = schur.apply_cinv_reference
    try:
        n0 = schur.apply_cinv.launches
        twin = ba.optimize_ba(cam, bk, iters=BA_TWIN_ITERS, **kw)
        check(schur.apply_cinv.launches == n0, "the twin path launched the kernel")
    finally:
        schur.cinv_apply = dispatch
    kc, tc = kernel.costs.cpu(), twin.costs.cpu()
    check(torch.equal(kc, costs[:BA_TWIN_ITERS]), f"ba is not repeatable: {kc} vs {costs[:2]}")
    check(torch.allclose(kc, tc, rtol=BA_TWIN_RTOL, atol=0.0), f"ba kernel path {kc} vs twin {tc}")
    check(torch.equal(kc < torch.tensor([cost0, float(kc[0])]),
                      tc < torch.tensor([cost0, float(tc[0])])), "ba accepts differ from the twin's")
    d_pose = float((kernel.problem.cam_pose - twin.problem.cam_pose).abs().max())
    d_pts = float((kernel.problem.points - twin.problem.points).abs().max())
    print(f"ba kernel vs twin path, {BA_TWIN_ITERS} iterations: costs {kc.tolist()} vs "
          f"{tc.tolist()}, same accepts, max |diff| poses {d_pose:.3g} points {d_pts:.3g}")

    # where an LM iteration's time goes
    n_prof = 2
    n_launch, busy, wall, top = _profile(lambda: ba.optimize_ba(cam, bk, iters=n_prof, **kw))
    print(f"ba profile, {n_prof} LM iterations: {n_launch / n_prof:.0f} device launches, "
          f"device busy {busy / n_prof:.2f} ms, wall {wall / n_prof:.1f} ms per iteration "
          f"with the profiler on; idle share {1 - busy / wall:.3f} with it, "
          f"{1 - busy / n_prof / (dt / be.gn_iters * 1e3):.3f} against the unprofiled "
          f"{dt / be.gn_iters * 1e3:.1f} ms")
    for name, ms, n in top:
        print(f"ba profile:   {ms / n_prof:8.2f} ms {n / n_prof:7.0f} launches per iteration  "
              f"{name[:90]}")
    bench_kernels.run(["schur", "ba_iteration"], device)
    return {"launches": launches, "per_iter_ms": dt / be.gn_iters * 1e3, "costs": costs.tolist(),
            "peak_gib": peak / 2**30}


def phase_run_ba(desk):
    """`run_ba()` on the config 2 system that phase 10 left."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import system
    from parakeet_slam_tpu_torch.eval import ate_rmse
    from parakeet_slam_tpu_torch.kernels import match, schur

    sys_, est, gt = desk["system"], desk["est"], desk["gt"]
    K = len(sys_.keyframes)
    logged = []
    sys_.metrics.log = lambda frame, **rec: logged.append(rec)
    dedup, assign = [], system._assign_point_ids

    def capture(desc, valid, world, **kw):
        out = assign(desc, valid, world, **kw)
        dedup.append(((desc, valid, world), kw, out))
        return out

    match.hamming_top2.launches = 0
    schur.apply_cinv.launches = 0
    system._assign_point_ids = capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = sys_.run_ba(iters=BA_SYSTEM_ITERS)
    finally:
        system._assign_point_ids = assign
    costs = res.costs.cpu()
    dt = time.perf_counter() - t0
    launches = (match.hamming_top2.launches, schur.apply_cinv.launches)

    # The point dedup again through the twin: one match per keyframe against
    # the store as the kernel path left it after the keyframes before, so a
    # wrong match anywhere changes the ids, the store or the counts.
    check(len(dedup) == 1, f"run_ba deduplicated {len(dedup)} times")
    args, kw, ((sd, sv, sp, cnt, drop), pid) = dedup[0]
    kernel = match.hamming_top2
    match.hamming_top2 = match.hamming_top2_reference
    try:
        (t_sd, t_sv, t_sp, t_cnt, t_drop), t_pid = assign(*args, **kw)
    finally:
        match.hamming_top2 = kernel
    check(match.hamming_top2.launches == launches[0], "the twin dedup launched the kernel")
    for name, a, b in (("pid", pid, t_pid), ("store descriptors", sd, t_sd),
                       ("store_valid", sv, t_sv), ("store positions", sp, t_sp),
                       ("count", cnt, t_cnt), ("dropped", drop, t_drop)):
        check(torch.equal(a, b), f"run_ba dedup: {name} differs from the twin's in "
              f"{int((a != b).sum())} entries")
    print(f"run_ba dedup replay: {args[0].shape[0]} keyframes x {args[0].shape[1]} rows against a "
          f"store of {kw['cap']} (Hamming < {kw['max_ham']}): ids, store, count {int(cnt)} and "
          f"dropped {int(drop)} equal to the twin's ({int((pid >= 0).sum())} ids assigned)")
    dropped = sum(r.get("ba_points_dropped", 0) for r in logged)
    poses = np.stack([kf.pose for kf in sys_.keyframes])
    # the online estimates re-anchored to the adjusted keyframes (no further
    # pose-graph solve, which would overwrite them)
    est_ba = sys_.corrected_trajectory(est, final_optimize=False)
    n = len(est)
    ate = float(ate_rmse(torch.as_tensor(est_ba[:, :3]), torch.as_tensor(gt[:n, :3]),
                         with_scale=True))
    be = desk["cfg"].backend
    print(f"run_ba config 2: {K} keyframes, {int(res.problem.pt_valid.sum())} points "
          f"({dropped} dropped at capacity {res.problem.num_points}), "
          f"{int(res.problem.obs_valid.sum())} observations, {sys_.graph.n_edges} pose edges at "
          f"weight {be.ba_pose_edge_weight}; {len(costs)} LM iterations in {dt:.3f} s; "
          f"launches hamming_top2={launches[0]} apply_cinv={launches[1]}")
    n_acc = int((costs[1:] < costs[:-1]).sum())
    print(f"run_ba config 2: cost {float(costs[0]):.1f} -> {float(costs[-1]):.1f} ({n_acc} of the "
          f"last {len(costs) - 1} iterations accepted); corrected ate "
          f"{desk['ates'][0]:.4f} m before, {ate:.4f} m after (Sim(3), not gated)")
    check(bool(np.isfinite(poses).all()) and bool(np.isfinite(est_ba).all()),
          "run_ba keyframe poses not finite")
    check(bool(torch.isfinite(costs).all()) and float(costs[-1]) <= float(costs[0]),
          f"run_ba costs {costs}")
    check(launches[0] == K, f"run_ba hamming_top2 launches {launches[0]}, keyframes {K}")
    check(launches[1] > 0 and launches[1] % (len(costs) * (be.pcg_iters + 3)) == 0,
          f"run_ba apply_cinv launches {launches[1]}")
    return {"launches": launches, "seconds": dt, "ate": ate}


def main():
    if not os.path.isdir(os.path.join(HERE, "parakeet_slam_tpu_torch", "csrc")):
        raise SystemExit("chip_smoke FAILED: run from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    check(len(sys.argv) == 1, f"chip_smoke.py takes no arguments, got {sys.argv[1:]}")
    card = phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    phase_wrap(device)
    k, ekf_err = phase_kernels(device)
    launches = phase_corridor(device)
    phase_real_size(device)
    k3, err3 = phase_kernels_3d(device)
    vision = phase_vision(device)
    phase_bench_rows(device)
    km, l2_err, l2_launches = phase_match(device)
    desk = phase_desk(device)
    phase_desk_replay(desk["calls"])
    cinv = phase_cinv(device)
    ba_run = phase_ba(device)
    sys_ba = phase_run_ba(desk)

    pkg = "parakeet_slam_tpu_torch"

    def entry(name, source, replaces, n_launches, err, ms, plain, bnd, library=None, **more):
        return {"name": name, "route": "cuda", "source": f"{pkg}/csrc/{source}",
                "replaces": replaces, "launches": n_launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library, **more}

    ekf, gat = k[("ekf", REAL_SHAPE)], k[("gather", REAL_SHAPE)]
    t3, eq, pan = k3["kitti"][1], k3["equirect_3d"][1], k3["panoramic"][1]
    # the update as the vision path (FastSLAM 2.0) runs it: fed score_3d's
    # scores; scoring itself, it runs on FastSLAM 1.0 (the panoramic config)
    x3, x2 = k3["kitti_ext"][1], k3["config2_ext"][1]
    c2f, c2r = km["closure_config2"]
    pnf, pnr = km["closure_panoramic"]
    record = {"kernels": [
        entry("ekf_update_2d", "ekf_update_2d.cu", "parakeet_slam_tpu/kernels/ekf_update.py:443",
              launches[0], ekf_err, ekf[1], ekf[2], ekf[3],
              ms_corridor=k[("ekf", CORRIDOR_SHAPE)][1],
              plain_ms_corridor=k[("ekf", CORRIDOR_SHAPE)][2],
              bound_ms_corridor=k[("ekf", CORRIDOR_SHAPE)][3][0],
              ms_single_call=ekf[4], ms_corridor_single_call=k[("ekf", CORRIDOR_SHAPE)][4]),
        entry("gather_rows", "gather_rows.cu", "parakeet_slam_tpu/kernels/resample_pallas.py:32",
              launches[1], max(k["gather_variants"],
                               *(k[("gather", s)][0] for s in (CORRIDOR_SHAPE, REAL_SHAPE))),
              gat[1], gat[2], gat[3], library=gat[2],
              ms_corridor=k[("gather", CORRIDOR_SHAPE)][1],
              plain_ms_corridor=k[("gather", CORRIDOR_SHAPE)][2],
              ms_single_call=gat[4], plain_ms_single_call=gat[5],
              ms_corridor_single_call=k[("gather", CORRIDOR_SHAPE)][4],
              plain_ms_corridor_single_call=k[("gather", CORRIDOR_SHAPE)][5]),
        entry("measurement_update_3d", "ekf_update_3d.cu",
              "parakeet_slam_tpu/kernels/ekf_update_3d.py:664", vision["launches"][1], err3,
              x3["update"], x3["update_twin"], x3["update_bound"],
              mode="fed score_3d's scores", ms_single_call=x3["update_single"],
              ms_config2=x2["update"], plain_ms_config2=x2["update_twin"],
              bound_ms_config2=x2["update_bound"][0], launches_desk=desk["launches"][1],
              ms_self_scoring=t3["update"], plain_ms_self_scoring=t3["update_twin"],
              bound_ms_self_scoring=t3["update_bound"][0],
              ms_self_scoring_single_call=t3["update_single"],
              ms_self_scoring_panoramic=pan["update"],
              plain_ms_self_scoring_panoramic=pan["update_twin"],
              bound_ms_self_scoring_panoramic=pan["update_bound"][0],
              ms_self_scoring_bench_equirect=eq["update"],
              plain_ms_self_scoring_bench_equirect=eq["update_twin"]),
        entry("score_3d", "ekf_update_3d.cu", "parakeet_slam_tpu/kernels/ekf_update_3d.py:920",
              vision["launches"][0], err3, t3["score"], t3["score_twin"], t3["score_bound"],
              ms_single_call=t3["score_single"], ms_bench_equirect=eq["score"],
              plain_ms_bench_equirect=eq["score_twin"], launches_desk=desk["launches"][0]),
        entry("hamming_top2", "match.cu", "parakeet_slam_tpu/kernels/match.py:269",
              desk["launches"][3], 0.0, km["ham"][0], km["ham"][1], km["ham"][2],
              launches_run_ba=sys_ba["launches"][0],
              ms_closure_config2_forward=c2f[0], ms_closure_config2_reverse=c2r[0],
              plain_ms_closure_config2_forward=c2f[1], bound_ms_closure_config2_forward=c2f[2][0],
              ms_closure_panoramic_forward=pnf[0], ms_closure_panoramic_reverse=pnr[0],
              plain_ms_closure_panoramic_forward=pnf[1],
              bound_ms_closure_panoramic_forward=pnf[2][0],
              bound_ms_closure_panoramic_reverse=pnr[2][0]),
        entry("l2_top2", "match.cu", "parakeet_slam_tpu/kernels/match.py:342", l2_launches,
              l2_err, km["l2"][1], km["l2"][2], km["l2"][3], library=km["l2"][2],
              bound_ms_fp32=km["l2"][4], ms_single_call=km["l2"][5],
              plain_ms_single_call=km["l2"][6]),
        entry("apply_cinv", "schur.cu", "parakeet_slam_tpu/kernels/schur.py:83",
              ba_run["launches"], cinv["err"], cinv["ms"], cinv["plain"], cinv["bound"],
              library=cinv["library"], ms_bucket=cinv["ms_bucket"],
              bound_ms_all_of_c=cinv["bound_laid_out"],
              launches_run_ba=sys_ba["launches"][1]),
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
