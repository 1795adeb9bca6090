#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`parakeet_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. Phases:
  1. environment: torch/CUDA versions, card name and power limit, TF32 flags;
  2. build the hand-written kernels from `parakeet_slam_tpu_torch/csrc` (six
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
     filter seeds 0-4, `run_sequence` replaying its captured CUDA graph
     (the default on the card; `filter/captured.py`): every frame through
     the update kernel and the gather kernel (the resample is decided on
     the device, so the gather runs every frame, at the identity indices
     where the ESS asks for none; the resamples are counted from the
     metrics, > 0), each ATE < 0.5 m, the 5-seed mean in the JAX reference
     band [0.136, 0.264] m;
  5. the main path at the real-size shape for 30 frames: finite, both
     kernels launched once a frame, frames/s and peak device memory;
  6. the two 3-D kernels (measurement_update_3d, score_3d) against their
     twins: each model at the bench shape (P=1024, L=8192, Z=32), stereo at
     the KITTI shape (P=2048, L=10240, Z=128) and equirect at the panoramic
     config's shape (P=1024, L=8192, Z=128), the update scoring the frame
     itself; the update fed score_3d's scores, as FastSLAM 2.0 runs it, at
     the KITTI shape, config 2's (pinhole, P=512, L=1024, Z=64) and config
     4's (pinhole, P=512, L=4096, Z=64); then
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
  7. the vision filter at full width, benchmark config 3 (configs/kitti_00.yaml:
     FastSLAM 2.0, stereo_3d, P=2048, L=10240, Z=128) fed synthetic
     observations for 10 frames of the drive world (phase 11b runs the same
     configuration from images): one score_3d and one measurement_update_3d
     launch per frame, one gather a frame, a finite trajectory,
     frames/s, peak device memory, ATE against ground truth and dead
     reckoning (printed, not gated); the kernel path and the twin path
     give equal masks and counts over the first 2 frames from the same
     draws (both eager);
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
     the first 90 frames of the in-memory desk world's 120 (two orbits, the
     second revisits the first; 90, not 120, to keep the script
     near 600 s): a finite trajectory, >= 2 keyframes, >= 1 accepted
     closure, so that the repeat below covers one, hamming_top2 launched
     twice per closure dispatch (forward and reverse) and at least once,
     one score_3d and one measurement_update_3d launch per frame, one gather
     a frame, rotation_fit three times per closure verification (Horn's
     rounds) and at least once; frames/s (from frame 3), keyframes,
     dispatches, accepted closures, peak device memory, and the corrected,
     online and dead-reckoning ATE (Sim(3), not gated); then the same run again from
     the same seed: keyframe count, resample count, estimates and pose-graph
     poses equal bit for bit;
  11. every keyframe-store match of phase 10, replayed through the twin:
     forward and reverse tables equal;
  11b. the stereo system of benchmark config 3 at full width from images
     (configs/kitti_00.yaml: FastSLAM 2.0, stereo_3d, P=2048, L=10240,
     Z=128, 512 FAST + BRIEF features on 376x1241 pairs): 20 frames of the
     drive world written in the KITTI layout and run through `cli run`'s
     KITTI loop (loader, stereo frames with the SAD disparity, SE(3) ATE): a
     finite trajectory, one score_3d and one measurement_update_3d launch
     per frame, one gather a frame, hamming_top2 twice per closure
     dispatch, at least one disparity-valid observation a frame on average,
     landmarks > 0 (the observations counted again eagerly: the frontend
     runs inside the frame's graph); one frame's keypoint_disparity on the
     card equal to the CPU's in mask and disparity (within 1e-5), keypoints
     whose two smallest SADs lie within a relative 1e-6 excused and
     counted; frames/s (from frame 3), peak device memory, observations,
     keyframes, closures and the ATEs printed; the same 20 frames through
     the eager twin (`capture=False`): estimates, every state leaf, the
     pose graph, keyframes and closures bit-equal; then 4 more frames of
     each, the first without a flush and the flush frame under
     torch.profiler (launches, host CUDA API calls, graph launches, device
     busy, idle share), and the eager frontend's own time;
  12. the landmark-block inverse-apply kernel (apply_cinv) against its twin:
     the bench shape N=262144, a bucket-sized N=46080, N=262147, 46083, 1,
     3, 1000 and 1001 (no whole block of threads), a non-contiguous C with
     a broadcast u, and blocks with |det| < eps, a negative det and a 1e12
     damping diagonal; within rtol=1e-6 (bit-equal is expected and
     reported); times of kernel, twin and `torch.linalg.solve_ex` (the
     solve without its host-side error check) with the launches queued
     behind a sleep kernel and the operands rotated past the L2 cache;
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
     seconds, and the corrected ATE before and after (printed, not gated);
  15. the multi-session run of benchmark config 4 at full width
     (configs/euroc_mh.yaml: FastSLAM 2.0, pinhole_3d, P=512, L=4096, Z=64,
     W=8, 512 FAST + BRIEF features on 480x752; the backend's caps of 1024
     keyframes, 51,200 points and 262,144 observations, LM from a damping of
     1.0, 20 LM x 100 PCG): two sessions of the machine hall (8,000
     landmarks, the first 30 frames of each session's 400), written in the
     ASL layout and run through `cli run`'s multi-session runner (loader,
     the checkpoint round trip into a fresh system at the boundary, the
     relocalization prior, the joint BA solved twice and timed warm): a
     finite trajectory over both sessions, >= 2 keyframes in each, a finite
     joint-BA cost whose last value is <= its first; one score_3d and one
     measurement_update_3d launch per frame, one gather a frame,
     hamming_top2 twice per closure dispatch plus once per keyframe of the
     BA's point dedup, apply_cinv 2 x gn_iters x buckets x (pcg_iters + 3);
     the kernels against their twins at config 4's shapes and data: every
     closure dispatch (forward and reverse tables) and the BA's dedup
     (store, point ids, counts) replayed through hamming_top2's twin equal,
     the last resample's gather of the 512 x 4096-lane state equal to the
     twin's, and the kernel path and the twin path giving equal masks and
     counts over session one's first 3 frames from the same draws;
     frames/s from frame 3 of each session, keyframes, closures within and
     across sessions, BA points, observations and seconds per LM iteration,
     peak device memory, the boundary snapshot's save and load seconds and
     MB, and the SE(3) and Sim(3) ATE online, corrected, after BA and of
     dead reckoning (printed, not gated); then session one resumed: its
     first 17 frames (inside a flag window), a snapshot, a fresh system that
     loads it and runs frames 17-29, whose estimates equal the run's and
     whose snapshot after frame 29 equals the run's boundary snapshot in
     every array (filter state, graph and cursors, generator, keyframes,
     closures, the pending flag window and closure matches), bit for bit,
     and the same from a second cut inside a flag window with closure
     matches pending, where session one has one; the first resume's last 3
     frames run under torch.profiler (launches, device busy, idle share);
  16. benchmark config 5's distributed layer at world size 1, inside a
     one-rank NCCL process group that the phase starts on a free local port
     and destroys (no fallback when NCCL or the card is missing): the
     sharded filter (`dist.ShardedFastSLAM` on a 1 x 1 mesh) at the full
     width of configs/panoramic.yaml (FastSLAM 1.0, equirect_3d, P=1024,
     L=8192, Z=128, W=8) for 10 frames fed from the panoramic world's
     projection (`kernel_inputs.panoramic_observations`, >= 100 valid
     observations a frame): every state leaf and every estimate bit-equal
     to `FastSLAM.step` on the same draws, one measurement_update_3d launch
     a frame and one gather a resample (>= 1), its first 2 frames replayed
     on the twin path (lm_valid and lm_count equal, estimates within 1e-5),
     frames/s, launches a frame, idle share and peak memory; the snapshot
     of the gathered state after frame 5 resumed through
     `multihost.resume_or_init` and frames 6-10 bit-equal; the ring match at
     the config-5 demo's shape (M=131,072, N=256, W=8) against the dense
     twin (b1 and b2 equal, idx equal off ties) and timed beside
     hamming_top2 alone on the whole database; the distributed BA at the
     demo's size (64 cameras, 110,000 points, 128,000 observations, 3 LM x
     15 PCG, S=1) with costs within rtol=1e-4 of the same solver through
     apply_cinv's twin, ms per LM iteration beside `ba.optimize_ba` on the
     same problem;
  17. the generic measurement path (`FastSLAM._measurement_generic`, plain
     torch, the reference's model-agnostic route) on the card, against the
     hand kernels from one state: ekf_update_2d at the corridor shape and
     at P=2048, L=10240, Z=32, S=3, and measurement_update_3d scoring
     itself at pinhole P=256, L=1024, Z=32 with the anchor freeze off and
     at 3. The two paths do the same arithmetic in different forms, so an
     association may part only where the generic best score lies within
     1e-4 of the new-landmark threshold or of the runner-up (counted and
     printed, those particles left out); every other lane, mask, count and
     n_match equal, floats within rtol=atol=1e-5, log_w within atol 1e-4;
     the single-call times of both. Then 30 frames each of a bearing_2d
     FastSLAM 1.0 filter and a bearing_2d + velocity_2d FastSLAM 2.0
     filter (P=64, L=192, Z=16) on the corridor's bearings: finite, every
     particle mapping, one gather a frame, frames/s;
  18. `eval/bench_system` at the reference's widths (FastSLAM 1.0, P=256,
     L=2048, Z=64): stereo (`process_stereo_frame` on 376x1241 pairs) and
     pano (`process_frame` on 512x1024 equirect frames), 5 warm-up frames
     then the reference's 30 timed frames on its 35-step worlds, rendered
     in worker processes started before phase 6: the reference's
     result line, one measurement_update_3d launch a frame (scoring
     itself, no score_3d), one gather a frame, hamming_top2 twice a
     closure dispatch, >= 2 keyframes, finite estimates; frames/s, ms a
     frame, keyframes, launches a frame, idle share, peak memory and the
     render seconds; the first 2 frames replayed on the twin path (lm_valid
     and lm_count equal, estimates within 1e-5), and on an eager system with
     the kernels (every state leaf and estimate bit-equal to the captured
     one); one eager image frame under the sync check; the last 4 frames
     on both, profiled as in phase 11b;
  19. (run after phase 11) the captured step against its eager twin
     (`capture=False`) from the same draws: the corridor (config 1, seed 0,
     500 frames) and config 3's filter (10 frames) through `run_sequence`,
     config 2's system (phase 10's captured run, whose frames are one graph
     each with the frontend inside, its closure verification and its
     pose-graph solves graphs too, against an eager run over the same 90
     frames): every state leaf, estimate and metric (and config 2's
     corrected trajectory, graph, keyframes and closures) bit-equal;
     frames/s of both, the capture and instantiation seconds, the shared
     graph pool's bytes and the launches counted per replay; for each path
     and mode frames under torch.profiler (device launches, host CUDA API
     calls, device busy, wall, idle share; config 2's a frame without a
     flush, one graph launch with no kernel of the frontend launched from
     the host, and a flush frame, then 6 frames unprofiled on the host's
     clock); config 2 with
     a 2-level pyramid, 3 frames captured against eager; closure
     verification, Horn's consensus and the refine in one graph, at Nc = 1,
     4, 16 candidates of F = 256 with both refines (rels and inliers
     bit-equal, one graph launch and three rotation_fit launches counted a
     verify, its host CUDA API calls, ms a verify captured and eager in
     turns, one eager verification under the sync check); rotation_fit
     against its twin (linalg.svd and det on the card) and a float64 Kabsch
     fit on closure covariances and on spread, coplanar, reflected, rank-1
     and zero matrices (HORN_TOL_F64, HORN_TOL_TWIN + HORN_TWIN_SLOPE /
     gap; proper and optimal rotations throughout), a strided input, and its
     device time at B = 16 and 1 beside the twin's; the pose-graph
     solve at K = 64, 256, 2048 with E = 4K, 10 LM iterations (poses and
     costs bit-equal, one graph launch a solve, ms in turns with eager,
     capture, instantiation and pool); one eager step of configs 1-4, of
     the image frame (mono, pyramid, and phase 18's stereo and pano), of
     both verifications and of the solve under
     `torch.cuda.set_sync_debug_mode("error")`.
On the card phases 4, 5, 7, 10, 11b, 15, 17 and 18 run the captured step
(the default; in 10, 11b, 15 and 18 the frame's graph holds the frontend,
and closure verification and the pose-graph solve replay graphs too): each
wrapper's launch count holds its launches on the warm-up frame and once
per replay (`CapturedStep` takes back what the capture counted and adds it
per replay); the twin paths run eagerly.
Every kernel's record carries its bound: the larger of the bytes it must
move (inputs read once, outputs written once) over 3.35 TB/s and its
operations over the card's peak for their type (67 TFLOP/s float32, 1,979
TOP/s int8, 495 TFLOP/s TF32 at three products per multiply-add for l2_top2,
whose record keeps the float32 figure as bound_ms_fp32, 34 TFLOP/s float64
for rotation_fit), counted from the inputs of this run and from the
arithmetic of the plain twins (OPS_2D, OPS_3D, CINV_OPS) or, for
rotation_fit, of the kernel with this run's Jacobi sweeps (HORN_OPS_*).
Exits non-zero at the first failed check, and without a result when there
is no CUDA device or no package beside the script. The last line is
{"ok": true, "device": {...}}, the line before it the kernels' JSON record
(the eight kernels: ekf_update_2d, gather_rows, measurement_update_3d,
score_3d, hamming_top2, l2_top2, apply_cinv, rotation_fit) and the line
before that the
card's name and power limit. The records of the five kernels on config 4's
path carry its launches as `launches_config4`, those of the four on config
5's distributed path as `launches_config5`, those of the three on
bench_system's paths (gather_rows, measurement_update_3d, hamming_top2) as
`launches_bench_stereo` and `launches_bench_pano`; measurement_update_3d's
carries phase 17's largest float difference as `max_abs_err_generic_path`.
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
# float64 operations/s outside the tensor cores (NVIDIA's H100 SXM data sheet)
PEAK_F64 = 34e12


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


CONFIG5_STATE = (1024, 8192, 8)  # config 5's P, L and descriptor words
RING_WINDOWS = 4                 # the ring of config 5 on four cards


def check_gather_windows(device):
    """The source-window launch of the gather (the ring gather's form) at
    config 5's state (P=1024, L=8192, W=8, 3-D landmarks) cut into 4 blocks
    of 256 rows: for every rank of a 4-rank ring, its 256 resample indices
    taken window by window in the ring's order (each launch writes the rows
    whose source its block holds), bit-equal to the twin's windows and to
    the global take; then rank 0's 4 windows, kernel against twin, timed in
    turns beside the bound of the bytes they move."""
    import torch

    from parakeet_slam_tpu_torch.core.state import ParticleState
    from parakeet_slam_tpu_torch.kernels import resample, resample_cuda

    P, L, W = CONFIG5_STATE
    S = RING_WINDOWS
    Pl = P // S
    g = torch.Generator(device=device).manual_seed(5)
    st = ParticleState(
        pose=torch.randn(P, 7, generator=g, device=device), log_w=torch.zeros(P, device=device),
        lm_mean=torch.randn(P, L, 3, generator=g, device=device),
        lm_cov=torch.randn(P, L, 3, 3, generator=g, device=device),
        lm_sig=torch.zeros(P, L, 0, device=device),
        lm_desc=torch.randint(-2**31, 2**31, (P, L, W), generator=g, device=device,
                              dtype=torch.int64).to(torch.int32),
        lm_valid=torch.rand(P, L, generator=g, device=device) > 0.5,
        lm_count=torch.randint(0, 9, (P, L), generator=g, device=device, dtype=torch.int32))
    lw = 3.0 * torch.randn(P, generator=g, device=device)
    idx = resample.systematic_resample_indices(lw, 0.37 / P)
    blocks = [st.replace(**{f: getattr(st, f)[s * Pl:(s + 1) * Pl] for f in STATE_KEYS
                            + ("lm_desc",)}) for s in range(S)]

    def windows(fn, me):
        out = None
        for k in range(S):
            src = (me - k) % S
            out = fn(blocks[src], idx[me * Pl:(me + 1) * Pl], window=src * Pl, out=out)
        return out

    for me in range(S):
        got = windows(resample_cuda.gather_state, me)
        twin = windows(resample_cuda.gather_state_reference, me)
        whole = resample_cuda.gather_state_reference(st, idx[me * Pl:(me + 1) * Pl])
        torch.cuda.synchronize()
        for k in STATE_KEYS + ("lm_desc",):
            a = getattr(got, k)
            check(_bit_equal(a, getattr(twin, k)) and _bit_equal(a, getattr(whole, k)),
                  f"gather_rows source window rank {me}: {k} differs")
        del got, twin, whole
    n_bytes = sum(getattr(st, f).numel() * getattr(st, f).element_size()
                  for f in STATE_KEYS + ("lm_desc",) if f != "log_w") // P * Pl
    out_k = windows(resample_cuda.gather_state, 0)
    out_t = windows(resample_cuda.gather_state_reference, 0)
    kernel = lambda i=0: windows(lambda *a, **k: resample_cuda.gather_state(  # noqa: E731
        *a, **{**k, "out": out_k}), 0)
    twin = lambda i=0: windows(lambda *a, **k: resample_cuda.gather_state_reference(  # noqa: E731
        *a, **{**k, "out": out_t}), 0)
    turns = [queued_ms(f, reps=10) for f in (kernel, twin, kernel, twin)]
    # each of the 256 rows read once from its block and written once
    bnd = bound(2 * n_bytes + nbytes(idx[:Pl]), 0)
    print(f"gather_rows source window, config 5's state P={P} L={L} W={W} in {S} blocks of "
          f"{Pl}: every rank's {S} windows bit-equal to the twin's and to the global take; "
          f"rank 0's {S} launches ({n_bytes / 1e6:.1f} MB moved) kernel={turns[0]:.4f}; "
          f"{turns[2]:.4f} ms twin={turns[1]:.4f}; {turns[3]:.4f} ms (device time, in turns); "
          f"bound={bnd[0]:.4f} ms ({bnd[1]})")
    return (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2, bnd


def phase_kernels(device):
    res = {}
    for shape in (CORRIDOR_SHAPE, REAL_SHAPE):
        res[("ekf", shape)] = check_update_kernel(shape, device)
        res[("gather", shape)] = check_gather_kernel(shape, device)
    err = max(res[("ekf", s)][0] for s in (CORRIDOR_SHAPE, REAL_SHAPE))
    for shape, fill, flags in UPDATE_VARIANTS:
        err = max(err, check_update_kernel(shape, device, fill, timed=False, **flags)[0])
    res["gather_variants"] = check_gather_variants(device)
    res["gather_windows"] = check_gather_windows(device)
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
    # the resample is decided on the device: one gather a frame (the
    # identity where the ESS asks for none); the resamples from the metrics
    n_res = sum(r["resamples"])
    check(launches[1] == steps * len(seeds) and n_res > 0,
          f"gather launches {launches[1]} (frames {steps * len(seeds)}), resamples {n_res}")
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
    check(launches[0] == 30 and launches[1] == 30, f"real-size launches {launches}")


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
    # the twins take 0.1-4.2 s a call: few calls, to keep the script in its time
    reps_k, reps_t = (10, 3) if P <= 1024 else (5, 2)

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


def _with_resamples(run):
    """(run(), resamples): run() with the program's tracer on, so that the
    systems' metrics drains count the frames that resampled; run() ends
    with its systems' `flush_metrics()`."""
    from parakeet_slam_tpu_torch.utils import trace

    trace.reset()
    trace.enable()
    try:
        out = run()
    finally:
        trace.disable()
    return out, trace.counters().get("resamples", 0)


def _reset_counts_3d():
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d, propose_3d, resample_cuda

    ekf_update_3d.score_3d.launches = 0
    ekf_update_3d.measurement_update_3d.launches = 0
    resample_cuda.gather_state.launches = 0
    propose_3d.propose_3d.launches = 0


def _counts_3d():
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d, resample_cuda

    return (ekf_update_3d.score_3d.launches, ekf_update_3d.measurement_update_3d.launches,
            resample_cuda.gather_state.launches)


def _propose_launches(what, frames):
    """propose_3d's launches since `_reset_counts_3d`: one a frame on the
    FastSLAM 2.0 vision configurations."""
    from parakeet_slam_tpu_torch.kernels import propose_3d

    n = propose_3d.propose_3d.launches
    print(f"{what}: propose_3d launches {n} in {frames} frames")
    check(n == frames, f"{what}: propose_3d launches {n}, frames {frames}")
    return n


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
    from parakeet_slam_tpu_torch.eval import propose_check
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d, propose_3d, resample_cuda

    saved = (ekf_update_3d.measurement_update_3d, ekf_update_3d.score_3d,
             resample_cuda.gather_state, propose_3d.propose_3d)
    ekf_update_3d.measurement_update_3d = ekf_update_3d.measurement_update_3d_reference
    ekf_update_3d.score_3d = ekf_update_3d.score_3d_reference
    resample_cuda.gather_state = resample_cuda.gather_state_reference
    propose_3d.propose_3d = propose_check.twin

    def restore():
        (ekf_update_3d.measurement_update_3d, ekf_update_3d.score_3d,
         resample_cuda.gather_state, propose_3d.propose_3d) = saved

    return restore


def phase_propose(device):
    """The FastSLAM 2.0 proposal kernel against its twin, the refinement
    loop, bit for bit (`eval/propose_check.py`): each product, reduction
    and cross product of the loop against the kernel's order on the loop's
    own operands; `_propose` through both from filter states at kitti00's
    and config 2's shapes (refined and sampled poses, P_cov, log_w); every
    frame of the eager online system on rendered kitti00 and config 2
    frames; the crafted edge frame; one launch a frame graph replay; the
    kernel's device time against its twin's and its bound."""
    from parakeet_slam_tpu_torch.eval import propose_check

    for part in ("rules", "edges", "filter", "system", "capture"):
        propose_check.PARTS[part](device)
    return propose_check.part_time(device)


def phase_vision(device, frames=10, config="configs/kitti_00.yaml", check_frames=2):
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
    n_propose = _propose_launches("vision config 3", frames)
    peak = torch.cuda.max_memory_allocated()
    n_res = int(sum(bool(m.resampled) for m in metrics))
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
    check(launches[2] == frames, f"vision gather launches {launches[2]}, frames {frames}")

    # kernel path vs twin path over the first frames, from the same draws
    # (both eager: the captured path is held to the eager one in phase 19)
    noise, u0 = draw_noise(check_frames, P, slam.noise_dim, gen, device)
    short = [a[:check_frames] for a in data]
    kernel_final, kernel_est, _ = run_sequence(slam, state0, *short[:4], motion_noise=noise,
                                               resample_u0=u0, obs_desc=short[4], capture=False)
    restore = _twin_path()
    try:
        twin_final, twin_est, _ = run_sequence(slam, state0, *short[:4], motion_noise=noise,
                                               resample_u0=u0, obs_desc=short[4],
                                               capture=False)
    finally:
        restore()
    for k in ("lm_valid", "lm_count"):
        a, b = getattr(kernel_final, k), getattr(twin_final, k)
        check(torch.equal(a, b), f"vision kernel vs twin path: {k} differs in {int((a != b).sum())}")
    pose_err = float((kernel_est - twin_est).abs().max())
    print(f"vision kernel vs twin path, {check_frames} frames: lm_valid and lm_count equal "
          f"({int(kernel_final.lm_valid.sum())} live lanes), est max |diff| {pose_err:.3g}")
    return {"fps": frames / dt, "launches": launches, "propose_launches": n_propose, "ate": ate,
            "ate_dr": ate_dr, "peak_gib": peak / 2**30}


def phase_bench_rows(device):
    from parakeet_slam_tpu_torch.eval import bench_kernels

    return {r["kernel"]: r for r in bench_kernels.run(
        ["ekf_update_3d", "fs1_step", "fs2_step"], device)}


# --------------------------------------------------------------------------
# Slice 3: descriptor matching and the online monocular system
# --------------------------------------------------------------------------

L2_BENCH = (1024, 131072, 128)
DESK_WORLD_STEPS = 120  # two orbits of 60 frames: the second revisits the first
DESK_FRAMES = 90  # one and a half orbits: closures from frame ~40, the revisit from 60
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


def recording_dispatches(calls, verifies=None):
    """Make every `SLAMSystem._dispatch_loop_closure` append what it
    matched to `calls`: (query descriptors, validity, the store, its
    validity with the dispatch's eligibility mask, the forward and reverse
    tables it left pending, the ratio), for the replays through the twin
    (`phase_desk_replay`). On the card a dispatch replays its store shape's
    graph, so the record is taken at the dispatch, not inside the match.
    With `verifies`, every `SLAMSystem._verify_batch` appends its batch
    shape there. Returns the function that undoes the wraps."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import system

    dispatch = system.SLAMSystem._dispatch_loop_closure

    def recording(self, kf):
        n = len(self._closure_pending)
        dispatch(self, kf)
        if len(self._closure_pending) > n:
            _, n_old, fwd, rev = self._closure_pending[-1]
            db = self._kf_desc_dev
            eligible = torch.arange(db.shape[0], device=db.device) < n_old
            calls.append((torch.as_tensor(kf.desc.view(np.int32), device=db.device),
                          torch.as_tensor(kf.valid, device=db.device), db.clone(),
                          self._kf_valid_dev & eligible[:, None], fwd.clone(), rev.clone(),
                          self.cfg.frontend.match_ratio))

    verify = system.SLAMSystem._verify_batch

    def counting(self, pa, pb, valid):
        verifies.append(pa.shape)
        return verify(self, pa, pb, valid)

    def undo():
        system.SLAMSystem._dispatch_loop_closure = dispatch
        system.SLAMSystem._verify_batch = verify

    system.SLAMSystem._dispatch_loop_closure = recording
    if verifies is not None:
        system.SLAMSystem._verify_batch = counting
    return undo


def phase_desk(device, frames=DESK_FRAMES, config="configs/tum_fr1_desk.yaml"):
    """Benchmark config 2 at full width: `cli run`'s TUM loop over the
    in-memory desk world. Captures every keyframe-store match for phase 11."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import cli, system
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.data.synth_vision import make_desk_world
    from parakeet_slam_tpu_torch.kernels import horn, match

    cfg = load_config(os.path.join(HERE, config))
    fc, fe = cfg.filter, cfg.frontend
    world = make_desk_world(num_steps=DESK_WORLD_STEPS)
    check(tuple(world.image_size) == tuple(fe.image_size), f"world {world.image_size} vs {fe}")
    t0 = time.perf_counter()
    images = [world.render(i) for i in range(frames)]
    t_render = time.perf_counter() - t0
    odom = cli._make_odometry(cfg.data, world.gt_pose, frames)
    calls = []

    def run():
        def drive():
            sys_ = system.SLAMSystem(cfg, device=device)
            est, fps, wall = cli.run_image_sequence(sys_, images, odom)
            sys_.flush_flags()
            sys_.flush_metrics()
            return sys_, est, fps, wall

        (sys_, est, fps, wall), n_res = _with_resamples(drive)
        return sys_, est, fps, wall, n_res, sys_.graph.poses.cpu().numpy()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts_3d()
    match.hamming_top2.launches = 0
    horn.rotation_fit.launches = 0
    verifies = []
    restore = recording_dispatches(calls, verifies)
    try:
        sys_, est, fps, wall, n_res, graph_poses = run()
        launches = _counts_3d() + (match.hamming_top2.launches,)
        horn_launches = horn.rotation_fit.launches
        n_propose = _propose_launches("desk config 2", frames)
    finally:
        restore()
    # the state as the run left it (sequence_ate below verifies and solves
    # the last window's closures, as phase 19's eager run does after its
    # comparison of the states)
    state = {f: getattr(sys_.state, f).clone() for f in STATE_KEYS + ("lm_desc",)}
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
    est_opt, ates = cli.sequence_ate(sys_, est, world.gt_pose, odom, cfg)
    print(f"desk config 2 (FastSLAM 2.0 pinhole_3d P={fc.num_particles} L={fc.max_landmarks} "
          f"Z={fc.max_observations}, {fe.max_features} features {fe.image_size[1]}x"
          f"{fe.image_size[0]}): {frames} frames fps={fps:.3f} (steady, from frame 3) "
          f"wall={wall:.2f}s render={t_render:.2f}s peak_mem={peak / 2**30:.3f} GiB")
    print(f"desk config 2: keyframes={len(sys_.keyframes)} dispatches={len(calls)} "
          f"loop_closures={len(sys_.loop_closures)} resamples={n_res} "
          f"launches score_3d={launches[0]} update_3d={launches[1]} gather={launches[2]} "
          f"hamming_top2={launches[3]} rotation_fit={horn_launches} (verifies {len(verifies)})")
    print(f"desk config 2: ate corrected={ates[0]:.4f} m online={ates[1]:.4f} m "
          f"dead_reckoning={ates[2]:.4f} m (Sim(3), not gated)")
    check(bool(np.isfinite(est).all()) and bool(np.isfinite(est_opt).all()),
          "desk trajectory not finite")
    check(len(sys_.keyframes) >= 2, f"desk keyframes {len(sys_.keyframes)}")
    check(len(sys_.loop_closures) >= 1, "desk run accepted no closure: the repeat covers none")
    per = system.MATCH_LAUNCHES_PER_DISPATCH
    check(len(calls) >= 1 and launches[3] == per * len(calls),
          f"hamming_top2 launches {launches[3]}, dispatches {len(calls)} x {per}")
    check(launches[0] == frames and launches[1] == frames,
          f"desk launches score_3d={launches[0]} update_3d={launches[1]}, frames {frames}")
    check(launches[2] == frames and n_res > 0,
          f"desk gather launches {launches[2]} (frames {frames}), resamples {n_res}")
    check(verifies and horn_launches == HORN_ROUNDS * len(verifies),
          f"rotation_fit launches {horn_launches}, verifies {len(verifies)} x {HORN_ROUNDS}")
    return {"fps": fps, "launches": launches, "propose_launches": n_propose, "calls": calls,
            "ates": ates, "horn_launches": horn_launches,
            "closures": len(sys_.loop_closures), "peak_gib": peak / 2**30,
            "system": sys_, "est": est, "gt": world.gt_pose, "cfg": cfg, "images": images,
            "odom": odom, "graph_poses": graph_poses, "est_opt": est_opt,
            "state": state}


def phase_desk_replay(calls, what="desk"):
    """Every keyframe-store match of phase 10 (or of another run, named
    `what`) replayed through the twin: forward and reverse tables equal."""
    import torch

    from parakeet_slam_tpu_torch import system
    from parakeet_slam_tpu_torch.kernels import match

    kernel = match.hamming_top2
    match.hamming_top2 = match.hamming_top2_reference
    try:
        for i, (qd, qv, db, dbv, fwd, rev, ratio) in enumerate(calls):
            t_fwd, t_rev = system._batched_kf_match(qd, qv, db, dbv, ratio)
            for name, a, b in (("forward", fwd, t_fwd), ("reverse", rev, t_rev)):
                check(torch.equal(a, b), f"{what} replay {i} (K={db.shape[0]}): {name} table "
                      f"differs in {int((a != b).sum())} entries")
    finally:
        match.hamming_top2 = kernel
    n_match = sum(int((c[4] >= 0).sum()) + int((c[5] >= 0).sum()) for c in calls)
    print(f"{what} replay: {len(calls)} keyframe-store matches, forward and reverse tables "
          f"equal to the twin's ({n_match} matched entries)")


# --------------------------------------------------------------------------
# Slice 8: the stereo system of config 3, from images
# --------------------------------------------------------------------------

STEREO_FRAMES = 20
STEREO_PROFILE_FRAMES = 4   # frames 20-23: the first without a flush and the flush profiled
STEREO_CHECK_FRAME = 10
DISP_TIE_GAP = 1e-6   # relative gap of the two smallest SADs that excuses a flip
DISP_ATOL = 1e-5


def phase_stereo(device, frames=STEREO_FRAMES, config="configs/kitti_00.yaml"):
    """Benchmark config 3 at full width from images: the drive world written
    in the KITTI layout and run through `cli run`'s KITTI loop (loader,
    stereo frames, ATE)."""
    import shutil

    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import cli, system
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.data.synth_vision import make_drive_world, write_kitti_format
    from parakeet_slam_tpu_torch.frontend.stereo import keypoint_disparity, near_ties
    from parakeet_slam_tpu_torch.kernels import match

    cfg = load_config(os.path.join(HERE, config))
    fc, fe = cfg.filter, cfg.frontend
    check(fc.algorithm == "fastslam2" and fc.measurement_model == "stereo_3d",
          f"{config}: {fc.algorithm} {fc.measurement_model}")
    n_all = frames + STEREO_PROFILE_FRAMES
    out = os.path.join(HERE, "build", "chip_smoke_kitti")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    world = make_drive_world(num_steps=n_all)
    check(tuple(world.image_size) == tuple(fe.image_size), f"world {world.image_size} vs {fe}")
    cfg = load_config(os.path.join(HERE, config), {"data.path": write_kitti_format(world, out)})
    t_write = time.perf_counter() - t0
    left, right, gt, odom = cli.load_image_dataset(cfg, n_all)
    check(right is not None and len(odom) == n_all, "the KITTI loader gave no stereo pairs")

    dispatches = []
    sys_ = system.SLAMSystem(cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts_3d()
    match.hamming_top2.launches = 0
    restore = recording_dispatches(dispatches)

    def drive():
        out = cli.run_image_sequence(sys_, left, odom[:frames], right=right)
        sys_.flush_flags()
        sys_.flush_metrics()
        return out

    try:
        (est, fps, wall), n_res = _with_resamples(drive)
        launches = _counts_3d() + (match.hamming_top2.launches,)
        n_propose = _propose_launches("stereo config 3", frames)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    # the frontend runs inside the frame's graph: its observations again,
    # eagerly, from the same images
    pairs = [tuple(torch.as_tensor(f(i), device=device) for f in (left, right))
             for i in range(frames)]
    obs_per_frame = float(torch.stack([sys_._stereo_observation(*p).valid.sum()
                                       for p in pairs]).float().mean())
    lm = float(sys_.state.lm_valid.sum(dim=1).float().mean())
    est_opt, ates = cli.sequence_ate(sys_, est, gt, odom[:frames], cfg)
    print(f"stereo config 3 from images (FastSLAM 2.0 stereo_3d P={fc.num_particles} "
          f"L={fc.max_landmarks} Z={fc.max_observations}, {fe.max_features} features "
          f"{fe.image_size[1]}x{fe.image_size[0]}): {frames} frames written in the KITTI layout "
          f"in {t_write:.2f}s, fps={fps:.3f} (steady, from frame 3) wall={wall:.2f}s "
          f"peak_mem={peak / 2**30:.3f} GiB")
    print(f"stereo config 3: disparity-valid observations {obs_per_frame:.2f} per frame, "
          f"landmarks/particle={lm:.1f} keyframes={len(sys_.keyframes)} "
          f"dispatches={len(dispatches)} loop_closures={len(sys_.loop_closures)} "
          f"resamples={n_res} launches score_3d={launches[0]} update_3d={launches[1]} "
          f"gather={launches[2]} hamming_top2={launches[3]}")
    print(f"stereo config 3: ate corrected={ates[0]:.4f} m online={ates[1]:.4f} m "
          f"dead_reckoning={ates[2]:.4f} m (SE(3), not gated)")
    check(bool(np.isfinite(est).all()) and bool(np.isfinite(est_opt).all()),
          "stereo trajectory not finite")
    check(launches[0] == frames and launches[1] == frames,
          f"stereo launches score_3d={launches[0]} update_3d={launches[1]}, frames {frames}")
    check(launches[2] == frames, f"stereo gather launches {launches[2]}, frames {frames}")
    check(launches[3] == system.MATCH_LAUNCHES_PER_DISPATCH * len(dispatches),
          f"stereo hamming_top2 launches {launches[3]}, dispatches {len(dispatches)}")
    check(obs_per_frame >= 1.0, f"stereo: {obs_per_frame} disparity-valid observations a frame")
    check(lm > 0, "stereo: no landmarks")

    # one frame's disparity on the card against the same on the CPU
    img_l, img_r = pairs[STEREO_CHECK_FRAME]
    xy, _, valid = sys_._frontend(img_l)
    args = (img_l, img_r, xy[:fc.max_observations], valid[:fc.max_observations])
    disp, ok = (t.cpu().numpy() for t in keypoint_disparity(*args))
    c_disp, c_ok = (t.numpy() for t in keypoint_disparity(*(t.cpu() for t in args)))
    same = (ok == c_ok) & (np.abs(disp - c_disp) <= DISP_ATOL)
    ties = near_ties(img_l.cpu().numpy(), img_r.cpu().numpy(), args[2].cpu().numpy(),
                     gap=DISP_TIE_GAP)
    print(f"stereo keypoint_disparity frame {STEREO_CHECK_FRAME}, card against CPU: "
          f"{int(ok.sum())} of {len(ok)} valid, masks and disparities (within {DISP_ATOL}) equal "
          f"but {int((~same).sum())}, near-ties (SAD gap <= {DISP_TIE_GAP}) {int(ties.sum())}, "
          f"max |diff| {float(np.abs(disp - c_disp).max()):.3g}")
    check(bool((same | ties).all()), f"stereo disparity: keypoints {np.where(~(same | ties))[0]} "
          "differ between card and CPU and are no near-ties")

    # the same frames through the eager twin: bit for bit the same run
    eager = system.SLAMSystem(cfg, device=device, capture=False)
    est_e, fps_e, _ = cli.run_image_sequence(eager, left, odom[:frames], right=right)
    eager.flush_flags()
    eager.flush_metrics()
    _same_system("config 3 from images", sys_, eager, est, est_e)
    bad = ~torch.isfinite(sys_.state.lm_mean).all(-1)
    print(f"stereo config 3 captured vs eager, {frames} frames: estimates, every state leaf "
          f"(non-finite lm_mean lanes in both: {int(bad.sum())}, "
          f"{int((bad & sys_.state.lm_valid).sum())} of them valid), graph poses, keyframes "
          f"({len(eager.keyframes)}) and closures "
          f"({len(eager.loop_closures)}) bit-equal; frames/s captured {fps:.3f}, eager "
          f"{fps_e:.3f}; {_pool_facts(sys_)}")

    # where a frame's time goes: the next frames, a frame without a flush
    # and a flush frame under the profiler, captured and eager; the
    # frontend (detect, describe, disparity) alone
    split = {mode: _frame_split("config 3 from images", mode, s_, lambda s2, i: (
        s2.process_stereo_frame(left(i), right(i), odom[i])), range(frames, n_all),
        host=mode == "captured") for mode, s_ in (("captured", sys_), ("eager", eager))}
    del eager
    fe_ms = []
    for i in range(frames, n_all):
        img_l = torch.as_tensor(left(i), device=device)
        img_r = torch.as_tensor(right(i), device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        xy, _, valid = sys_._frontend(img_l)
        keypoint_disparity(img_l, img_r, xy[:fc.max_observations], valid[:fc.max_observations])
        torch.cuda.synchronize()
        fe_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"stereo profile: the eager frontend alone {np.mean(fe_ms):.2f} ms a frame (host "
          "clock)")
    shutil.rmtree(out, ignore_errors=True)
    return {"fps": fps, "fps_eager": fps_e, "launches": launches, "propose_launches": n_propose,
            "ates": ates,
            "peak_gib": peak / 2**30, "obs_per_frame": obs_per_frame, "split": split}


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

    n0 = schur.apply_cinv.launches
    got = schur.apply_cinv(C, u)
    ref = schur.apply_cinv_reference(C, u)
    torch.cuda.synchronize()
    check(schur.apply_cinv.launches == n0 + 1, f"apply_cinv {what}: the kernel was not launched")
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
    # the bench shape, a bucket, and Ns that fill no whole block of threads
    for n in (CINV_BENCH, CINV_BENCH + 3, CINV_BUCKET, CINV_BUCKET + 3, 1, 3, 1000, 1001):
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
    # a bucket of the solver: one operand set, which stays in L2 as the
    # solver's bucket does across its PCG iterations
    small = tuple(T(a) for a in schur_blocks(CINV_BUCKET, seed=5))
    ms_bucket = queued_ms(lambda i: schur.apply_cinv(*small))
    print(f"apply_cinv N={CINV_BENCH}: kernel={ms:.5f} ms ({nbytes(C, u, u) / ms / 1e9:.3f} TB/s "
          f"of C, u and y as laid out) twin={plain:.5f} ms linalg.solve_ex={lib:.5f} ms "
          f"(max |solve - kernel| {lib_err:.3g}) bound={bnd[0]:.5f} ms ({bnd[1]}, upper "
          f"triangle of C; {bnd_laid_out[0]:.5f} ms with all 36 B of a block); "
          f"N={CINV_BUCKET}: kernel={ms_bucket:.5f} ms")
    return {"err": err, "ms": ms, "plain": plain, "library": lib, "bound": bnd,
            "bound_laid_out": bnd_laid_out[0], "ms_bucket": ms_bucket}


def _profile(fn, api=None, names=None, host=False):
    """(launches, device busy ms, wall ms, the five device activities with
    the most time as (name, ms, count)) of fn() under torch.profiler,
    recording the device's activity only (with the host's ops recorded as
    well, the stereo phase took 117.9 s in one call; with the device's
    alone, 51.8 s in the next). `api`, a list, receives the number of host
    CUDA runtime and driver calls the profile holds (`_is_api`), `names`, a
    dict, the count of each host event by name; `host` records the host's
    activity as well."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev, "torch.profiler recorded no device activity")
    if api is not None:
        api.append(sum(1 for e in events if e.device_type != torch.autograd.DeviceType.CUDA
                       and _is_api(e.name)))
    if names is not None:
        for e in events:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(((name, ms, n) for name, (ms, n) in by_name.items()), key=lambda r: -r[1])[:5]
    return len(dev), sum(e.time_range.elapsed_us() for e in dev) / 1e3, wall, top


def _is_api(name):
    """A CUDA runtime or driver call's name (cudaLaunchKernel, cuLaunchKernel...)."""
    import re

    return re.match(r"cu[A-Z]|cuda[A-Z]", name) is not None


def _ba_results(r):
    return (r.costs, r.pcg_residuals, r.problem.cam_pose, r.problem.points)


def phase_ba(device):
    """Bundle adjustment at full width with configs/euroc_mh.yaml's backend:
    the captured solve (one CUDA graph an LM iteration) against the eager
    twin (`capture=False`) in turns, bit for bit; the kernel path against
    the twin path; profiles of both."""
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
    # warm-ups: cuBLAS handles, the allocator; the captured solver's first
    # iteration runs eagerly, its second captures the graph
    ba.optimize_ba(cam, bk, iters=1, capture=False, **kw)
    solver = ba.captured_solver(device)
    before = set(solver.steps)
    ba.optimize_ba(cam, bk, iters=2, **kw)
    (key,) = set(solver.steps) - before
    step = solver.steps[key]
    check(step._graph is not None, "ba: the LM iteration was not captured")
    want = be.gn_iters * len(shapes) * (be.pcg_iters + 3)
    runs, ms, peak = {}, {"captured": [], "eager": []}, 0
    for mode in ("eager", "captured", "captured", "eager"):  # in turns
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        schur.apply_cinv.launches = 0
        t0 = time.perf_counter()
        res = ba.optimize_ba(cam, bk, iters=be.gn_iters, capture=mode == "captured", **kw)
        costs = res.costs.cpu()
        ms[mode].append((time.perf_counter() - t0) / be.gn_iters * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated())
        check(schur.apply_cinv.launches == want,
              f"ba {mode}: apply_cinv launches {schur.apply_cinv.launches} != {be.gn_iters} x "
              f"{len(shapes)} x ({be.pcg_iters} + 3) = {want}")
        if mode in runs:
            check(all(_bit_equal(a, b) for a, b in zip(_ba_results(res), _ba_results(runs[mode]))),
                  f"ba {mode} is not repeatable")
        runs[mode] = res
    launches = want
    check(all(_bit_equal(a, b) for a, b in zip(_ba_results(runs["captured"]),
                                               _ba_results(runs["eager"]))),
          "ba full width: captured vs eager costs, pcg residuals, poses or points differ")
    res, costs = runs["captured"], runs["captured"].costs.cpu()
    print(f"ba full width (C={prob.num_cams} points={prob.num_points} obs={prob.num_obs}, "
          f"buckets {shapes}, packed in {t_pack:.2f} s; lam0={be.lm_damping_init} "
          f"iters={be.gn_iters} pcg_iters={be.pcg_iters} huber={be.huber_delta}): ms per LM "
          f"iteration captured {[round(t, 2) for t in ms['captured']]} eager "
          f"{[round(t, 2) for t in ms['eager']]} (in turns, host clock over the solve), "
          f"peak_mem={peak / 2**30:.3f} GiB, apply_cinv launches={launches} a solve")
    print(f"ba full width captured vs eager: {be.gn_iters} LM x {be.pcg_iters} PCG, costs, pcg "
          f"residuals, poses and points bit-equal; capture {step.capture_s:.3f} s, instantiate "
          f"{step.instantiate_s:.3f} s, the graph's pool {step.pool_bytes / 2**20:.1f} MiB, "
          f"launches counted per replay {step.launches_per_replay}")
    print(f"ba full width: cost {cost0:.1f} -> {float(costs[0]):.1f} -> {float(costs[-1]):.1f}, "
          f"accepted {int((costs[1:] < costs[:-1]).sum()) + int(costs[0] < cost0)} of "
          f"{be.gn_iters}, last pcg residual {float(res.pcg_residuals[-1]):.3g}")
    check(bool(torch.isfinite(costs).all()), f"ba costs not finite: {costs}")
    check(float(costs[-1]) < cost0 and float(costs[-1]) <= float(costs[0]),
          f"ba cost did not fall: {cost0} -> {costs}")
    check(bool(torch.isfinite(res.problem.cam_pose).all() & torch.isfinite(res.problem.points).all()),
          "ba result not finite")

    # the first iterations again, the kernel path against the twin path (both eager)
    kernel = ba.optimize_ba(cam, bk, iters=BA_TWIN_ITERS, capture=False, **kw)
    dispatch = schur.cinv_apply
    schur.cinv_apply = schur.apply_cinv_reference
    try:
        n0 = schur.apply_cinv.launches
        twin = ba.optimize_ba(cam, bk, iters=BA_TWIN_ITERS, capture=False, **kw)
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

    # where an LM iteration's time goes: the captured solve's iterations
    # are replays (one graph launch each), profiled with the host's calls
    n_prof = 2
    prof = {}
    for mode in ("captured", "eager"):
        names = {}
        n_launch, busy, wall, top = _profile(
            lambda: ba.optimize_ba(cam, bk, iters=n_prof, capture=mode == "captured", **kw),
            names=names, host=mode == "captured")
        unprofiled = min(ms[mode])
        prof[mode] = {"launches": n_launch / n_prof, "busy_ms": busy / n_prof,
                      "wall_ms": wall / n_prof, "idle": 1 - busy / n_prof / unprofiled,
                      "graph_launches": names.get("cudaGraphLaunch", 0) / n_prof,
                      "api_calls": sum(n for k, n in names.items() if _is_api(k)
                                       and k != "cudaDeviceSynchronize") / n_prof}
        p_ = prof[mode]
        print(f"ba profile {mode}, {n_prof} LM iterations: {p_['launches']:.0f} device launches, "
              f"device busy {p_['busy_ms']:.2f} ms, wall {p_['wall_ms']:.1f} ms per iteration "
              f"with the profiler on; idle share {1 - busy / wall:.3f} with it, "
              f"{p_['idle']:.3f} against the best unprofiled {unprofiled:.1f} ms"
              + (f"; {p_['graph_launches']:.1f} graph launches and {p_['api_calls']:.1f} host "
                 f"CUDA API calls per iteration (the solve's own copies included)"
                 if mode == "captured" else ""))
        for name, t, n in top:
            print(f"ba profile {mode}:   {t / n_prof:8.2f} ms {n / n_prof:7.0f} launches per "
                  f"iteration  {name[:90]}")
    check(prof["captured"]["graph_launches"] == 1,
          f"ba: {prof['captured']['graph_launches']} graph launches per LM iteration")
    bench_kernels.run(["schur", "ba_iteration"], device)
    return {"launches": launches, "per_iter_ms": ms, "costs": costs.tolist(),
            "peak_gib": peak / 2**30, "profile": prof,
            "graph": {"capture_s": step.capture_s, "instantiate_s": step.instantiate_s,
                      "pool_bytes": step.pool_bytes}}


def phase_run_ba(desk):
    """`run_ba()` on the config 2 system that phase 10 left (captured: the
    dedup's keyframe steps and the LM iteration replay graphs) against an
    eager twin loaded from a snapshot of it: the dedup's ids, store and
    counts, the solve's costs, residuals, poses and points and the keyframe
    poses bit-equal; the dedup again under the profiler (one graph launch a
    keyframe); the dedup replayed through `hamming_top2`'s twin."""
    import shutil

    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import system
    from parakeet_slam_tpu_torch.eval import ate_rmse
    from parakeet_slam_tpu_torch.kernels import match, schur

    sys_, est, gt = desk["system"], desk["est"], desk["gt"]
    # Phase 19 ran more frames on this system and may have left keyframe
    # flags and closure matches pending: one flush materializes the flagged
    # keyframes and dispatches their matches, the next verifies them, so
    # that run_ba's own flush launches nothing but the dedup.
    sys_.flush_flags()
    sys_.flush_flags()
    logged = []
    sys_.metrics.log = lambda frame, **rec: logged.append(rec)
    out = os.path.join(HERE, "build", "chip_smoke_run_ba")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    sys_.save_checkpoint(os.path.join(out, "snap"))
    eager = system.SLAMSystem(desk["cfg"], device=sys_.device, capture=False)
    eager.load_checkpoint(os.path.join(out, "snap"))
    eager.metrics.log = lambda frame, **rec: None
    dedup, assign = [], system._assign_point_ids

    def recording(desc, valid, world, *, cap, max_ham, **kw):
        res = assign(desc, valid, world, cap=cap, max_ham=max_ham, **kw)
        dedup.append(((desc, valid, world), {"cap": cap, "max_ham": max_ham}, res))
        return res

    match.hamming_top2.launches = 0
    schur.apply_cinv.launches = 0
    system._assign_point_ids = recording
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        res = sys_.run_ba(iters=BA_SYSTEM_ITERS)
        costs = res.costs.cpu()
        dt = time.perf_counter() - t0
        launches = (match.hamming_top2.launches, schur.apply_cinv.launches)
        t0 = time.perf_counter()
        twin = eager.run_ba(iters=BA_SYSTEM_ITERS)
        twin.costs.cpu()
        dt_eager = time.perf_counter() - t0
    finally:
        system._assign_point_ids = assign
    check(len(dedup) == 2, f"run_ba deduplicated {len(dedup)} times")
    K = dedup[0][0][0].shape[0]
    for name, a, b in zip(("store descriptors", "store_valid", "store positions", "count",
                           "dropped", "pid"), (*dedup[0][2][0], dedup[0][2][1]),
                          (*dedup[1][2][0], dedup[1][2][1])):
        check(_bit_equal(a, b), f"run_ba dedup: captured vs eager {name} differs")
    check(all(_bit_equal(a, b) for a, b in zip(_ba_results(res), _ba_results(twin))),
          "run_ba: captured vs eager costs, pcg residuals, poses or points differ")
    check([k.pose.tobytes() for k in sys_.keyframes] == [k.pose.tobytes() for k in eager.keyframes],
          "run_ba: captured vs eager keyframe poses differ")
    names = {}
    _profile(lambda: sys_.build_ba_problem(), names=names, host=True)
    dedup_graphs = names.get("cudaGraphLaunch", 0)
    ba_steps = list(sys_._ba_solver.steps.values())
    print(f"run_ba captured vs eager (a snapshot of phase 10's system loaded into an eager "
          f"one): dedup ids, store and counts, costs, pcg residuals, poses, points and keyframe "
          f"poses bit-equal; {dt:.3f} s captured, {dt_eager:.3f} s eager; the dedup again "
          f"under the profiler: {dedup_graphs} graph launches for {K} keyframes; "
          f"{len(ba_steps)} BA graph(s), pool grew by "
          f"{sum(c.pool_bytes for c in ba_steps) / 2**20:.1f} MiB")
    check(dedup_graphs == K, f"run_ba dedup: {dedup_graphs} graph launches, {K} keyframes")
    del eager, twin

    # The point dedup again through the twin: one match per keyframe against
    # the store as the kernel path left it after the keyframes before, so a
    # wrong match anywhere changes the ids, the store or the counts.
    args, kw, ((sd, sv, sp, cnt, drop), pid) = dedup[0]
    kernel = match.hamming_top2
    n0 = kernel.launches
    match.hamming_top2 = match.hamming_top2_reference
    try:
        (t_sd, t_sv, t_sp, t_cnt, t_drop), t_pid = assign(*args, **kw)
    finally:
        match.hamming_top2 = kernel
    check(match.hamming_top2.launches == n0, "the twin dedup launched the kernel")
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
    return {"launches": launches, "seconds": dt, "seconds_eager": dt_eager, "ate": ate,
            "dedup_graphs": dedup_graphs}


# --------------------------------------------------------------------------
# Slice 9: checkpoints and the multi-session run of config 4
# --------------------------------------------------------------------------

EUROC_SESSIONS = 2
EUROC_FRAMES = 30        # of each session (the world's trajectory is 400)
EUROC_WORLD_STEPS = 400  # the hall world's own length, so a frame moves as far
RESUME_CUT = 17          # inside a flag window (kf_flag_lag = 4)
EUROC_CHECK_FRAMES = 3   # session one's first frames, kernel path against the twin path
EUROC_PROFILE_FRAMES = 3  # the resumed run's last frames, profiled


def _snapshot_diff(a, b):
    """Names of the arrays that differ between two snapshots (prefixes)."""
    import numpy as np

    out = []
    for ext in (".state.npz", ".kf.npz"):
        with np.load(a + ext) as x, np.load(b + ext) as y:
            if sorted(x.files) != sorted(y.files):
                out.append(f"{ext} keys")
                continue
            keys = [str(k) for k in x["__keys__"]] if ext == ".state.npz" else None
            for f in x.files:
                if not np.array_equal(x[f], y[f]):
                    name = keys[int(f[5:])] if keys and f.startswith("leaf_") else f
                    out.append(f"{ext}:{name}")
    return out


def phase_config4(device):
    """Benchmark config 4 at full width: two sessions of the machine hall
    written in the ASL layout and run through `cli run`'s multi-session
    runner (checkpoint round trip at the boundary, joint BA); then session
    one resumed from a snapshot at frame RESUME_CUT, bit for bit."""
    import argparse
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import cli, system
    from parakeet_slam_tpu_torch.backend import graph
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.data.euroc import load_multi_session
    from parakeet_slam_tpu_torch.data.synth_vision import make_hall_world, write_euroc_format
    from parakeet_slam_tpu_torch.eval import ate_rmse
    from parakeet_slam_tpu_torch.filter.runner import draw_noise
    from parakeet_slam_tpu_torch.kernels import match, resample, schur

    config = "configs/euroc_mh.yaml"
    out = os.path.join(HERE, "build", "chip_smoke_euroc")
    ckpt_dir = os.path.join(out, "ckpt")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config(os.path.join(HERE, config), {"data.path": out, "checkpoint_dir": ckpt_dir})
    fc, fe, be = cfg.filter, cfg.frontend, cfg.backend
    check((fc.algorithm, fc.measurement_model, fc.num_particles, fc.max_landmarks,
           fc.max_observations, fc.desc_words) == ("fastslam2", "pinhole_3d", 512, 4096, 64, 8)
          and tuple(fe.image_size) == (480, 752) and fe.max_features == 512
          and (be.max_keyframes, be.max_landmarks, be.max_observations) == (1024, 51200, 262144)
          and (be.gn_iters, be.pcg_iters, be.lm_damping_init) == (20, 100, 1.0),
          f"{config} is not config 4 at full width: {fc} {fe} {be}")
    t0 = time.perf_counter()
    for s in range(EUROC_SESSIONS):
        w = make_hall_world(num_steps=EUROC_WORLD_STEPS, session=s)
        w = dataclasses.replace(w, gt_pose=w.gt_pose[:EUROC_FRAMES], odom=w.odom[:EUROC_FRAMES])
        check(tuple(w.image_size) == tuple(fe.image_size), f"world {w.image_size} vs {fe}")
        write_euroc_format(w, os.path.join(out, f"MH{s + 1:02d}"))
    t_write = time.perf_counter() - t0
    os.makedirs(ckpt_dir)
    roots = cli.euroc_sessions(out)
    check(len(roots) == EUROC_SESSIONS, f"sessions found: {roots}")

    # the multi-session run, counted; every closure dispatch, the BA's dedup
    # and the last resample captured for the replays through the twins below
    dispatches, dedups, gathers = [], [], []
    assign = system._assign_point_ids
    gather = resample.gather_particles

    def counting_assign(desc, valid, world, *, cap, max_ham, **kw):
        out = assign(desc, valid, world, cap=cap, max_ham=max_ham, **kw)
        dedups.append(((desc.clone(), valid.clone(), world.clone()),
                       {"cap": cap, "max_ham": max_ham}, out))
        return out

    def capturing_gather(st, idx):
        gathers[:] = [(dataclasses.replace(
            st, **{f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)}),
            idx.clone())]
        return gather(st, idx)

    args = argparse.Namespace(frames=0, ba=0, out="")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts_3d()
    match.hamming_top2.launches = 0
    schur.apply_cinv.launches = 0
    restore = recording_dispatches(dispatches)
    system._assign_point_ids = counting_assign
    resample.gather_particles = capturing_gather
    t0 = time.perf_counter()
    try:
        run, n_res = _with_resamples(
            lambda: cli._run_euroc_multisession(cfg, args, roots, device))
        torch.cuda.synchronize()
        launches = _counts_3d() + (match.hamming_top2.launches, schur.apply_cinv.launches)
    finally:
        restore()
        system._assign_point_ids = assign
        resample.gather_particles = gather
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    sys_, est, gt = run["system"], run["est"], run["gt"]
    res, prob, ba_s = run["ba"]
    costs = res.costs.cpu()
    n_frames = EUROC_SESSIONS * EUROC_FRAMES
    per = run["sessions"]
    n_kf1 = per[0]["keyframes"]
    lc = sys_.loop_closures
    within = (sum(1 for a, b in lc if b < n_kf1), sum(1 for a, b in lc if a >= n_kf1))
    across = sum(1 for a, b in lc if a < n_kf1 <= b)
    nb = len(graph.pack_buckets(prob).p_cam)
    want_cinv = 2 * be.gn_iters * nb * (be.pcg_iters + 3)  # joint_ba solves twice
    bd = per[1]["boundary"]
    print(f"euroc config 4 (FastSLAM 2.0 pinhole_3d P={fc.num_particles} L={fc.max_landmarks} "
          f"Z={fc.max_observations}, {fe.max_features} features {fe.image_size[1]}x"
          f"{fe.image_size[0]}; {EUROC_SESSIONS} sessions x {EUROC_FRAMES} frames of the hall "
          f"world written in the ASL layout in {t_write:.2f}s): fps "
          f"{' / '.join(f'{r['fps']:.3f}' for r in per)} (steady, from frame 3 of each session) "
          f"wall={wall:.2f}s peak_mem={peak / 2**30:.3f} GiB")
    print(f"euroc config 4: keyframes {' / '.join(str(r['keyframes']) for r in per)} (at each "
          f"session's end), dispatches={len(dispatches)} loop_closures={len(lc)} (within "
          f"sessions {within[0]} / {within[1]}, across {across}) resamples={n_res}; snapshot at "
          f"the boundary: save {bd['save_s']:.3f} s, load {bd['load_s']:.3f} s, "
          f"{bd['bytes'] / 1e6:.1f} MB")
    print(f"euroc config 4 joint BA: {len(sys_.keyframes)} keyframes, "
          f"{int(prob.pt_valid.sum())} points, {int(prob.obs_valid.sum())} observations, "
          f"{nb} buckets; {len(costs)} LM iterations warm in {ba_s:.3f} s "
          f"({ba_s / len(costs):.4f} s per iteration); cost {float(costs[0]):.1f} -> "
          f"{float(costs[-1]):.1f}")
    print(f"euroc config 4 launches: score_3d={launches[0]} update_3d={launches[1]} "
          f"gather={launches[2]} hamming_top2={launches[3]} (2 x {len(dispatches)} dispatches + "
          f"{sum(len(d[0][0]) for d in dedups)} keyframes deduplicated) apply_cinv={launches[4]} "
          f"(2 solves x {be.gn_iters} x {nb} x ({be.pcg_iters} + 3))")
    ok = ~np.isnan(gt[:, :3]).any(axis=1)
    dr = cli._dead_reckoning(gt[ok][0], run["odom"])
    trajs = {"online": est, "corrected": run["est_corrected"], "after BA": run["est_ba"],
             "dead reckoning": dr}
    for scale, name in ((False, "SE(3)"), (True, "Sim(3)")):
        ates = {k: float(ate_rmse(v[ok, :3], gt[ok, :3], with_scale=scale))
                for k, v in trajs.items()}
        print(f"euroc config 4 ate {name} (not gated): "
              + " ".join(f"{k}={v:.4f} m" for k, v in ates.items()))
    check(all(bool(np.isfinite(v).all()) for v in trajs.values()), "config 4 trajectory not finite")
    check(len(est) == n_frames, f"config 4 estimated {len(est)} of {n_frames} frames")
    check(n_kf1 >= 2 and per[1]["keyframes"] - n_kf1 >= 2,
          f"config 4 keyframes per session: {n_kf1}, {per[1]['keyframes'] - n_kf1}")
    check(bool(torch.isfinite(costs).all()) and float(costs[-1]) <= float(costs[0]),
          f"config 4 joint BA costs {costs}")
    check(launches[0] == n_frames and launches[1] == n_frames,
          f"config 4 launches score_3d={launches[0]} update_3d={launches[1]}, frames {n_frames}")
    check(launches[2] == n_frames, f"config 4 gather launches {launches[2]}, frames {n_frames}")
    dedup_rows = [len(d[0][0]) for d in dedups]
    check(dedup_rows == [len(sys_.keyframes)],
          f"config 4 dedup rows {dedup_rows}, keyframes {len(sys_.keyframes)}")
    check(launches[3] == system.MATCH_LAUNCHES_PER_DISPATCH * len(dispatches) + dedup_rows[0],
          f"config 4 hamming_top2 launches {launches[3]}, dispatches {len(dispatches)}, "
          f"dedup {dedup_rows}")
    check(launches[4] == want_cinv, f"config 4 apply_cinv launches {launches[4]} != {want_cinv}")
    # the joint BA's eager twin on the same problem, warm as `cli.joint_ba`
    # times the captured one
    sys_.capture = False  # solve_ba's twin; nothing else runs meanwhile
    try:
        sys_.solve_ba(prob)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twin = sys_.solve_ba(prob)
        twin.costs.cpu()
        twin_s = time.perf_counter() - t0
    finally:
        sys_.capture = True
    check(all(_bit_equal(a, b) for a, b in (
        (res.costs, twin.costs), (res.pcg_residuals, twin.pcg_residuals),
        (res.problem.cam_pose, twin.problem.cam_pose), (res.problem.points, twin.problem.points))),
        "config 4 joint BA: captured vs eager differ")
    ba_steps = list(sys_._ba_solver.steps.values())
    print(f"euroc config 4 joint BA captured vs eager: costs, pcg residuals, poses and points "
          f"bit-equal; {ba_s / len(costs) * 1e3:.3f} ms per LM iteration captured (one graph "
          f"launch each), {twin_s / len(costs) * 1e3:.3f} ms eager (warm solves, host clock); "
          f"{len(ba_steps)} BA graph(s), capture {sum(c.capture_s for c in ba_steps):.3f} s, "
          f"instantiate {sum(c.instantiate_s for c in ba_steps):.3f} s, pool grew by "
          f"{sum(c.pool_bytes for c in ba_steps) / 2**20:.1f} MiB")

    # The kernels against their twins at config 4's own shapes and data:
    # every closure dispatch (forward and reverse tables) and the BA's dedup
    # (store, point ids, counts) replayed through hamming_top2's twin; the
    # last resample's gather (the 512 x 4096 state with its descriptor
    # rows) against gather_state's twin; and session one's first frames run
    # on the kernel path and on the twin path from the same draws.
    phase_desk_replay(dispatches, "config 4 closure")
    ham = match.hamming_top2
    match.hamming_top2 = match.hamming_top2_reference
    try:
        for i, (args_, kw, out_) in enumerate(dedups):
            twin_out = assign(*args_, **kw)
            for name, a, b in zip(("store_desc", "store_valid", "store_pos", "count", "dropped",
                                   "pid"), (*out_[0], out_[1]), (*twin_out[0], twin_out[1])):
                check(torch.equal(a, b), f"config 4 dedup {i}: {name} differs from the twin's "
                      f"in {int((a != b).sum())}")
    finally:
        match.hamming_top2 = ham
    print(f"config 4 dedup replay: {dedup_rows[0]} keyframes against the point store, store, "
          f"point ids and counts equal to the twin's ({int(dedups[0][2][0][3])} points)")
    check(n_res > 0 and len(gathers) == 1,
          f"config 4 ran {n_res} resamples, {len(gathers)} captured")
    # the last frame's gather: its clones were captured into the graph with
    # the gather, so they hold the last replay's state and indices
    st, idx = gathers[0]
    check_gather_equal(f"config 4 state P={st.num_particles} L={st.lm_valid.shape[1]}", st, idx)
    print(f"gather_rows config 4 last frame (P={st.num_particles} L={st.lm_valid.shape[1]} "
          f"W={st.lm_desc.shape[-1]}, {len(set(idx.tolist()))} distinct rows): bit-equal")
    del st, idx, gathers[:]

    # Resume on the card: session one's first RESUME_CUT frames, a snapshot,
    # a fresh system that loads it and runs the rest of the session; its
    # snapshot after the last frame equals the boundary snapshot of the
    # uninterrupted run above in every array (filter state, graph and
    # cursors, generator, keyframes and anchors, closures, the pending flag
    # window and closure matches), and its estimates equal the run's. The
    # first system runs on to a second cut inside a flag window with closure
    # matches pending, where the session has one, resumed the same way.
    seq = load_multi_session(roots[:1])[0]
    odom = cli._make_odometry(cfg.data, seq.gt_pose, EUROC_FRAMES)
    gen = torch.Generator(device=device).manual_seed(0)
    noise, u0 = draw_noise(EUROC_CHECK_FRAMES, fc.num_particles, sys_.slam.noise_dim, gen, device)
    draws = list(zip(noise, u0))

    def short_run():
        s = system.SLAMSystem(cfg, device=device, capture=False)
        e, _, _ = cli.run_image_sequence(s, seq.image, odom[:EUROC_CHECK_FRAMES], draws=draws)
        return s.state, e

    kernel_state, kernel_est = short_run()
    restore = _twin_path()
    try:
        twin_state, twin_est = short_run()
    finally:
        restore()
    for k in ("lm_valid", "lm_count"):
        a, b = getattr(kernel_state, k), getattr(twin_state, k)
        check(torch.equal(a, b), f"config 4 kernel vs twin path: {k} differs in "
              f"{int((a != b).sum())}")
    print(f"config 4 kernel vs twin path, {EUROC_CHECK_FRAMES} frames of session one: lm_valid "
          f"and lm_count equal ({int(kernel_state.lm_valid.sum())} live lanes), est max |diff| "
          f"{float(abs(kernel_est - twin_est).max()):.3g}")
    del kernel_state, twin_state
    first = system.SLAMSystem(cfg, device=device)
    cli.run_image_sequence(first, seq.image, odom[:RESUME_CUT])
    cuts = {}

    def snapshot(s):
        prefix = os.path.join(ckpt_dir, f"resume_{s.frame_idx:02d}")
        s.save_checkpoint(prefix)
        cuts[s.frame_idx] = (prefix, len(s._flag_pending), len(s._closure_pending))

    snapshot(first)
    for i in range(RESUME_CUT, EUROC_FRAMES - 1):
        first.process_frame(seq.image(i), odom[i])
        if first._closure_pending and first.frame_idx % first.kf_flag_lag:
            snapshot(first)
            break
    del first
    prof = None
    for c, (prefix, n_flags, n_matches) in cuts.items():
        resumed = system.SLAMSystem(cfg, device=device)
        resumed.load_checkpoint(prefix)
        k = EUROC_FRAMES - EUROC_PROFILE_FRAMES if prof is None else EUROC_FRAMES
        est_r, _, _ = cli.run_image_sequence(resumed, lambda i: seq.image(c + i), odom[c:k])
        if prof is None:  # the session's last frames under the profiler
            tail = []
            prof = k, _profile(lambda: tail.extend(
                resumed.process_frame(seq.image(i), odom[i]) for i in range(k, EUROC_FRAMES)))
            est_r = np.concatenate([est_r, torch.stack(tail).cpu().numpy()])
        end = prefix + "_end"
        resumed.save_checkpoint(end)
        differ = _snapshot_diff(end, os.path.join(ckpt_dir, "session_01"))
        same_est = np.array_equal(est_r, est[c:EUROC_FRAMES])
        verdict = "equal in every array" if not differ else f"differs: {differ}"
        print(f"euroc config 4 resume: snapshot at frame {c} (pending flags {n_flags}, closure "
              f"matches {n_matches}), frames {c}-{EUROC_FRAMES - 1} in a fresh system: estimates "
              f"{'bit-equal' if same_est else 'differ'}, snapshot after frame "
              f"{EUROC_FRAMES - 1} {verdict} to the uninterrupted run's "
              f"({len(resumed.keyframes)} keyframes, {len(resumed.loop_closures)} closures)")
        check(same_est and not differ, f"config 4 resume from frame {c} is not bit-identical: "
              f"estimates {'equal' if same_est else 'differ'}, {differ}")
        del resumed
    if len(cuts) == 1:
        print("euroc config 4 resume: session one has no closure matches pending inside a flag "
              f"window after frame {RESUME_CUT}")
    k, (n_launch, busy, wall_p, top) = prof
    n = EUROC_PROFILE_FRAMES
    print(f"euroc config 4 profile, frames {k}-{EUROC_FRAMES - 1}: {n_launch / n:.0f} device "
          f"launches, device busy {busy / n:.2f} ms, wall {wall_p / n:.1f} ms per frame with the "
          f"profiler on; idle share {1 - busy / wall_p:.3f}")
    for name, ms, count in top:
        print(f"euroc config 4 profile:   {ms / n:8.2f} ms {count / n:7.0f} launches per frame  "
              f"{name[:90]}")
    shutil.rmtree(out, ignore_errors=True)
    return {"launches": launches, "fps": [r["fps"] for r in per], "peak_gib": peak / 2**30,
            "ba_s_per_iter": ba_s / len(costs), "ba_eager_s_per_iter": twin_s / len(costs)}


CONFIG5_FRAMES = 10
CONFIG5_CUT = 5          # the snapshot after frame 5, resumed for frames 6-10
CONFIG5_TWIN_FRAMES = 2  # the first frames replayed on the twin path
CONFIG5_PROFILE_FRAMES = 2  # the run's last frames, profiled
CONFIG5_MIN_OBS = 100    # valid observations a frame
CONFIG5_BA = dict(C=64, Pts=110000, obs_per_cam=2000)  # eval/config5_demo's problem
CONFIG5_BA_ITERS, CONFIG5_BA_PCG = 3, 15
CONFIG5_RING = (131072, 256)  # eval/config5_demo's database rows and queries


def phase_config5(device, card):
    """Benchmark config 5's distributed layer at world size 1 under NCCL:
    the sharded filter at full width captured (one graph a frame, the
    collectives inside) against the eager sharded step and the one-device
    step, a resume, the ring match and the distributed BA captured against
    eager, and the sharded online system captured against eager. The
    captured programs hold NCCL's communicators, so they are freed (the
    body's locals, then a collection) before the group is destroyed."""
    import gc

    import torch
    import torch.distributed as tdist

    from parakeet_slam_tpu_torch.dist.multihost import free_local_port

    check(tdist.is_available() and tdist.is_nccl_available(), "torch.distributed has no NCCL")
    torch.cuda.set_device(device)
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_local_port()}",
                             world_size=1, rank=0, device_id=device)
    try:
        return _config5_body(device, card)
    finally:
        gc.collect()
        torch.cuda.synchronize()
        tdist.destroy_process_group()


def _config5_sequence(device, cfg, T):
    """Config 5's frames (panoramic observations of the world) as sequence
    tensors, and the world."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.data.panoramic import make_panoramic_world
    from parakeet_slam_tpu_torch.eval.kernel_inputs import panoramic_observations

    fc = cfg.filter
    Z, W = fc.max_observations, fc.desc_words
    world = make_panoramic_world(num_landmarks=300, num_steps=T,
                                 image_size=tuple(cfg.frontend.image_size))
    obs = [panoramic_observations(world, t, Z, W, seed=0) for t in range(T)]
    T_ = lambda a: torch.as_tensor(np.stack(a), device=device)  # noqa: E731
    return world, {"odom": T_([world.odom[t] for t in range(T)]),
                   "obs_z": T_([o[0] for o in obs]),
                   "obs_sig": torch.zeros(T, Z, 0, device=device),
                   "obs_valid": T_([o[2] for o in obs]),
                   "obs_desc": T_([o[1].view(np.int32) for o in obs])}


def _config5_body(device, card):
    import shutil

    import numpy as np
    import torch
    import torch.distributed as tdist

    from parakeet_slam_tpu_torch.backend import ba
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.core.state import Observation
    from parakeet_slam_tpu_torch.dist import dist_ba, mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist.multihost import resume_or_init, snapshot_every
    from parakeet_slam_tpu_torch.dist.ring_match import ring_hamming_top2, ring_match
    from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
    from parakeet_slam_tpu_torch.eval import config5_demo
    from parakeet_slam_tpu_torch.eval.kernel_inputs import descriptors
    from parakeet_slam_tpu_torch.filter import make_filter, run_sequence
    from parakeet_slam_tpu_torch.filter.runner import METRICS, draw_noise
    from parakeet_slam_tpu_torch.kernels import match, schur

    out = {}
    check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1,
          f"process group {tdist.get_backend()} x {tdist.get_world_size()}")
    mesh = mesh_mod.make_mesh(map_axis=1)
    print(f"config 5: process group {tdist.get_backend()}, world size "
          f"{tdist.get_world_size()}, mesh {mesh.shape}")

    # -- the sharded filter at full width --------------------------------
    cfg = load_config(os.path.join(HERE, "configs/panoramic.yaml"))
    fc = cfg.filter
    check((fc.algorithm, fc.measurement_model, fc.num_particles, fc.max_landmarks,
           fc.max_observations, fc.desc_words) == ("fastslam1", "equirect_3d", 1024, 8192,
                                                   128, 8),
          f"configs/panoramic.yaml is not config 5 at full width: {fc}")
    P, L, Z, W = fc.num_particles, fc.max_landmarks, fc.max_observations, fc.desc_words
    slam = make_filter(fc, cfg.frontend)
    sharded = ShardedFastSLAM(slam, mesh)
    T = CONFIG5_FRAMES
    world, seq = _config5_sequence(device, cfg, T)
    frames = [(seq["odom"][t], Observation(z=seq["obs_z"][t], sig=seq["obs_sig"][t],
                                           desc=seq["obs_desc"][t], valid=seq["obs_valid"][t]))
              for t in range(T)]
    n_valid = seq["obs_valid"].sum(1).tolist()
    check(min(n_valid) >= CONFIG5_MIN_OBS, f"config 5 valid observations a frame {n_valid}")
    gen = torch.Generator(device=device).manual_seed(0)
    noise, u0 = draw_noise(T, P, slam.noise_dim, gen, device)
    pose0 = world.gt_pose[0]
    data = [seq[k] for k in ("odom", "obs_z", "obs_sig", "obs_valid")]
    kw = dict(motion_noise=noise, resample_u0=u0, obs_desc=seq["obs_desc"])

    def run_sharded(st, t0, t1, keep=None):
        """The eager sharded step, frame by frame (run_sequence's eager
        loop, with the gathered state kept after the frames in `keep`)."""
        est, ms = [], []
        for t in range(t0, t1):
            u, obs = frames[t]
            st, m = sharded.step(st, u, obs, sharded.local_draws(noise[t]), u0[t])
            est.append(sharded.estimate_pose(st))
            ms.append(m)
            if keep is not None and t + 1 in keep:
                keep[t + 1] = sharded.gather_state(st).clone()
        return st, est, ms

    # the captured run first: it is the main path whose launches are counted
    st0 = sharded.init_state(init_pose=pose0, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts_3d()
    t0 = time.perf_counter()
    cap = run_sequence(sharded, st0, *data, capture=True, **kw)
    torch.cuda.synchronize()
    fps_first = T / (time.perf_counter() - t0)
    launches = _counts_3d()
    peak = torch.cuda.max_memory_allocated()
    cs = sharded._sequence_step[1]
    t0 = time.perf_counter()
    cap = run_sequence(sharded, st0, *data, capture=True, **kw)  # every frame a replay
    torch.cuda.synchronize()
    fps = T / (time.perf_counter() - t0)
    # the eager sharded step from the same draws
    keep = {CONFIG5_CUT: None}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, est, ms = run_sharded(st0.clone(), 0, T, keep)
    torch.cuda.synchronize()
    fps_eager = T / (time.perf_counter() - t0)
    n_res = int(sum(bool(m.resampled) for m in ms))
    state_mb = sum(getattr(st, f).numel() * getattr(st, f).element_size()
                   for f in STATE_KEYS + ("lm_desc",)) / 1e6
    print(f"config 5 sharded filter (FastSLAM 1.0 equirect_3d P={P} L={L} Z={Z} W={W}, "
          f"{state_mb:.1f} MB of state): {T} frames captured, fps={fps:.3f} (every frame a "
          f"replay; {fps_first:.3f} with the warm-up frame and the capture), eager "
          f"fps={fps_eager:.3f}; valid obs {min(n_valid)}-{max(n_valid)} a frame "
          f"resamples={n_res} peak_mem={peak / 2**30:.3f} GiB launches score_3d={launches[0]} "
          f"update_3d={launches[1]} gather={launches[2]} "
          f"landmarks/particle={float(st.num_landmarks().float().mean()):.1f}")
    check(launches[1] == T and launches[0] == 0,
          f"config 5 launches update_3d={launches[1]} score_3d={launches[0]}, frames {T}")
    # the resample is decided on the device: the gather runs every frame
    check(n_res >= 1 and launches[2] == T,
          f"config 5 gather launches {launches[2]}, frames {T}, resamples {n_res}")

    # captured == eager == the one-device step, every leaf, estimate, metric
    _same_state("config 5 sharded", cap[0], st)
    check(_bit_equal(cap[1], torch.stack(est)), "config 5: captured vs eager estimates differ")
    for k in METRICS:
        check(_bit_equal(torch.stack([getattr(m, k) for m in cap[2]]),
                         torch.stack([getattr(m, k) for m in ms])),
              f"config 5: captured vs eager metric {k} differs")
    ref = run_sequence(slam, slam.init_state(init_pose=pose0, device=device), *data,
                       capture=False, **kw)
    full = sharded.gather_state(st)
    _same_state("config 5 sharded vs FastSLAM.step", full, ref[0])
    check(_bit_equal(torch.stack(est), ref[1]), "config 5 sharded vs one device: estimates differ")
    for k in METRICS:
        check(_bit_equal(torch.stack([getattr(m, k) for m in ref[2]]),
                         torch.stack([getattr(m, k) for m in ms])),
              f"config 5 sharded vs one device: metric {k} differs")
    print(f"config 5 sharded captured vs eager vs FastSLAM.step, {T} frames: every state leaf, "
          f"estimate and metric bit-equal ({int(full.lm_valid.sum())} live lanes)")
    del ref, full

    # profiles: replays of the captured step, and eager frames
    prof = {}
    for mode in ("captured", "eager"):
        names = {}
        if mode == "captured":
            cs.inputs["t"].zero_()
            fn = lambda: [cs() for _ in range(CONFIG5_PROFILE_FRAMES)]  # noqa: E731
        else:
            fn = lambda: run_sharded(st0.clone(), 0, CONFIG5_PROFILE_FRAMES)  # noqa: E731
        n_dev, busy, wall, top = _profile(fn, names=names, host=True)
        n = CONFIG5_PROFILE_FRAMES
        api = sum(c for name, c in names.items() if _is_api(name)
                  and name != "cudaDeviceSynchronize")
        prof[mode] = {"launches": n_dev / n, "api_calls": api / n,
                      "graph_launches": names.get("cudaGraphLaunch", 0) / n,
                      "busy_ms": busy / n, "wall_ms": wall / n, "idle": 1 - busy / wall}
        r = prof[mode]
        print(f"config 5 profile {mode}, {n} frames: {r['launches']:.0f} device launches, "
              f"{r['api_calls']:.0f} host CUDA API calls ({r['graph_launches']:.0f} graph "
              f"launches) a frame, device busy {r['busy_ms']:.3f} of {r['wall_ms']:.3f} ms a "
              f"frame, idle share {r['idle']:.3f}; top {top}")
    check(prof["captured"]["graph_launches"] == 1,
          f"config 5 captured: {prof['captured']['graph_launches']} graph launches a frame")
    facts = _graph_facts(cs)
    print(f"config 5 captured step: capture {facts['capture_s']:.3f} s, instantiate "
          f"{facts['instantiate_s']:.3f} s, graph pool {facts['pool_bytes'] / 2**20:.1f} MiB, "
          f"launches counted per replay {facts['per_replay']}")
    u, obs = frames[1]
    st_x = st.clone()  # the kernels update log_w in place
    _sync_free("config 5 sharded step", lambda: (
        sharded.estimate_pose(sharded.step(st_x, u, obs, sharded.local_draws(noise[1]),
                                           u0[1])[0]),
        sharded.best_particle_lanes(st_x)))
    del st_x
    out.update(fps=fps, fps_eager=fps_eager, fps_first=fps_first, launches=launches,
               peak_gib=peak / 2**30, profile=prof, graph=facts, resamples=n_res)
    del cap

    # the first frames on the twin path (eager: the twins replace the
    # wrappers, which a captured graph would not see)
    st_k, est_k, _ = run_sharded(sharded.init_state(init_pose=pose0, device=device), 0,
                                 CONFIG5_TWIN_FRAMES)
    restore = _twin_path()
    try:
        st_t, est_t, _ = run_sharded(sharded.init_state(init_pose=pose0, device=device), 0,
                                     CONFIG5_TWIN_FRAMES)
    finally:
        restore()
    for k in ("lm_valid", "lm_count"):
        a, b = getattr(st_k, k), getattr(st_t, k)
        check(torch.equal(a, b), f"config 5 kernel vs twin path: {k} differs in "
                                 f"{int((a != b).sum())}")
    err = float((torch.stack(est_k) - torch.stack(est_t)).abs().max())
    check(err <= 1e-5, f"config 5 kernel vs twin path: estimates differ by {err}")
    print(f"config 5 kernel vs twin path, {CONFIG5_TWIN_FRAMES} frames: lm_valid and "
          f"lm_count equal ({int(st_k.lm_valid.sum())} live lanes), est max |diff| {err:.3g}")
    del st_k, st_t

    # resume: the gathered state after frame 5 through the snapshot store,
    # continued by the captured step
    ckpt_dir = os.path.join(HERE, "build", "chip_smoke_config5")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t_s = time.perf_counter()
    snapshot_every(ckpt_dir, CONFIG5_CUT)(keep[CONFIG5_CUT], CONFIG5_CUT)
    t_save = time.perf_counter() - t_s
    t_s = time.perf_counter()
    glob, start = resume_or_init(ckpt_dir, sharded.global_template(st), lambda: None)
    back = sharded.shard_state(glob, device=device)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t_s
    check(start == CONFIG5_CUT, f"config 5 resumed at step {start}")
    rest = [d[CONFIG5_CUT:] for d in data]
    back, est_r, _ = run_sequence(sharded, back, *rest, motion_noise=noise[CONFIG5_CUT:],
                                  resample_u0=u0[CONFIG5_CUT:],
                                  obs_desc=seq["obs_desc"][CONFIG5_CUT:], capture=True)
    _same_state("config 5 resume", back, st)
    check(_bit_equal(est_r, torch.stack(est[CONFIG5_CUT:])), "config 5 resume: estimates differ")
    mb = sum(os.path.getsize(os.path.join(ckpt_dir, n)) for n in os.listdir(ckpt_dir)) / 1e6
    print(f"config 5 resume: snapshot after frame {CONFIG5_CUT} ({mb:.1f} MB, saved in "
          f"{t_save:.2f} s, loaded and sharded in {t_load:.2f} s), frames "
          f"{CONFIG5_CUT + 1}-{T} captured bit-equal in every state leaf and estimate")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del back, st, keep, glob, st0
    sharded._sequence_step = None

    # -- the ring match at the demo's shape, captured and eager -----------
    M, N = CONFIG5_RING
    rng = np.random.default_rng(0)
    qd = torch.as_tensor(descriptors(rng, (N, 8)), device=device)
    db = torch.as_tensor(descriptors(rng, (M, 8)), device=device)
    dbv = torch.as_tensor(rng.random(M) > 0.05, device=device)
    qv = torch.ones(N, dtype=torch.bool, device=device)
    match.hamming_top2.launches = 0
    got = [ring_hamming_top2(qd, qv, db, dbv, mesh) for _ in range(3)]  # warm-up, capture, replay
    ring_launches = match.hamming_top2.launches
    eager = ring_hamming_top2(qd, qv, db, dbv, mesh, capture=False)
    check(all(_bit_equal(a, b) for g in got for a, b in zip(g, eager)),
          "config 5 ring match: captured vs eager differ")
    bi, b1, b2 = got[-1]
    ri, r1, r2 = match.hamming_top2_reference(qd, db, dbv)
    ties = r1 == r2
    check(torch.equal(b1, r1) and torch.equal(b2, r2), "config 5 ring match: b1/b2 differ")
    check(torch.equal(bi[~ties], ri[~ties]), "config 5 ring match: idx differs off ties")
    m_cap = [ring_match(qd, qv, db, dbv, mesh) for _ in range(3)]
    m_eager = ring_match(qd, qv, db, dbv, mesh, capture=False)
    check(all(_bit_equal(a, b) for g in m_cap for a, b in zip(g, m_eager)),
          "config 5 ring_match: captured vs eager differ")
    calls = {"captured": lambda: ring_hamming_top2(qd, qv, db, dbv, mesh),
             "eager": lambda: ring_hamming_top2(qd, qv, db, dbv, mesh, capture=False),
             "alone": lambda: match.hamming_top2(qd, db, dbv)}
    ms_ring = {k: [] for k in calls}
    for _ in range(2):
        for k, f in calls.items():
            ms_ring[k].append(cuda_ms(f, reps=20))
    ms_ring = {k: sum(v) / len(v) for k, v in ms_ring.items()}
    print(f"config 5 ring match M={M} N={N} W=8 over {mesh.size} rank: captured equal to eager "
          f"(top-2 and ratio test, {ring_launches} hamming_top2 launches over 3 captured calls), "
          f"b1, b2 equal to the twin, idx equal off {int(ties.sum())} ties "
          f"({int((bi == ri).sum())} of {N} equal); captured {ms_ring['captured']:.4f} ms, "
          f"eager {ms_ring['eager']:.4f} ms, hamming_top2 alone on the whole database "
          f"{ms_ring['alone']:.4f} ms (median of 20 calls, two turns) | {card}")
    out.update(ring_launches=ring_launches, ms_ring=ms_ring["captured"],
               ms_ring_eager=ms_ring["eager"], ms_ring_alone=ms_ring["alone"])
    del qd, db, dbv, got, eager, m_cap, m_eager

    # -- the distributed BA at the demo's size, captured and eager ----------
    cam, prob = config5_demo.make_big_ba(device=device, **CONFIG5_BA)
    sp = dist_ba.shard_problem(prob, 1)
    bkw = dict(iters=CONFIG5_BA_ITERS, pcg_iters=CONFIG5_BA_PCG,
               huber_delta=config5_demo.BA_HUBER, lam=config5_demo.BA_LAM)
    dist_ba.optimize_ba_distributed(cam, sp, mesh, **bkw)  # warm-up and capture
    torch.cuda.synchronize()
    schur.apply_cinv.launches = 0
    res_c = dist_ba.optimize_ba_distributed(cam, sp, mesh, **bkw)  # every iteration a replay
    torch.cuda.synchronize()
    cinv_launches = schur.apply_cinv.launches
    res_e = dist_ba.optimize_ba_distributed(cam, sp, mesh, capture=False, **bkw)
    check(_bit_equal(res_c[1], res_e[1]) and _bit_equal(res_c[0].cam_pose, res_e[0].cam_pose)
          and _bit_equal(res_c[0].points, res_e[0].points),
          "config 5 distributed BA: captured vs eager differ")
    names = {}
    _profile(lambda: dist_ba.optimize_ba_distributed(cam, sp, mesh, **bkw), names=names,
             host=True)
    graph_launches = names.get("cudaGraphLaunch", 0)
    check(graph_launches == CONFIG5_BA_ITERS,
          f"config 5 distributed BA: {graph_launches} graph launches for {CONFIG5_BA_ITERS} "
          f"LM iterations")
    saved = schur.cinv_apply
    schur.cinv_apply = lambda C, u, eps=1e-12: schur.apply_cinv_reference(C, u, eps)
    try:
        _, costs_twin = dist_ba.optimize_ba_distributed(cam, sp, mesh, capture=False, **bkw)
    finally:
        schur.cinv_apply = saved
    c, ct = res_c[1].cpu().numpy(), costs_twin.cpu().numpy()
    check(np.isfinite(c).all() and c[-1] < c[0], f"config 5 BA costs {c}")
    check(np.allclose(c, ct, rtol=1e-4, atol=0.0), f"config 5 BA kernel {c} vs twin {ct}")
    check(cinv_launches == CONFIG5_BA_ITERS * (CONFIG5_BA_PCG + 3),
          f"config 5 BA apply_cinv launches {cinv_launches}")
    # ms an LM iteration in turns: the distributed BA and ba.optimize_ba on
    # the same problem, each captured and eager
    solves = {
        "dist captured": lambda: dist_ba.optimize_ba_distributed(cam, sp, mesh, **bkw),
        "dist eager": lambda: dist_ba.optimize_ba_distributed(cam, sp, mesh, capture=False,
                                                              **bkw),
        "optimize_ba captured": lambda: ba.optimize_ba(cam, prob, capture=True, **bkw),
        "optimize_ba eager": lambda: ba.optimize_ba(cam, prob, capture=False, **bkw),
    }
    one = {k: f() for k, f in solves.items() if k.startswith("optimize_ba")}  # warm-up
    ms_it = {k: [] for k in solves}
    for _ in range(2):
        for k, f in solves.items():
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            f()
            torch.cuda.synchronize()
            ms_it[k].append((time.perf_counter() - t_s) / CONFIG5_BA_ITERS * 1e3)
    check(all(_bit_equal(a, b) for a, b in zip(_ba_results(one["optimize_ba captured"]),
                                               _ba_results(one["optimize_ba eager"]))),
          "config 5: ba.optimize_ba captured vs eager differ")
    print(f"config 5 distributed BA (C={prob.num_cams} points={prob.num_points} obs={prob.num_obs}, "
          f"{CONFIG5_BA_ITERS} LM x {CONFIG5_BA_PCG} PCG, S=1): captured bit-equal to eager "
          f"(costs, poses, points), {graph_launches} graph launches for {CONFIG5_BA_ITERS} LM "
          f"iterations, cost {' -> '.join(f'{x:.1f}' for x in c)}, through the twin "
          f"{' -> '.join(f'{x:.1f}' for x in ct)}, apply_cinv launches={cinv_launches}; ms "
          f"per LM iteration in two turns: "
          + ", ".join(f"{k} {v[0]:.2f}; {v[1]:.2f}" for k, v in ms_it.items())
          + f" (each solve with its host set-up); ba.optimize_ba cost "
          f"{float(one['optimize_ba captured'].costs[-1]):.1f} | {card}")
    mean = {k: sum(v) / len(v) for k, v in ms_it.items()}
    out.update(ba_ms=mean["dist captured"], ba_eager_ms=mean["dist eager"],
               ba_one_ms=mean["optimize_ba captured"], ba_one_eager_ms=mean["optimize_ba eager"],
               cinv_launches=cinv_launches)
    del res_c, res_e, prob, sp, one

    # -- the sharded online system, captured against eager ------------------
    row = config5_demo.demo_online_sharded(device=device)
    check(row["captured"] and row["captured_equals_eager"] and row["parity_vs_one_device"],
          f"config 5 online system: {row}")
    print(f"config 5 online system (P={row['particles']} L={row['map_capacity']}, mesh "
          f"{row['mesh']}): captured {row['frames_per_s']} frames/s, eager "
          f"{row['frames_per_s_eager']}, captured == eager == one device bit for bit, "
          f"keyframes {row['keyframes']} | {card}")
    out.update(online=row)
    return out


# -- phase 17: the generic measurement path ---------------------------------

GENERIC_3D_SHAPE = (256, 1024, 32)  # a small pinhole shape (P, L, Z)
GENERIC_RUN_FRAMES = 30             # frames of the bearing_2d / velocity_2d filters
NEAR_TIE = 1e-4                     # score margin inside which two forms may part


def _generic_margins(slam, state, obs):
    """Per (particle, observation) of the generic scoring: (best minus
    runner-up, |best - new-landmark threshold|) [P, Z]."""
    import torch

    zhat, _, inv, logdet = slam._per_pair_stats(state.pose[:, None, :], state.lm_mean,
                                                state.lm_cov, assoc=True)
    gap, thr = [], []
    p0 = slam._log_p0_assoc()
    for i in range(obs.capacity):
        ll = slam._loglik(obs.z[i], zhat, inv, logdet) + slam._appearance_loglik(
            obs.sig[i], obs.desc[i], state.lm_sig, state.lm_desc)
        ll = torch.where(state.lm_valid & torch.isfinite(ll), ll, -1e30)
        top = torch.topk(ll, 2, dim=1).values
        gap.append(top[:, 0] - top[:, 1])
        thr.append((top[:, 0] - p0).abs())
    return torch.stack(gap, 1), torch.stack(thr, 1)


def _compare_generic(what, slam, state, obs, k_out, fields):
    """The generic path against a kernel's outputs (fields in order, then
    n_match and target) from one state: targets equal except where the best
    score lies within NEAR_TIE of the runner-up or the threshold (counted;
    those particles' states are left out); everything else at the standing
    bar. The generic path itself launches neither fused update nor
    score_3d. Returns (max float difference, lanes parted, particles left out,
    the generic path's ms a single call)."""
    import torch

    before = _counts()[:1] + _counts_3d()[:2]
    g_target, is_new, do_upd, do_alloc, _ = slam._associate_frame(state, obs)
    g_state, _ = slam._measurement_generic(state, obs, True)
    torch.cuda.synchronize()
    check(_counts()[:1] + _counts_3d()[:2] == before,
          f"{what}: the generic path launched a fused update or score_3d")
    got = dict(zip(fields, k_out))
    k_target = got["target"].long()
    diff = g_target != k_target
    gap, thr = _generic_margins(slam, state, obs)
    near = (gap < NEAR_TIE) | (thr < NEAR_TIE)
    bad = diff & ~near
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} association lanes differ off the ties")
    keep = ~diff.any(dim=1)
    g_match = (do_upd | do_alloc).to(torch.float32).sum(dim=1)
    check(torch.equal(g_match[keep], got["n_match"][keep]), f"{what}: n_match differs")
    err = 0.0
    for f in fields:
        if f in ("n_match", "target"):
            continue
        g, k = getattr(g_state, f)[keep], got[f][keep]
        if f in ("lm_valid", "lm_count", "lm_desc"):
            check(torch.equal(g, k), f"{what}: {f} differs in {int((g != k).sum())} entries")
            continue
        d = float((g - k).abs().max()) if g.numel() else 0.0
        err = max(err, d)
        tol = dict(rtol=0.0, atol=1e-4) if f == "log_w" else dict(rtol=1e-5, atol=1e-5)
        check(torch.allclose(g, k, **tol), f"{what}: {f} max |diff| {d}")
    ms = cuda_ms(lambda: slam._measurement_generic(state, obs, True), reps=3)
    return err, int(diff.sum()), int((~keep).sum()), ms


def check_generic_2d(shape, device):
    """The generic path against ekf_update_2d from one state (corridor
    options: S=3, r=(0.1, 0.03), log p0=-8, cull)."""
    import torch

    from parakeet_slam_tpu_torch.core.config import FilterConfig
    from parakeet_slam_tpu_torch.core.state import Observation, ParticleState
    from parakeet_slam_tpu_torch.filter import FastSLAM
    from parakeet_slam_tpu_torch.kernels import ekf_update

    P, L, Z, S = shape
    T = _update_inputs(shape, seed=sum(shape) + 1, device=device)
    cfg = FilterConfig(num_particles=P, max_landmarks=L, max_observations=Z, sig_dim=S,
                       meas_noise=(0.1, 0.03), sig_noise=0.5, new_landmark_loglik=-8.0,
                       max_range=6.5, fov_half_angle=2.5)
    slam = FastSLAM(cfg)
    check(slam.kernel_2d, f"{shape}: the 2-D kernel does not cover this config")
    state = ParticleState(**{k: T[k] for k in STATE_KEYS},
                          lm_desc=torch.zeros(P, L, 0, dtype=torch.int32, device=device))
    obs = Observation(z=T["z"], sig=T["sig"], desc=torch.zeros(Z, 0, dtype=torch.int32,
                                                                device=device), valid=T["valid"])
    kw = dict(sig_dim=S, r_var=slam.r_var, sig_var=slam.sig_var, log_p0=-8.0, init_infl=1.0,
              max_range=6.5, fov_half=2.5, cull=True)
    work = [T[k].clone() for k in STATE_KEYS]
    k_out = ekf_update.measurement_update_2d(*work, T["z"], T["sig"], T["valid"], **kw)
    fields = ("log_w", "lm_mean", "lm_cov", "lm_sig", "lm_valid", "lm_count", "n_match", "target")
    err, n_diff, n_left, g_ms = _compare_generic(f"generic vs ekf_update_2d {shape}", slam, state,
                                                 obs, k_out, fields)

    def reset():
        for w, k in zip(work, STATE_KEYS):
            w.copy_(T[k])

    k_ms = cuda_ms(lambda: ekf_update.measurement_update_2d(*work, T["z"], T["sig"], T["valid"],
                                                            **kw), reps=5, prepare=reset)
    print(f"generic vs ekf_update_2d P={P} L={L} Z={Z} S={S}: targets equal but {n_diff} near "
          f"ties ({n_left} particles left out), max_abs_err={err:.3g}; generic {g_ms:.3f} ms, "
          f"kernel {k_ms:.3f} ms (single calls)")
    return err, n_diff


def check_generic_3d(device, freeze):
    """The generic path against measurement_update_3d (pinhole_3d, scoring
    itself) from one state, anchor freeze off or on."""
    import torch

    from parakeet_slam_tpu_torch.core.config import FilterConfig, FrontendConfig
    from parakeet_slam_tpu_torch.core.state import Observation, ParticleState
    from parakeet_slam_tpu_torch.eval import kernel_inputs as KI
    from parakeet_slam_tpu_torch.filter import FastSLAM
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d as E

    P, L, Z = GENERIC_3D_SHAPE
    model = "pinhole_3d"
    T = _frame_3d(model, GENERIC_3D_SHAPE, "holes", device)
    kw = KI.update_3d_kwargs(model, freeze=freeze)
    fx, fy, cx, cy, b, W, H = KI.CAMERAS[model]
    cfg = FilterConfig(num_particles=P, max_landmarks=L, max_observations=Z, lm_dim=3, obs_dim=2,
                       pose_dim=7, desc_words=8, desc_weight=0.5, measurement_model=model,
                       motion_model="se3_odometry", meas_noise=KI.NOISE_3D[model],
                       new_landmark_loglik=-30.0, init_range_prior=8.0, init_range_sigma=3.0,
                       max_range=35.0, freeze_min_count=freeze)
    fe = FrontendConfig(camera="pinhole", intrinsics=(fx, fy, cx, cy), baseline=b,
                        image_size=(int(H), int(W)))
    slam = FastSLAM(cfg, fe)
    check(slam.kernel_3d, "the 3-D kernel does not cover this config")
    state = ParticleState(**{k: T[k] for k in STATE_3D},
                          lm_sig=torch.zeros(P, L, 0, device=device))
    obs = Observation(z=T["z"], sig=torch.zeros(Z, 0, device=device), desc=T["desc"],
                      valid=T["valid"])
    work = [T[k].clone() for k in STATE_3D]
    k_out = E.measurement_update_3d(*work, T["z"], T["desc"], T["valid"], None, None, **kw)
    fields = ("log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid", "lm_count", "n_match", "target")
    what = f"generic vs measurement_update_3d {model} P={P} L={L} Z={Z} freeze={freeze}"
    err, n_diff, n_left, g_ms = _compare_generic(what, slam, state, obs, k_out, fields)
    print(f"{what}: targets equal but {n_diff} near ties ({n_left} particles left out), "
          f"max_abs_err={err:.3g}; generic {g_ms:.3f} ms")
    return err, n_diff


def _run_2d_filter(what, device, **kw):
    """GENERIC_RUN_FRAMES frames of a 2-D filter on the corridor's bearings
    (numpy, seed 7): finite, mapping; (frames/s, resamples, gathers)."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.core.config import FilterConfig
    from parakeet_slam_tpu_torch.data import make_corridor
    from parakeet_slam_tpu_torch.filter import make_filter, run_sequence
    from parakeet_slam_tpu_torch.kernels import resample_cuda

    n = GENERIC_RUN_FRAMES
    sim = make_corridor(num_landmarks=100, num_steps=200, max_obs=16, seed=7)
    cfg = FilterConfig(num_particles=64, max_landmarks=192, max_observations=16, sig_dim=3,
                       measurement_model="bearing_2d", obs_dim=1, meas_noise=(0.03,),
                       sig_noise=0.5, max_range=6.5, fov_half_angle=2.5, init_range_prior=3.0,
                       init_range_sigma=1.5, new_landmark_loglik=-3.0, **kw)
    slam = make_filter(cfg)
    check(not (slam.kernel_2d or slam.kernel_3d), f"{what}: not the generic path")
    odom = sim.odom[:n]
    if cfg.motion_model == "velocity_2d":
        dt = 0.1
        odom = np.stack([odom[:, 0] / dt, odom[:, 2] / dt, np.full(n, dt)], 1)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=None, device=device)  # noqa: E731
    data = (T(odom.astype(np.float32)), T(sim.obs_z[:n, :, 1:2]), T(sim.obs_sig[:n]),
            T(sim.obs_valid[:n]))
    gen = torch.Generator(device=device).manual_seed(0)
    state0 = slam.init_state(init_pose=sim.gt_pose[0], device=device)
    run_sequence(slam, state0, *data, generator=gen)  # warm-up and capture
    resample_cuda.gather_state.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, est, metrics = run_sequence(slam, state0, *data, generator=gen)
    torch.cuda.synchronize()
    fps = n / (time.perf_counter() - t0)
    n_res = int(sum(bool(m.resampled) for m in metrics))
    gathers = resample_cuda.gather_state.launches
    lms = final.lm_valid.sum(dim=1)
    print(f"{what} (P=64 L=192 Z=16, generic path): {n} frames fps={fps:.1f} "
          f"landmarks/particle {float(lms.float().mean()):.1f} resamples={n_res} "
          f"gather launches={gathers}")
    check(bool(torch.isfinite(est).all()) and bool(torch.isfinite(final.log_w).all()),
          f"{what}: not finite")
    check(int(lms.min()) > 0, f"{what}: a particle allocated no landmark")
    check(gathers == n, f"{what}: gather launches {gathers}, frames {n}")
    return fps


def phase_generic(device):
    """The generic measurement path on the card: against the 2-D and 3-D
    kernels from one state, and two 2-D filters that only it covers."""
    err, ties = 0.0, 0
    for shape in (CORRIDOR_SHAPE, REAL_SHAPE):
        e, t = check_generic_2d(shape, device)
        err, ties = max(err, e), ties + t
    for freeze in (0, 3):
        e, t = check_generic_3d(device, freeze)
        err, ties = max(err, e), ties + t
    fs1 = _run_2d_filter("bearing_2d FastSLAM 1.0", device)
    fs2 = _run_2d_filter("bearing_2d + velocity_2d FastSLAM 2.0", device, algorithm="fastslam2",
                         motion_model="velocity_2d", motion_noise=(0.05, 0.01, 0.05, 0.01))
    return {"err": err, "ties": ties, "fps_bearing_fs1": fs1, "fps_velocity_fs2": fs2}


# -- phase 18: bench_system ---------------------------------------------------

BENCH_FRAMES = 30   # timed frames: the reference's default, on its 35-step worlds
BENCH_PROFILE = 4   # the worlds' last frames (one flush), a flush frame and one other profiled
BENCH_REPLAY = 2    # the first frames, replayed on the twin path


def start_bench_renders():
    """Submit phase 18's renders to worker processes (all cores but two),
    so that they overlap phase 6, whose times are the card's own (CUDA
    events); `finish_bench_renders` collects them before phase 7, the first
    phase timed on the host's clock. Returns (pool, jobs, done, t0)."""
    from parakeet_slam_tpu_torch.eval.bench_system import bench_world, render_pool

    t0 = time.perf_counter()
    worlds = {kind: bench_world(kind, BENCH_FRAMES) for kind in ("stereo", "pano")}
    pool = render_pool(sum(len(w[3]) for w in worlds.values()))
    done = {}

    def stamp(kind):
        def finished(_):
            done[kind] = max(done.get(kind, 0.0), time.perf_counter() - t0)
        return finished

    jobs = {}
    for kind, (cfg, world, render, args) in worlds.items():
        futures = [pool.submit(render, *a) for a in args]
        for f in futures:
            f.add_done_callback(stamp(kind))
        jobs[kind] = (cfg, world, futures)
    return pool, jobs, done, t0


def finish_bench_renders(renders):
    """Wait for the renders and stop the workers: {kind: (cfg, world, inputs)}."""
    pool, jobs, done, t0 = renders
    t_wait = time.perf_counter()
    try:
        out = {kind: (cfg, world, [f.result() for f in futures])
               for kind, (cfg, world, futures) in jobs.items()}
    finally:
        pool.shutdown(cancel_futures=True)
    print(f"bench_system renders: {len(out['stereo'][2])} stereo pairs done at "
          f"{done['stereo']:.1f} s, {len(out['pano'][2])} pano frames at {done['pano']:.1f} s, "
          f"in worker processes on {os.cpu_count()} cores less two, beside phase 6; phase 7 waited "
          f"{time.perf_counter() - t_wait:.1f} s")
    return out


def phase_bench_system(device, rendered):
    import torch

    from parakeet_slam_tpu_torch import system as system_mod
    from parakeet_slam_tpu_torch.eval.bench_system import WARMUP, frame_step, run_bench
    from parakeet_slam_tpu_torch.kernels import match

    out = {}
    for kind in ("stereo", "pano"):
        cfg, world, inputs = rendered[kind]
        frames = WARMUP + BENCH_FRAMES
        step = frame_step(kind, world, inputs)
        calls = []
        restore = recording_dispatches(calls)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts_3d()
            match.hamming_top2.launches = 0
            def drive():
                row, sys_ = run_bench(kind, cfg, world, inputs, BENCH_FRAMES, device)
                sys_.flush_flags()
                sys_.flush_metrics()
                return row, sys_

            (row, sys_), n_res = _with_resamples(drive)
            torch.cuda.synchronize()
            launches = _counts_3d() + (match.hamming_top2.launches,)
        finally:
            restore()
        peak = torch.cuda.max_memory_allocated()
        est = sys_.state.pose
        fc = cfg.filter
        print(f"bench_system {kind} (FastSLAM 1.0 {fc.measurement_model} P={fc.num_particles} "
              f"L={fc.max_landmarks} Z={fc.max_observations}, {cfg.frontend.image_size[0]}x"
              f"{cfg.frontend.image_size[1]}): {json.dumps(row)}")
        check(row["fps_per_chip"] > 0 and bool(torch.isfinite(est).all()), f"{kind}: not finite")
        check(launches[1] == frames and launches[0] == 0,
              f"{kind}: launches update_3d={launches[1]} score_3d={launches[0]}, frames {frames}")
        check(launches[2] == frames, f"{kind}: gather launches {launches[2]}, frames {frames}")
        per = system_mod.MATCH_LAUNCHES_PER_DISPATCH
        check(len(calls) >= 1 and launches[3] == per * len(calls),
              f"{kind}: hamming_top2 launches {launches[3]}, dispatches {len(calls)} x {per}")
        check(len(sys_.keyframes) >= 2, f"{kind}: keyframes {len(sys_.keyframes)}")
        # every closure dispatch of the run through hamming_top2's twin
        phase_desk_replay(calls, what=f"bench_system {kind}")

        # the first frames again, the kernel path against the twin path
        kern = system_mod.SLAMSystem(cfg, device=device)
        est_k = torch.stack([step(kern, t) for t in range(BENCH_REPLAY)])
        counts = _counts_3d()
        restore = _twin_path()
        try:
            twin = system_mod.SLAMSystem(cfg, device=device, capture=False)
            est_t = torch.stack([step(twin, t) for t in range(BENCH_REPLAY)])
        finally:
            restore()
        check(_counts_3d() == counts, "the twin path launched a kernel")
        eager = system_mod.SLAMSystem(cfg, device=device, capture=False)
        est_e = torch.stack([step(eager, t) for t in range(BENCH_REPLAY)])
        _same_state(f"bench_system {kind}", kern.state, eager.state)
        check(_bit_equal(est_k, est_e), f"bench_system {kind}: captured vs eager estimates differ")
        print(f"bench_system {kind} captured vs eager, {BENCH_REPLAY} frames: every state leaf "
              f"and estimate bit-equal")
        images = [torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in (inputs[BENCH_REPLAY] if kind == "stereo" else inputs[BENCH_REPLAY:][:1])]
        xi = {"frame": torch.cat([a.reshape(-1) for a in images] + [torch.as_tensor(
                  world.odom[BENCH_REPLAY], dtype=torch.float32, device=device)]),
              "noise": torch.zeros(cfg.filter.num_particles, eager.slam.noise_dim, device=device),
              "u0": torch.full((), 0.5, device=device),
              "u0_drawn": torch.ones((), dtype=torch.bool, device=device),
              "has_kf": eager._has_kf_dev}
        frame_fn = eager._image_frame(len(images), images[0].shape)
        _sync_free(f"bench_system {kind} image frame",
                   lambda: frame_fn((eager.state, eager._last_kf_dev), xi))
        for f in ("lm_valid", "lm_count"):
            a, b = getattr(kern.state, f), getattr(twin.state, f)
            check(torch.equal(a, b), f"{kind} kernel vs twin path: {f} differs in "
                  f"{int((a != b).sum())}")
        d = float((est_k - est_t).abs().max())
        check(d <= 1e-5, f"{kind} kernel vs twin path: estimates differ by {d}")
        print(f"bench_system {kind} kernel vs twin path, {BENCH_REPLAY} frames: lm_valid and "
              f"lm_count equal ({int(kern.state.lm_valid.sum())} live lanes), est max |diff| "
              f"{d:.3g}")

        # both systems on to the worlds' last frames, a frame of each kind profiled
        for s_ in (kern, eager):
            for t in range(BENCH_REPLAY, frames - BENCH_PROFILE):
                step(s_, t)
        last = range(frames - BENCH_PROFILE, frames)
        split = {mode: _frame_split(f"bench_system {kind}", mode, s_, step, last,
                                    host=mode == "captured")
                 for mode, s_ in (("captured", kern), ("eager", eager))}
        quiet = split["captured"]["no flush"][0]
        print(f"bench_system {kind}: {WARMUP} + {BENCH_FRAMES} frames, keyframes="
              f"{len(sys_.keyframes)} dispatches={len(calls)} resamples={n_res} launches "
              f"update_3d={launches[1]} score_3d={launches[0]} gather={launches[2]} "
              f"hamming_top2={launches[3]}; on a second run, frame {quiet['frame']} (no flush) "
              f"profiled: {quiet['launches']} launches, device busy {quiet['busy_ms']:.2f} of "
              f"{quiet['wall_ms']:.2f} ms, idle share {quiet['idle']:.3f}; "
              f"peak_mem={peak / 2**30:.3f} GiB; {_pool_facts(kern)}")
        out[kind] = dict(row=row, launches=launches, dispatches=len(calls),
                         peak_gib=peak / 2**30, idle=quiet["idle"], split=split)
        del sys_, kern, twin, eager
    return out


# -- phase 19: the captured step against the eager twin ------------------------

CAPTURE_PROFILE = {"corridor": (20, 20), "config 3": (1, 3)}  # eager, captured
CAPTURE_SPLIT_FRAMES = 6    # config 2's frames 91-96, timed one by one (flushes at 92, 96)
VERIFY_BATCHES = (1, 4, 16)  # closure candidates a flush window, F = 256
VERIFY_TURNS = 4            # steady verifies a batch shape, captured and eager in turns
POSEGRAPH_K = (64, 256, 2048)  # keyframes of the solve at E = 4K, 10 LM iterations
POSEGRAPH_TURNS = 2


def _api_calls(fn):
    """Host CUDA API calls of fn() under torch.profiler with the host's
    activity recorded (where the device's alone holds none of them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA
               and _is_api(e.name))


def _path_profile(what, mode, fn, n):
    """Launches, host CUDA API calls, device busy, wall and idle share per
    frame of n frames run by fn() under torch.profiler recording the
    device's activity (the API calls from a second profile with the host's
    too, where the first holds none)."""
    api = []
    n_dev, busy, wall, _ = _profile(fn, api)
    api = api[0] or _api_calls(fn)
    row = {"launches": n_dev / n, "api_calls": api / n, "busy_ms": busy / n,
           "wall_ms": wall / n, "idle": 1 - busy / wall}
    print(f"captured vs eager {what} {mode}, {n} frames profiled: {row['launches']:.0f} device "
          f"launches, {row['api_calls']:.0f} host CUDA API calls, device busy "
          f"{row['busy_ms']:.3f} of {row['wall_ms']:.3f} ms a frame, idle share {row['idle']:.3f}")
    return row


def _graph_facts(cs):
    return {"capture_s": cs.capture_s, "instantiate_s": cs.instantiate_s,
            "pool_bytes": cs.pool_bytes, "per_replay": cs.launches_per_replay}


def _bit_equal(a, b):
    """Tensors or arrays equal bit for bit: the same shape, dtype and bits
    (NaN lanes compare by their bits; -0.0 and 0.0 differ)."""
    import numpy as np
    import torch

    if isinstance(a, np.ndarray):
        a, b = torch.from_numpy(a), torch.from_numpy(np.asarray(b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(bits), b.contiguous().view(bits)
    return torch.equal(a, b)


def _same_state(what, a, b):
    import torch

    for f in STATE_KEYS + ("lm_desc",):
        x, y = getattr(a, f), getattr(b, f)
        check(_bit_equal(x, y), f"{what}: captured vs eager {f} differs in "
                                f"{int((x != y).sum())} entries (NaN: "
                                f"{int(torch.isnan(x).sum()) if x.is_floating_point() else 0} and "
                                f"{int(torch.isnan(y).sum()) if y.is_floating_point() else 0})")


def _same_system(what, cap, eager, est_cap, est_eager):
    """Two SLAMSystem runs over the same frames, captured and eager: the
    estimates, every state leaf, the keyframe reference, the pose graph,
    the keyframes and the closures bit-equal."""
    import numpy as np
    import torch

    check(_bit_equal(est_cap, est_eager), f"{what}: captured vs eager estimates differ")
    _same_state(what, cap.state, eager.state)
    check(_bit_equal(cap._last_kf_dev, eager._last_kf_dev), f"{what}: keyframe references differ")
    for f in ("poses", "node_valid", "edge_ij", "edge_rel", "edge_info", "edge_valid"):
        check(_bit_equal(getattr(cap.graph, f), getattr(eager.graph, f)),
              f"{what}: captured vs eager graph {f} differs")
    check([(k.index, k.frame, k.pose.tobytes(), k.points_kf.tobytes(), k.desc.tobytes())
           for k in cap.keyframes]
          == [(k.index, k.frame, k.pose.tobytes(), k.points_kf.tobytes(), k.desc.tobytes())
              for k in eager.keyframes], f"{what}: captured vs eager keyframes differ")
    check(cap.loop_closures == eager.loop_closures, f"{what}: captured vs eager closures differ")


def _system_steps(sys_):
    """Every CapturedStep a system built: its frames, verify batches,
    pose-graph solves, closure matches, dedup steps and BA iterations."""
    steps = [*sys_._frame_steps.values(), *sys_._verify_steps.values(),
             *sys_._match_steps.values(), *sys_._dedup_steps.values()]
    for solver in (sys_._pg_solver, sys_._ba_solver):
        steps += list(solver.steps.values()) if solver else []
    return steps


def _pool_facts(sys_):
    """The captured steps of a system with their capture and instantiation
    seconds and what the shared pool grew by at each capture."""
    steps = [c for c in _system_steps(sys_) if c._graph is not None]
    return (f"{len(steps)} graphs captured in {sum(c.capture_s for c in steps):.3f} s, "
            f"instantiated in {sum(c.instantiate_s for c in steps):.3f} s, the shared pool "
            f"{sum(c.pool_bytes for c in steps) / 2**20:.1f} MiB")


def _frame_split(what, mode, sys_, step, indices, host=True):
    """Frames i of `indices` through step(sys_, i); the first frame without
    a flush and the first flush frame (one that reads the keyframe flags:
    every frame before the first keyframe, then every kf_flag_lag-th) each
    under a torch.profiler of its own (a profile costs ~1.5 s to set up):
    the device launches, host CUDA API calls (but the profile's own
    `cudaDeviceSynchronize`), graph launches, device busy and wall ms and
    the idle share. `host` records the host's activity too."""
    rows = {"no flush": [], "flush": []}
    for i in indices:
        flush = not sys_._has_kf or (sys_.frame_idx + 1) % sys_.kf_flag_lag == 0
        if rows["flush" if flush else "no flush"]:
            step(sys_, i)
            continue
        names = {}
        n_dev, busy, wall, _ = _profile(lambda: step(sys_, i), names=names, host=host)
        # the profile's own synchronize is no call of the frame's
        api = sum(n for name, n in names.items() if _is_api(name)
                  and name != "cudaDeviceSynchronize")
        rows["flush" if flush else "no flush"].append(
            {"frame": i, "launches": n_dev, "api_calls": api,
             "graph_launches": names.get("cudaGraphLaunch", 0), "busy_ms": busy,
             "wall_ms": wall, "idle": 1 - busy / wall,
             "api": {k: v for k, v in names.items() if _is_api(k)}})
    for kind, rs in rows.items():
        if rs:
            print(f"captured vs eager {what} {mode}, {kind}: "
                  + "; ".join(f"frame {r['frame']}: {r['launches']} launches, {r['api_calls']} "
                              f"host CUDA API calls ({r['graph_launches']} graph launches), "
                              f"busy {r['busy_ms']:.3f} of {r['wall_ms']:.3f} ms, idle "
                              f"{r['idle']:.3f}" for r in rs))
            if mode == "captured" and kind == "no flush":
                print(f"captured vs eager {what}: the API calls of frame {rs[-1]['frame']}: "
                      f"{rs[-1]['api']}")
    return rows


def _same_run(what, cap, eager):
    """run_sequence results (state, est, metrics), captured and eager."""
    import torch

    _same_state(what, cap[0], eager[0])
    check(_bit_equal(cap[1], eager[1]), f"{what}: captured vs eager estimates differ")
    for k in ("ess", "num_landmarks", "match_frac", "resampled"):
        a = torch.stack([getattr(m, k) for m in cap[2]])
        b = torch.stack([getattr(m, k) for m in eager[2]])
        check(_bit_equal(a, b), f"{what}: captured vs eager metric {k} differs")


def _sync_free(what, fn):
    """fn() (one eager step on device inputs) under
    torch.cuda.set_sync_debug_mode("error"): a call that waits for the
    device raises."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        check(False, f"{what}: the eager step waits for the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"captured vs eager {what}: one eager step under set_sync_debug_mode('error') "
          "reads nothing on the host")


def _sequence_paths(what, slam, state0, data, noise, u0, obs_desc, profile_frames):
    """run_sequence eager and captured from the same draws: equal, timed,
    profiled."""
    import torch

    from parakeet_slam_tpu_torch.core.state import Observation
    from parakeet_slam_tpu_torch.filter import run_sequence

    T = len(data[0])
    kw = dict(motion_noise=noise, resample_u0=u0, obs_desc=obs_desc)
    out, fps = {}, {}
    for mode in ("eager", "captured", "captured"):  # the second captured run replays alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[mode] = run_sequence(slam, state0, *data, capture=mode == "captured", **kw)
        torch.cuda.synchronize()
        fps[mode] = T / (time.perf_counter() - t0)
        if mode == "captured" and "capture" not in fps:
            fps["capture"] = fps[mode]  # first captured run: warm-up frame, capture
    _same_run(what, out["captured"], out["eager"])
    cs = slam._sequence_step[1]
    facts = _graph_facts(cs)
    n_eager, n_cap = profile_frames
    obs = [Observation(z=data[1][t], sig=data[2][t], desc=obs_desc[t], valid=data[3][t])
           for t in range(T)]

    def eager_frames():
        st = state0.clone()
        for t in range(n_eager):
            st, _ = slam.step(st, data[0][t], obs[t], noise[t], u0[t])
            slam.estimate_pose(st)

    def captured_frames():
        cs.inputs["t"].zero_()
        for _ in range(n_cap):
            cs()

    prof = {"eager": _path_profile(what, "eager", eager_frames, n_eager),
            "captured": _path_profile(what, "captured", captured_frames, n_cap)}
    st = state0.clone()
    st, _ = slam.step(st, data[0][0], obs[0], noise[0], u0[0])
    _sync_free(what, lambda: slam.estimate_pose(slam.step(st, data[0][1], obs[1], noise[1],
                                                            u0[1])[0]))
    print(f"captured vs eager {what}: {T} frames, every state leaf, estimate and metric "
          f"bit-equal; frames/s eager {fps['eager']:.2f}, captured {fps['captured']:.2f} "
          f"(first captured run, with its warm-up frame and the capture: {fps['capture']:.2f}); "
          f"capture {facts['capture_s']:.3f} s, instantiate {facts['instantiate_s']:.3f} s, "
          f"graph pool {facts['pool_bytes'] / 2**20:.1f} MiB, launches counted per replay "
          f"{facts['per_replay']}")
    return {"fps": fps, "graph": facts, "profile": prof,
            "resamples": int(sum(bool(m.resampled) for m in out["eager"][2]))}


def phase_captured(device, desk):
    """The captured step (`filter/captured.py`) against its eager twin from
    the same draws, on the corridor (config 1, one seed, 500 frames),
    config 3's filter (10 frames) and config 2's system (phase 10's run
    against an eager run over the same frames); the pyramid frame, closure
    verification and the pose-graph solve; config 4's frame under the sync
    check."""
    import dataclasses

    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import cli, system
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.data import make_corridor, make_drive_world
    from parakeet_slam_tpu_torch.data.synth_vision import make_hall_world
    from parakeet_slam_tpu_torch.filter import captured, make_filter
    from parakeet_slam_tpu_torch.filter.runner import draw_noise
    from parakeet_slam_tpu_torch.kernels import resample as resample_kernel

    res = {}
    t0 = time.perf_counter()
    # config 1: the corridor, seed 0
    cfg = cli.corridor_config()
    sim = make_corridor(num_landmarks=100, num_steps=500, max_obs=cfg.max_observations, seed=7)
    slam = make_filter(cfg)
    data = cli.sim_tensors(sim, device)
    noise, u0 = draw_noise(500, cfg.num_particles, slam.noise_dim,
                           torch.Generator(device=device).manual_seed(0), device)
    desc = torch.zeros(500, cfg.max_observations, 0, dtype=torch.int32, device=device)
    res["corridor"] = _sequence_paths(
        "corridor", slam, slam.init_state(init_pose=sim.gt_pose[0], device=device), data, noise,
        u0, desc, CAPTURE_PROFILE["corridor"])
    del slam, data
    print(f"captured vs eager corridor: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # config 3's filter, 10 frames of the drive world
    cfg3 = load_config(os.path.join(HERE, "configs/kitti_00.yaml"))
    fc = cfg3.filter
    slam = make_filter(fc, cfg3.frontend)
    frames = 10
    world = make_drive_world(num_steps=frames)
    data = vision_sequence(world, frames, fc.max_observations, fc.desc_words, device)
    noise, u0 = draw_noise(frames, fc.num_particles, slam.noise_dim,
                           torch.Generator(device=device).manual_seed(0), device)
    res["config 3"] = _sequence_paths(
        "config 3", slam, slam.init_state(init_pose=world.gt_pose[0], device=device), data[:4],
        noise, u0, data[4], CAPTURE_PROFILE["config 3"])
    # the price of the resample decided on the device, at config 3's 1.78 GB
    # state: the gather at the identity indices (a frame without a resample)
    # and the copy of the new state into the static buffers
    st = slam._sequence_step[1].state
    keep = torch.arange(st.num_particles, device=device)
    spare = captured.clone(st)
    ms_gather = cuda_ms(lambda: resample_kernel.gather_particles(st, keep), 5)
    ms_copy = cuda_ms(lambda: captured.copy_into(spare, st), 5)
    mb = sum(t.numel() * t.element_size() for t in captured.leaves(st)) / 1e6
    print(f"captured vs eager config 3: the identity gather {ms_gather:.4f} ms and the "
          f"write-back copy {ms_copy:.4f} ms a frame ({mb:.1f} MB of state; medians of 5 calls)")
    res["config 3"].update(ms_identity_gather=ms_gather, ms_write_back=ms_copy)
    del slam, data, st, spare
    torch.cuda.empty_cache()
    print(f"captured vs eager config 3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # config 2's system: phase 10's captured run against an eager run, both
    # through sequence_ate's final flush, closure resolution and solve
    cfg2, images, odom = desk["cfg"], desk["images"], desk["odom"]
    cap = desk["system"]
    eager = system.SLAMSystem(cfg2, device=device, capture=False)
    est, fps_e, _ = cli.run_image_sequence(eager, images, odom)
    eager.flush_flags()
    eager.flush_metrics()
    check(_bit_equal(eager.graph.poses.cpu().numpy(), desk["graph_poses"]),
          "config 2: captured vs eager graph poses differ")
    for f, v in desk["state"].items():
        x = getattr(eager.state, f)
        check(_bit_equal(x, v), f"config 2: captured vs eager {f} differs in "
                                f"{int((x != v).sum())} entries")
    est_opt, _ = cli.sequence_ate(eager, est, desk["gt"], odom, cfg2)
    check(_bit_equal(est_opt, desk["est_opt"]),
          "config 2: captured vs eager corrected trajectories differ")
    _same_system("config 2", cap, eager, desk["est"], est)
    frame_keys = [k for k in cap._frame_steps]
    solves = sorted(cap._pg_solver.steps) if cap._pg_solver else []
    print(f"captured vs eager config 2: {len(images)} frames, estimates, the corrected "
          f"trajectory, graph poses, every state leaf, keyframes ({len(eager.keyframes)}) and "
          f"closures ({len(eager.loop_closures)}) bit-equal; frames/s eager {fps_e:.3f}, captured "
          f"{desk['fps']:.3f} (phase 10, from frame 3); frame steps {frame_keys}, verify batch "
          f"shapes {sorted(cap._verify_steps)}, solve views {solves}; {_pool_facts(cap)}; "
          f"launches counted per frame replay "
          f"{[c.launches_per_replay for c in cap._frame_steps.values()]}")
    n = CAPTURE_SPLIT_FRAMES
    step = lambda s_, i: s_.process_frame(images[i], odom[i])  # noqa: E731
    split = {"captured": _frame_split("config 2", "captured", cap, step,
                                      range(len(images) - n, len(images))),
             "eager": _frame_split("config 2", "eager", eager, step,
                                   range(len(images) - 2, len(images)), host=False)}
    # the same kind of frames unprofiled, one by one on the host's clock
    # (the profiler adds its own time to each of a graph's ~20,000 nodes)
    host_ms = {"no flush": [], "flush": []}
    for i in range(len(images) - CAPTURE_SPLIT_FRAMES, len(images)):
        flush = (cap.frame_idx + 1) % cap.kf_flag_lag == 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cap.process_frame(images[i], odom[i])
        torch.cuda.synchronize()
        host_ms["flush" if flush else "no flush"].append((time.perf_counter() - t1) * 1e3)
    busy = np.median([r["busy_ms"] for r in split["captured"]["no flush"]])
    print(f"captured vs eager config 2 captured, unprofiled on the host's clock: frames "
          f"without a flush {[round(t, 3) for t in host_ms['no flush']]} ms, flush frames "
          f"{[round(t, 3) for t in host_ms['flush']]} ms; idle share of a frame without a flush "
          f"{1 - busy / np.median(host_ms['no flush']):.3f} (its profiled device busy "
          f"{busy:.3f} ms over the median)")
    split["host_ms"] = host_ms
    quiet = split["captured"]["no flush"]
    check(quiet and all(r["graph_launches"] == 1 for r in quiet),
          f"config 2: a captured frame without a flush is not one graph launch: {quiet}")
    # the frontend is inside the graph: the host launches the draws alone
    kernels = [r["api"].get("cudaLaunchKernel", 0) for r in quiet]
    check(max(kernels) <= 2 and min(r["launches"] for r in quiet) > 1000,
          f"config 2: the host launched {kernels} kernels in frames without a flush")
    print(f"captured vs eager config 2: the frontend runs inside the frame's graph "
          f"(frames without a flush: {[r['launches'] for r in quiet]} device launches, "
          f"{kernels} launched from the host)")
    img = torch.as_tensor(images[-1], device=device)
    obs = eager._mono_observation(img)
    x = {"u": torch.as_tensor(odom[-1], dtype=torch.float32, device=device), "obs": obs,
         "noise": torch.zeros(cfg2.filter.num_particles, eager.slam.noise_dim, device=device),
         "u0": torch.full((), 0.5 / cfg2.filter.num_particles, device=device),
         "has_kf": eager._has_kf_dev}
    _sync_free("config 2", lambda: eager._frame((eager.state, eager._last_kf_dev), x))
    xi = {"frame": torch.cat([img.reshape(-1), x["u"]]), "noise": x["noise"],
          "u0": torch.full((), 0.5, device=device),
          "u0_drawn": torch.ones((), dtype=torch.bool, device=device), "has_kf": x["has_kf"]}
    frame_fn = eager._image_frame(1, img.shape)
    _sync_free("config 2 image frame (frontend, observation, step)",
               lambda: frame_fn((eager.state, eager._last_kf_dev), xi))
    res["config 2"] = {"fps": {"eager": fps_e, "captured": desk["fps"]},
                       "graph": {"pool": _pool_facts(cap)}, "split": split}
    del eager
    print(f"captured vs eager config 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    res["pyramid"] = check_pyramid_frame(device, desk)
    res["verify"] = check_verify(device, cfg2)
    res["rotation_fit"] = check_rotation_fit(device)
    res["posegraph"] = check_posegraph(device)
    check_offline_sync(device, cfg2)
    print(f"captured vs eager pyramid, verify, pose graph, offline programs: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # config 4's frame (configs/euroc_mh.yaml) under the sync check, after one frame
    cfg4 = load_config(os.path.join(HERE, "configs/euroc_mh.yaml"))
    hall = make_hall_world(num_steps=EUROC_WORLD_STEPS, session=0)
    hall = dataclasses.replace(hall, gt_pose=hall.gt_pose[:2], odom=hall.odom[:2])
    s4 = system.SLAMSystem(cfg4, device=device, capture=False)
    s4.process_frame(hall.render(0), hall.odom[0])
    obs = s4._to_observation(*s4._frontend(torch.as_tensor(hall.render(1), device=device)))
    x = {"u": torch.as_tensor(hall.odom[1], dtype=torch.float32, device=device), "obs": obs,
         "noise": torch.zeros(cfg4.filter.num_particles, s4.slam.noise_dim, device=device),
         "u0": torch.full((), 0.5 / cfg4.filter.num_particles, device=device),
         "has_kf": s4._has_kf_dev}
    _sync_free("config 4", lambda: s4._frame((s4.state, s4._last_kf_dev), x))
    print(f"captured vs eager config 4: {time.perf_counter() - t0:.1f} s")
    print("captured vs eager paths: " + json.dumps(res))
    return res


def check_pyramid_frame(device, desk):
    """Config 2 with a 2-level pyramid (`frontend.pyramid_levels: 2`),
    captured against eager over 3 frames (the warm-up, the capture and a
    replay): every state leaf and estimate bit-equal."""
    import dataclasses

    import torch

    from parakeet_slam_tpu_torch import system

    cfg = desk["cfg"]
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, pyramid_levels=2))
    images, odom = desk["images"], desk["odom"]
    cap = system.SLAMSystem(cfg, device=device)
    eager = system.SLAMSystem(cfg, device=device, capture=False)
    for i in range(3):
        a, b = cap.process_frame(images[i], odom[i]), eager.process_frame(images[i], odom[i])
        check(_bit_equal(a, b), f"pyramid frame {i}: captured vs eager estimates differ")
    _same_state("pyramid", cap.state, eager.state)
    step = next(iter(cap._frame_steps.values()))
    check(step._graph is not None, "pyramid: the frame was not captured")
    img = torch.as_tensor(images[3], device=device)
    u = torch.as_tensor(odom[3], dtype=torch.float32, device=device)
    xi = {"frame": torch.cat([img.reshape(-1), u]),
          "noise": torch.zeros(cfg.filter.num_particles, eager.slam.noise_dim, device=device),
          "u0": torch.full((), 0.5, device=device),
          "u0_drawn": torch.ones((), dtype=torch.bool, device=device), "has_kf": eager._has_kf_dev}
    frame_fn = eager._image_frame(1, img.shape)
    _sync_free("pyramid image frame", lambda: frame_fn((eager.state, eager._last_kf_dev), xi))
    print(f"captured vs eager pyramid (config 2, 2 levels): 3 frames, every state leaf and "
          f"estimate bit-equal; {_pool_facts(cap)}")
    return {"pool": _pool_facts(cap)}


def _correspondences(rng, F, n, outliers):
    """Closure correspondences in front of a pinhole camera: pa [F, 3] in
    the keyframe's frame, pb = T(pa) in the old one with 1 cm noise, the
    first `outliers` rows moved by up to 3 m, the first n rows valid."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.core import geometry

    pa = np.stack([rng.uniform(-1.5, 1.5, F), rng.uniform(-1, 1, F), rng.uniform(2, 6, F)], 1)
    q = np.concatenate([0.05 * rng.normal(size=3), [1.0]])
    rel = np.concatenate([rng.uniform(-0.3, 0.3, 3), q / np.linalg.norm(q)]).astype(np.float32)
    pb = geometry.se3_apply(torch.as_tensor(rel)[None], torch.as_tensor(pa, dtype=torch.float32))
    pb = pb.numpy() + 0.01 * rng.normal(size=pa.shape)
    pb[:outliers] += rng.uniform(-3, 3, (outliers, 3))
    valid = np.arange(F) < n
    pa[~valid] = 0.0
    pb[~valid] = 0.0
    return pa.astype(np.float32), pb.astype(np.float32), valid


def check_verify(device, cfg2):
    """Closure verification (`SLAMSystem._verify_batch`: Horn's three
    consensus rounds with `rotation_fit`, then the refine, one graph)
    captured against eager at Nc = 1, 4, 16 candidates of F = 256
    correspondences, with the reprojection refine and the depth-relaxed
    one: three batches each (the warm-up, the capture, a replay), rels and
    inliers bit-equal; then VERIFY_TURNS more in turns on the host's clock;
    one graph launch, HORN_ROUNDS rotation_fit launches counted and the host
    CUDA API calls of a verify under the profiler; one eager verification of
    each under the sync check."""
    import dataclasses

    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import system
    from parakeet_slam_tpu_torch.kernels import horn

    rng = np.random.default_rng(13)
    F = cfg2.frontend.max_features
    out = {}
    for sigma in (0.0, 0.3):
        cfg = dataclasses.replace(cfg2, backend=dataclasses.replace(
            cfg2.backend, loop_refine_depth_sigma=sigma))
        cap = system.SLAMSystem(cfg, device=device)
        eager = system.SLAMSystem(cfg, device=device, capture=False)
        name = "depth-relaxed refine" if sigma else "refine"
        for Nc in VERIFY_BATCHES:
            ms = {"captured": [], "eager": []}
            for turn in range(3 + VERIFY_TURNS):
                if turn < 3:
                    batch = [_correspondences(rng, F, int(rng.integers(20, F)),
                                              int(rng.integers(0, 10))) for _ in range(Nc)]
                    pa, pb, v = (np.stack([b[i] for b in batch]) for i in range(3))
                res = {}
                order = (("captured", cap), ("eager", eager))
                for mode, s_ in order[::-1] if turn % 2 else order:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    res[mode] = s_._verify_batch(pa, pb, v)
                    ms[mode].append((time.perf_counter() - t1) * 1e3)
                check(_bit_equal(res["captured"][0], res["eager"][0])
                      and _bit_equal(res["captured"][1], res["eager"][1]),
                      f"verify {name} Nc={Nc}: captured vs eager differ")
            names = {}
            _profile(lambda: cap._verify_batch(pa, pb, v), names=names, host=True)
            check(names.get("cudaGraphLaunch") == 1,
                  f"verify {name} Nc={Nc}: {names.get('cudaGraphLaunch')} graph launches")
            api = sum(n for k, n in names.items() if _is_api(k) and k != "cudaDeviceSynchronize")
            n0 = horn.rotation_fit.launches
            cap._verify_batch(pa, pb, v)
            check(horn.rotation_fit.launches == n0 + HORN_ROUNDS,
                  f"verify {name} Nc={Nc}: rotation_fit counted "
                  f"{horn.rotation_fit.launches - n0} launches a replay")
            steady = {m: float(np.median(t[3:])) for m, t in ms.items()}
            print(f"captured vs eager verify ({name}) Nc={Nc} F={F}: {3 + VERIFY_TURNS} verifies "
                  f"of 3 batches, rels and inliers bit-equal; 1 graph launch ({HORN_ROUNDS} "
                  f"rotation_fit among its kernels) and {api} host CUDA API calls a verify; ms a "
                  f"verify on the host's clock captured {[round(t, 3) for t in ms['captured']]} "
                  f"eager {[round(t, 3) for t in ms['eager']]} (the first captured one eager, "
                  f"the second the capture; medians of the last {VERIFY_TURNS}, in turns: "
                  f"captured {steady['captured']:.3f}, eager {steady['eager']:.3f})")
            x = {k: torch.as_tensor(a, device=device) for k, a in (("pa", pa), ("pb", pb),
                                                                 ("valid", v))}
            _sync_free(f"verify {name} Nc={Nc} (Horn's consensus and the refine)",
                       lambda: eager._verify_candidates(x["pa"], x["pb"], x["valid"]))
            out[f"{name} Nc={Nc}"] = {"ms": ms, "steady_ms": steady, "api_calls": api}
        print(f"captured vs eager verify ({name}): {_pool_facts(cap)}")
        del cap, eager
    return out


# Horn's rotation fit (csrc/horn.cu): the rounds of a verify, the tolerances
# and the operations of a matrix, counted from the kernel's float64
# arithmetic: 14 to build N; 23 a convergence test (one more test than
# sweeps); 57 a Jacobi rotation, six a sweep; 55 to normalize q and write R.
HORN_ROUNDS = 3
HORN_TOL_F64 = 1e-6    # |R - float64 Kabsch| where the fit is unique
HORN_TOL_TWIN = 1e-5   # + HORN_TWIN_SLOPE * sigma_1 / gap against the float32 SVD twin
HORN_TWIN_SLOPE = 1e-6
HORN_OPS_FIXED, HORN_OPS_TEST, HORN_OPS_SWEEP = 14 + 23 + 55, 23, 6 * 57


def _horn_covariances(rng, kind, n):
    """n float64 cross-covariances M [n, 3, 3] of one kind: "closure" from
    `_correspondences` as Horn's first round fits them, "spread" with
    sigma_2 / sigma_1 log-uniform in [2.5e-3, 1] and sigma_3 in [0, sigma_2
    / 2] (so the gap sigma_2 + sign(det M) sigma_3 stays above 1e-3 sigma_1
    and the fit unique), det of either sign and scales from 1e-2 to 1e2,
    "coplanar" (sigma_3 = 0), "reflection" (det < 0), "rank1", "zero"."""
    import numpy as np

    if kind == "closure":
        out = []
        for _ in range(n):
            pa, pb, v = _correspondences(rng, 256, int(rng.integers(20, 256)),
                                         int(rng.integers(0, 10)))
            w = v[:, None].astype(np.float64)
            cnt = max(w.sum(), 1.0)
            xa = (pa - (pa * w).sum(0) / cnt) * w  # the round fits pb ~ T(pa)
            xb = (pb - (pb * w).sum(0) / cnt) * w
            out.append(xb.T @ xa / cnt)
        return np.stack(out)
    if kind == "zero":
        return np.zeros((n, 3, 3))
    U, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    V, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    s2 = 10.0 ** rng.uniform(-2.6, 0, n)
    s = np.stack([np.ones(n), s2, rng.uniform(0, 0.5, n) * s2], -1)
    if kind == "coplanar":
        s[:, 2] = 0.0
    if kind == "rank1":
        s[:, 1:] = 0.0
    M = (U * s[:, None, :]) @ np.swapaxes(V, 1, 2) * 10.0 ** rng.uniform(-2, 2, (n, 1, 1))
    if kind == "reflection":
        M = M * np.sign(np.linalg.det(M))[:, None, None] * np.array([1.0, 1.0, -1.0])
    return M


def check_rotation_fit(device):
    """`rotation_fit` (csrc/horn.cu) against its twin, `torch.linalg.svd` and
    `det` on the card run eagerly, and against a float64 Kabsch fit on the
    host: on closure covariances and spread, coplanar and reflected
    matrices, where the fit is unique, within HORN_TOL_F64 of float64 and
    within HORN_TOL_TWIN + HORN_TWIN_SLOPE * sigma_1 / gap of the twin (its
    float32 SVD's error grows as the gap, sigma_2 + sign(det M) sigma_3,
    closes); on every kind, rank-1 and zero too, a proper rotation (R R^T =
    I and det R = 1 within 1e-6) that is optimal (tr(R^T M) within 1e-6
    sigma_1 of the best); a strided input; one launch counted a call. Then
    the times at the main path's largest batch (B = 16): the kernel's
    device time and the twin's, and the bound from this run's sweeps."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.kernels import horn

    rng = np.random.default_rng(29)
    err_f64 = err_twin = 0.0
    sweeps_seen = []
    for kind in ("closure", "spread", "coplanar", "reflection", "rank1", "zero"):
        M = _horn_covariances(rng, kind, 64 if kind == "closure" else 4096)
        M32 = torch.as_tensor(M, dtype=torch.float32, device=device)
        M = M32.double().cpu().numpy()  # the float32 input, exactly
        sweeps = torch.zeros(len(M), dtype=torch.int32, device=device)
        n0 = horn.rotation_fit.launches
        R = horn.rotation_fit(M32, sweeps)
        torch.cuda.synchronize()
        check(horn.rotation_fit.launches == n0 + 1, f"rotation_fit {kind}: not launched")
        R = R.double().cpu().numpy()
        sweeps_seen.append(int(sweeps.max()))
        U, S, Vt = np.linalg.svd(M)
        d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
        best = S[:, 0] + S[:, 1] + d * S[:, 2]
        check(np.isfinite(R).all(), f"rotation_fit {kind}: not finite")
        orth = float(np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max())
        det = float(np.abs(np.linalg.det(R) - 1.0).max())
        gap_obj = float((np.abs(np.einsum("nij,nij->n", R, M) - best)
                         / np.maximum(S[:, 0], 1e-30)).max())
        check(orth <= 1e-6 and det <= 1e-6 and gap_obj <= 1e-6,
              f"rotation_fit {kind}: |R R^T - I| {orth:.3g}, |det - 1| {det:.3g}, objective "
              f"{gap_obj:.3g} of sigma_1 below the best")
        line = (f"rotation_fit {kind} B={len(M)}: proper (|R R^T - I| {orth:.2g}, |det - 1| "
                f"{det:.2g}), optimal within {gap_obj:.2g} sigma_1, sweeps <= {sweeps_seen[-1]}")
        if kind not in ("rank1", "zero"):
            gap = (S[:, 1] + d * S[:, 2]) / S[:, 0]
            check(gap.min() > 1e-3, f"rotation_fit {kind}: a case with gap {gap.min():.3g}")
            ref = ((U * np.stack([np.ones_like(d), np.ones_like(d), d], -1)[:, None, :]) @ Vt)
            twin = horn.rotation_fit_reference(M32).double().cpu().numpy()
            e64 = np.abs(R - ref).max((1, 2))
            etw = np.abs(R - twin).max((1, 2))
            tol = HORN_TOL_TWIN + HORN_TWIN_SLOPE / gap
            check(e64.max() <= HORN_TOL_F64, f"rotation_fit {kind}: {e64.max():.3g} from float64")
            check((etw <= tol).all(), f"rotation_fit {kind}: {int((etw > tol).sum())} matrices "
                                      f"beyond the twin's tolerance, max {etw.max():.3g}")
            err_f64, err_twin = max(err_f64, float(e64.max())), max(err_twin, float(etw.max()))
            line += (f"; max |R - float64 Kabsch| {e64.max():.3g}, max |R - twin| {etw.max():.3g}"
                     f" (gap from {gap.min():.3g})")
        print(line)
    # a strided view, and an empty batch
    M32 = torch.as_tensor(_horn_covariances(rng, "spread", 100), dtype=torch.float32,
                          device=device)
    wide = torch.zeros(100, 4, 5, device=device)
    wide[:, :3, 1:4] = M32
    check(_bit_equal(horn.rotation_fit(wide[:, :3, 1:4]), horn.rotation_fit(M32)),
          "rotation_fit: a strided input differs")
    n0 = horn.rotation_fit.launches
    check(horn.rotation_fit(M32[:0]).shape == (0, 3, 3) and horn.rotation_fit.launches == n0,
          "rotation_fit: an empty batch")
    print("rotation_fit: a strided input bit-equal to its contiguous copy; an empty batch "
          "launches nothing")

    # times at B = 16 (three launches a verify at Nc = 16); the twin's
    # svd and det wait on the host, so its time is between CUDA events
    # around single calls
    B = VERIFY_BATCHES[-1]
    M32 = torch.as_tensor(_horn_covariances(rng, "closure", B), dtype=torch.float32,
                          device=device)
    sweeps = torch.zeros(B, dtype=torch.int32, device=device)
    horn.rotation_fit(M32, sweeps)
    ms = queued_ms(lambda i: horn.rotation_fit(M32))
    plain = cuda_ms(lambda: horn.rotation_fit_reference(M32), 20)
    n_sweeps = int(sweeps.sum())
    ops = HORN_OPS_FIXED * B + HORN_OPS_TEST * n_sweeps + HORN_OPS_SWEEP * n_sweeps
    bnd = bound(2 * nbytes(M32), ops, PEAK_F64)
    ms_b1 = queued_ms(lambda i: horn.rotation_fit(M32[:1]))
    print(f"rotation_fit B={B}: kernel={ms:.5f} ms (B=1 {ms_b1:.5f}) twin (linalg.svd, det, "
          f"eager)={plain:.5f} ms bound={bnd[0]:.3g} ms ({bnd[1]}: {2 * nbytes(M32)} bytes, "
          f"{ops} float64 operations over {n_sweeps} sweeps)")
    return {"err": err_twin, "err_f64": err_f64, "ms": ms, "ms_b1": ms_b1, "plain": plain,
            "bound": bnd, "sweeps_max": max(sweeps_seen)}


def check_posegraph(device):
    """The pose-graph solve (10 LM iterations, `posegraph.CapturedSolver`)
    captured against eager at K = 64, 256, 2048 keyframes with E = 4K
    edges (`ab_kernels.posegraph_case`): after the captured solver's
    warm-up (an eager solve) and capture, in turns, poses and costs
    bit-equal to the capture's; one graph launch a solve; the captured and
    eager ms between CUDA events; capture, instantiation, the pool; one
    eager solve under the sync check."""
    import torch

    from parakeet_slam_tpu_torch.backend import posegraph as pg
    from parakeet_slam_tpu_torch.eval.ab_kernels import posegraph_case

    solver = pg.CapturedSolver(iters=10, graph=True, pool=torch.cuda.graph_pool_handle())

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), res

    out = {}
    reserved = torch.cuda.memory_reserved()
    for K in POSEGRAPH_K:
        g = posegraph_case(K, device)
        eager = lambda: pg.optimize_pose_graph(g, iters=10)  # noqa: E731
        for _ in range(2):  # the warm-up (the eager solve, on a side stream), the capture
            got = timed(lambda: solver(g))[1]
        ref = got
        ms = {"captured": [], "eager": []}
        for _ in range(POSEGRAPH_TURNS):
            for mode, fn in (("eager", eager), ("captured", lambda: solver(g))):
                t, res = timed(fn)
                ms[mode].append(t)
                check(_bit_equal(res[0].poses, ref[0].poses) and _bit_equal(res[1], ref[1]),
                      f"pose graph K={K}: the {mode} solve differs from the capture's")
        names = {}
        _profile(lambda: solver(g), names=names, host=True)
        check(names.get("cudaGraphLaunch") == 1,
              f"pose graph K={K}: {names.get('cudaGraphLaunch')} graph launches a solve")
        step = solver.steps[(K, 4 * K)]
        print(f"captured vs eager pose graph K={K} E={4 * K}, 10 LM: poses and costs bit-equal "
              f"(cost {float(ref[1][0]):.6g} -> {float(ref[1][-1]):.6g}); 1 graph launch a solve, "
              f"{sum(n for k, n in names.items() if _is_api(k) and k != 'cudaDeviceSynchronize')} "
              f"host CUDA API calls; ms captured "
              f"{[round(t, 3) for t in ms['captured']]} eager {[round(t, 3) for t in ms['eager']]}"
              f" (in turns); capture {step.capture_s:.3f} s, instantiate "
              f"{step.instantiate_s:.3f} s, pool grew by {step.pool_bytes / 2**20:.1f} MiB")
        out[K] = {"ms": ms, "capture_s": step.capture_s, "instantiate_s": step.instantiate_s,
                  "pool_bytes": step.pool_bytes}
        del g, ref, got, res
    g = posegraph_case(POSEGRAPH_K[0], device)
    _sync_free("pose graph solve", lambda: pg.optimize_pose_graph(g, iters=10))
    print(f"captured vs eager pose graph: the shared pool of {len(solver.steps)} graphs "
          f"{sum(c.pool_bytes for c in solver.steps.values()) / 2**20:.1f} MiB; reserved "
          f"{(torch.cuda.memory_reserved() - reserved) / 2**20:.1f} MiB more than before")
    return out


def check_offline_sync(device, cfg2):
    """One eager call of each offline program under the sync check, after
    a warm-up call: the bucketed BA iteration with pose edges on both
    solvers (at the bench problem's width, 16 cameras), a dedup keyframe
    step and a closure match at config 2's widths."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import system
    from parakeet_slam_tpu_torch.backend import ba, graph
    from parakeet_slam_tpu_torch.eval.kernel_inputs import BA_BENCH_CAMERA, ba_bench_problem
    from parakeet_slam_tpu_torch.frontend.camera import Pinhole

    C = 16
    bk = graph.pack_buckets(graph.make_ba_problem(**ba_bench_problem(C, 12500, 2000),
                                                  device=device))
    ij = torch.stack([torch.arange(C - 1), torch.arange(1, C)], 1).to(device, torch.int32)
    rel = torch.tensor([5.0 / (C - 1), 0, 0, 0, 0, 0, 1], device=device).repeat(C - 1, 1)
    edges = (ij, rel, torch.full((C - 1, 6), 100.0, device=device),
             torch.ones(C - 1, dtype=torch.bool, device=device))
    for solver in ("pcg", "dense"):
        fn, x = ba._program(Pinhole(*BA_BENCH_CAMERA), bk, "buckets", edges, huber_delta=3.0,
                            solver=solver, pcg_iters=100, pcg_tol=1e-6, step_clamp=(10.0, 50.0))
        state = (bk.cam_pose, bk.points, ba._lam(1.0, bk.points))
        fn(state, x)
        _sync_free(f"ba iteration ({solver}, {C - 1} pose edges)", lambda: fn(state, x))
    rng = np.random.default_rng(3)
    F, W = cfg2.frontend.max_features, cfg2.filter.desc_words
    pool = torch.as_tensor(rng.integers(0, 2**32, (4 * F, W), dtype=np.uint32).view(np.int32),
                           device=device)
    cap = 8 * F
    store = (torch.zeros(cap + 1, W, dtype=torch.int32, device=device),
             torch.zeros(cap + 1, dtype=torch.bool, device=device),
             torch.zeros(cap + 1, 3, device=device), torch.zeros((), dtype=torch.int32, device=device),
             torch.zeros((), dtype=torch.int32, device=device))
    fn = system._dedup_step(cap, 40)
    x = {"desc": pool[:F], "valid": torch.ones(F, dtype=torch.bool, device=device),
         "world": torch.zeros(F, 3, device=device)}
    store, _ = fn(store, x)
    x["desc"] = pool[F // 2:F // 2 + F]
    _sync_free("dedup keyframe step", lambda: fn(store, x))
    db = pool[torch.randint(0, 4 * F, (64, F), device=device)]
    x = {"qd": pool[:F], "qv": torch.ones(F, dtype=torch.bool, device=device), "db": db,
         "dbv": torch.ones(64, F, dtype=torch.bool, device=device),
         "n_old": torch.full((), 40, dtype=torch.int64, device=device)}
    fn = system._kf_match_step(cfg2.frontend.match_ratio)
    fn((), x)
    _sync_free("closure match (store of 64)", lambda: fn((), x))


def main():
    if not os.path.isdir(os.path.join(HERE, "parakeet_slam_tpu_torch", "csrc")):
        raise SystemExit("chip_smoke FAILED: run from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    check(len(sys.argv) == 1, f"chip_smoke.py takes no arguments, got {sys.argv[1:]}")
    card = phase_environment()
    device = torch.device("cuda", 0)

    def run(phase, *args):
        """One phase, with its wall-clock seconds (the script must stay well
        inside its time limit; the host's speed varies from call to call)."""
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    run(phase_build)
    run(phase_wrap, device)
    k, ekf_err = run(phase_kernels, device)
    launches = run(phase_corridor, device)
    run(phase_real_size, device)
    renders = start_bench_renders()  # phase 18's frames, beside phase 6 only
    try:
        k3, err3 = run(phase_kernels_3d, device)
    except BaseException:
        renders[0].shutdown(cancel_futures=True)
        raise
    rendered = finish_bench_renders(renders)
    propose = run(phase_propose, device)
    vision = run(phase_vision, device)
    run(phase_bench_rows, device)
    km, l2_err, l2_launches = run(phase_match, device)
    desk = run(phase_desk, device)
    run(phase_desk_replay, desk["calls"])
    captured = run(phase_captured, device, desk)
    stereo = run(phase_stereo, device)
    cinv = run(phase_cinv, device)
    ba_run = run(phase_ba, device)
    sys_ba = run(phase_run_ba, desk)
    config4 = run(phase_config4, device)
    config5 = run(phase_config5, device, card)
    generic = run(phase_generic, device)
    bench = run(phase_bench_system, device, rendered)

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
    x3, x2, x4 = k3["kitti_ext"][1], k3["config2_ext"][1], k3["config4_ext"][1]
    c2f, c2r = km["closure_config2"]
    pnf, pnr = km["closure_panoramic"]
    hf, vf = captured["rotation_fit"], captured["verify"][f"refine Nc={VERIFY_BATCHES[-1]}"]
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
              plain_ms_corridor_single_call=k[("gather", CORRIDOR_SHAPE)][5],
              launches_stereo=stereo["launches"][2], launches_config4=config4["launches"][2],
              launches_config5=config5["launches"][2],
              ms_source_window_config5=k["gather_windows"][0],
              plain_ms_source_window_config5=k["gather_windows"][1],
              bound_ms_source_window_config5=k["gather_windows"][2][0],
              launches_bench_stereo=bench["stereo"]["launches"][2],
              launches_bench_pano=bench["pano"]["launches"][2]),
        entry("measurement_update_3d", "ekf_update_3d.cu",
              "parakeet_slam_tpu/kernels/ekf_update_3d.py:664", stereo["launches"][1], err3,
              x3["update"], x3["update_twin"], x3["update_bound"],
              mode="fed score_3d's scores", ms_single_call=x3["update_single"],
              ms_config2=x2["update"], plain_ms_config2=x2["update_twin"],
              bound_ms_config2=x2["update_bound"][0], ms_config4=x4["update"],
              plain_ms_config4=x4["update_twin"], bound_ms_config4=x4["update_bound"][0],
              launches_desk=desk["launches"][1],
              launches_vision=vision["launches"][1], launches_config4=config4["launches"][1],
              launches_config5=config5["launches"][1],
              launches_bench_stereo=bench["stereo"]["launches"][1],
              launches_bench_pano=bench["pano"]["launches"][1],
              max_abs_err_generic_path=generic["err"],
              ms_self_scoring=t3["update"], plain_ms_self_scoring=t3["update_twin"],
              bound_ms_self_scoring=t3["update_bound"][0],
              ms_self_scoring_single_call=t3["update_single"],
              ms_self_scoring_panoramic=pan["update"],
              plain_ms_self_scoring_panoramic=pan["update_twin"],
              bound_ms_self_scoring_panoramic=pan["update_bound"][0],
              ms_self_scoring_bench_equirect=eq["update"],
              plain_ms_self_scoring_bench_equirect=eq["update_twin"]),
        entry("score_3d", "ekf_update_3d.cu", "parakeet_slam_tpu/kernels/ekf_update_3d.py:920",
              stereo["launches"][0], err3, t3["score"], t3["score_twin"], t3["score_bound"],
              ms_single_call=t3["score_single"], ms_bench_equirect=eq["score"],
              plain_ms_bench_equirect=eq["score_twin"], launches_desk=desk["launches"][0],
              launches_vision=vision["launches"][0], launches_config4=config4["launches"][0]),
        entry("hamming_top2", "match.cu", "parakeet_slam_tpu/kernels/match.py:269",
              desk["launches"][3], 0.0, km["ham"][0], km["ham"][1], km["ham"][2],
              launches_run_ba=sys_ba["launches"][0], launches_stereo=stereo["launches"][3],
              launches_config4=config4["launches"][3], launches_config5=config5["ring_launches"],
              launches_bench_stereo=bench["stereo"]["launches"][3],
              launches_bench_pano=bench["pano"]["launches"][3],
              ms_ring_config5=config5["ms_ring"], ms_ring_config5_eager=config5["ms_ring_eager"],
              ms_config5_whole_database=config5["ms_ring_alone"],
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
              launches_run_ba=sys_ba["launches"][1], launches_config4=config4["launches"][4],
              launches_config5=config5["cinv_launches"]),
        entry("propose_3d", "propose_3d.cu", "parakeet_slam_tpu_torch/filter/fastslam2.py loop",
              stereo["propose_launches"], 0.0, propose["kitti00"]["ms"],
              propose["kitti00"]["plain_ms"],
              (propose["kitti00"]["bound_ms"], propose["kitti00"]["bound_by"]),
              ms_single_call=propose["kitti00"]["ms_single_call"],
              ms_config2=propose["config2"]["ms"], plain_ms_config2=propose["config2"]["plain_ms"],
              bound_ms_config2=propose["config2"]["bound_ms"],
              launches_desk=desk["propose_launches"],
              launches_vision=vision["propose_launches"]),
        entry("rotation_fit", "horn.cu", "parakeet_slam_tpu/backend/graph.py:461",
              desk["horn_launches"], hf["err"], hf["ms"], hf["plain"], hf["bound"],
              library=hf["plain"], max_abs_err_float64=hf["err_f64"], ms_b1=hf["ms_b1"],
              sweeps_max=hf["sweeps_max"],
              ms_verify_captured_nc16=vf["steady_ms"]["captured"],
              ms_verify_eager_nc16=vf["steady_ms"]["eager"],
              api_calls_verify_nc16=vf["api_calls"]),
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
