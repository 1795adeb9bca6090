"""Command-line interface of the port: run on the corridor, a TUM, KITTI or
EuRoC sequence (or several EuRoC sessions, ending in one joint bundle
adjustment) or the panoramic world, write a synthetic TUM, KITTI or EuRoC
dataset, the corridor benchmark, and the per-kernel benchmarks.

  python -m parakeet_slam_tpu_torch.cli run --config configs/corridor.yaml
  python -m parakeet_slam_tpu_torch.cli run --config configs/corridor.yaml --device cpu
  python -m parakeet_slam_tpu_torch.cli synth --kind tum --out data_synth/tum
  python -m parakeet_slam_tpu_torch.cli run --config configs/tum_fr1_desk.yaml \\
      --set data.path=data_synth/tum
  python -m parakeet_slam_tpu_torch.cli synth --kind kitti --out data_synth/kitti --steps 20
  python -m parakeet_slam_tpu_torch.cli run --config configs/kitti_00.yaml \\
      --set data.path=data_synth/kitti/sequences/00
  python -m parakeet_slam_tpu_torch.cli synth --kind euroc --sessions 2 --out data_synth/euroc
  python -m parakeet_slam_tpu_torch.cli run --config configs/euroc_mh.yaml \\
      --set data.path=data_synth/euroc --ba 20
  python -m parakeet_slam_tpu_torch.cli run --config configs/panoramic.yaml
  python -m parakeet_slam_tpu_torch.cli bench
  python -m parakeet_slam_tpu_torch.cli bench --kernel fs2_step
  python -m parakeet_slam_tpu_torch.cli bench --measure-baseline
  python -m parakeet_slam_tpu_torch.cli bench --kernel ekf_update_3d --device cpu --shape 16 256 8
  python -m parakeet_slam_tpu_torch.cli bench --kernel ba_iteration --device cpu --shape 4 200 60
  python -m parakeet_slam_tpu_torch.cli eval --est est.txt --gt groundtruth.txt

`--device` defaults to cuda and fails when there is no card; only
`--device cpu` runs on the CPU (through the kernels' plain twins). Any
config field can be overridden with `--set filter.num_particles=512`.

`run` on N ranks: start N processes with the reference's variables
COORDINATOR_ADDRESS=host:port, NUM_PROCESSES=N and PROCESS_ID=0..N-1 (gloo
on the CPU; NCCL with one card per rank). The system shards its filter when
N = dist.particle_axis * dist.map_axis; only rank 0 prints and writes
files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# Pure-numpy reference-class FastSLAM on the corridor, frames/s (bench.py).
# `cli bench --measure-baseline` re-measures it on the host it runs on: 1.279
# frames/s on the 8-core host of an NVIDIA H100 80GB HBM3 at 700 W (its CPU
# model not reported). The denominator stays the reference's.
NUMPY_BASELINE_FPS = 2.16


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device available (use --device cpu for the CPU twins)")
    return dev


def corridor_config():
    """Benchmark config 1 (configs/corridor.yaml, bench.py), built in code."""
    from parakeet_slam_tpu_torch.core.config import FilterConfig

    return FilterConfig(
        num_particles=64, max_landmarks=192, max_observations=16, sig_dim=3,
        motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03), sig_noise=0.5,
        max_range=6.5, fov_half_angle=2.5, use_pallas=True,
    )


def sim_tensors(sim, device):
    """(odom, obs_z, obs_sig, obs_valid) of a CorridorSim on `device`."""
    return tuple(
        torch.as_tensor(a, device=device)
        for a in (sim.odom, sim.obs_z, sim.obs_sig, sim.obs_valid)
    )


def run_corridor(slam, sim, seed: int, device) -> dict:
    """One filter run over the sim with random draws from `seed`: the
    trajectory (on the host), its ATE in m, frames/s (host clock around the
    run, which ends in a device-to-host copy) and the number of resamples."""
    from parakeet_slam_tpu_torch.eval import ate_rmse
    from parakeet_slam_tpu_torch.filter import run_sequence

    data = sim_tensors(sim, device)
    state = slam.init_state(init_pose=sim.gt_pose[0], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, est, metrics = run_sequence(slam, state, *data, generator=gen)
    est = est.cpu()
    dt = time.perf_counter() - t0
    return {
        "est": est,
        "ate": float(ate_rmse(est[:, :2], torch.as_tensor(sim.gt_pose[:, :2]))),
        "fps": len(est) / dt,
        "resamples": int(torch.stack([m.resampled for m in metrics]).sum()),
    }


def measure_corridor(device, num_steps: int = 500, seeds=range(5), cfg=None) -> dict:
    """The corridor benchmark on config 1: one run per filter seed. Returns
    the per-seed lists (ates, fps, resamples) and their summary (ate mean
    and std, median fps; the first run also pays the kernel build)."""
    from parakeet_slam_tpu_torch.data import make_corridor
    from parakeet_slam_tpu_torch.filter import make_filter

    cfg = cfg or corridor_config()
    sim = make_corridor(
        num_landmarks=100, num_steps=num_steps, max_obs=cfg.max_observations, seed=7
    )
    slam = make_filter(cfg)
    runs = [run_corridor(slam, sim, s, device) for s in seeds]
    ates = [r["ate"] for r in runs]
    return {
        "ates": ates,
        "fps_runs": [r["fps"] for r in runs],
        "resamples": [r["resamples"] for r in runs],
        "est_finite": all(bool(torch.isfinite(r["est"]).all()) for r in runs),
        "ate": float(np.mean(ates)),
        "ate_std": float(np.std(ates)),
        "fps": float(np.median([r["fps"] for r in runs])),
    }


def cmd_run(args):
    import contextlib
    import gc
    import io
    import traceback

    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost, process_index

    device = resolve_device(args.device)
    own_group = not torch.distributed.is_initialized() and initialize_multihost()
    try:
        if process_index() == 0:
            _cmd_run(args, device)
        else:
            # every rank runs the program; rank 0 alone prints and writes files
            args.out = ""
            with contextlib.redirect_stdout(io.StringIO()):
                _cmd_run(args, device)
        if own_group:  # no rank tears the group down while another still runs
            torch.distributed.barrier(
                device_ids=[torch.cuda.current_device()] if device.type == "cuda" else None)
    except BaseException as e:
        # the failed run's frames would keep its systems alive
        traceback.clear_frames(e.__traceback__)
        raise
    finally:
        # The systems' captured programs (their steps, a mesh's programs)
        # hold NCCL's communicators, so their graphs go first: the systems
        # are unreachable once the run returns, and a step and its system
        # hold each other, so a collection frees them. Then the group that
        # this call made.
        gc.collect()
        if own_group:
            if device.type == "cuda":
                torch.cuda.synchronize()
            torch.distributed.destroy_process_group()


def _cmd_run(args, device):
    from parakeet_slam_tpu_torch.core.config import load_config

    cfg = load_config(args.config, _parse_overrides(args.set))
    if cfg.data.dataset == "panoramic":
        return _run_panoramic(cfg, args, device)
    if cfg.data.dataset == "euroc":
        roots = euroc_sessions(cfg.data.path)
        if roots:
            return _run_euroc_multisession(cfg, args, roots, device)
    if cfg.data.dataset in ("tum", "kitti", "euroc"):
        return _run_image_sequence(cfg, args, device)
    if cfg.data.dataset != "corridor":
        raise SystemExit(f"unknown dataset {cfg.data.dataset!r}")
    from parakeet_slam_tpu_torch.data import make_corridor
    from parakeet_slam_tpu_torch.filter import make_filter

    t0 = time.time()
    sim = make_corridor(
        num_landmarks=cfg.data.num_landmarks, num_steps=cfg.data.num_steps,
        max_obs=cfg.filter.max_observations, seed=cfg.data.seed,
    )
    slam = make_filter(cfg.filter)
    run = run_corridor(slam, sim, cfg.filter.seed, device)
    est = run["est"]
    dt = time.time() - t0
    print(f"frames={len(est)} ate_rmse={run['ate']:.4f} m wall={dt:.1f}s "
          f"fps={len(est)/dt:.1f}")
    if args.out:
        np.savetxt(args.out, est.numpy())


def _run_panoramic(cfg, args, device):
    """The synthetic panoramic world through the online system; prints the
    end drift in the world frame."""
    from parakeet_slam_tpu_torch.core import geometry
    from parakeet_slam_tpu_torch.data.panoramic import make_panoramic_world
    from parakeet_slam_tpu_torch.system import SLAMSystem
    from parakeet_slam_tpu_torch.utils.metrics_log import export_trajectory

    world = make_panoramic_world(
        num_landmarks=cfg.data.num_landmarks or 300, num_steps=cfg.data.num_steps,
        image_size=cfg.frontend.image_size, seed=cfg.data.seed,
    )
    sys_ = SLAMSystem(cfg, device=device)
    est = torch.stack([sys_.process_frame(world.render(t), world.odom[t])
                       for t in range(len(world))]).cpu()
    sys_.flush_flags()
    sys_.flush_metrics()
    # the filter's gauge starts at identity: compose with gt[0] for the
    # world-frame drift
    end = geometry.se3_compose(torch.as_tensor(world.gt_pose[0]), est[-1]).numpy()
    drift = float(np.linalg.norm(end[:3] - world.gt_pose[-1, :3]))
    print(f"frames={len(est)} keyframes={len(sys_.keyframes)} "
          f"loop_closures={len(sys_.loop_closures)} end_drift={drift:.3f} m")
    if args.out:
        export_trajectory(args.out, est.numpy())


def run_image_sequence(sys_, frames, odom, warm: int = 3, right=None, draws=None):
    """Drive an online system over `frames` (a sequence of [H, W] images,
    or a callable i -> image) with odometry [n, 6], as `cli run` drives a
    TUM, KITTI or EuRoC sequence; with `right` (the same for the right
    camera) as stereo pairs through `process_stereo_frame`. `draws`, when
    given, holds each frame's (motion_noise, resample_u0) in place of the
    system's own. Returns (online estimates [n, 7] on the host, steady-state
    frames/s from frame `warm` on, wall seconds)."""
    image = frames if callable(frames) else frames.__getitem__
    image_r = right if right is None or callable(right) else right.__getitem__
    n = len(odom)
    warm = min(warm, max(0, n - 1))
    sync = torch.cuda.synchronize if sys_.device.type == "cuda" else (lambda: None)
    est = []
    t_loop = t_warm = time.perf_counter()
    for i in range(n):
        kw = {} if draws is None else dict(zip(("motion_noise", "resample_u0"), draws[i]))
        if image_r is None:
            est.append(sys_.process_frame(image(i), odom[i], **kw))
        else:
            est.append(sys_.process_stereo_frame(image(i), image_r(i), odom[i], **kw))
        if i + 1 == warm:
            sync()
            t_warm = time.perf_counter()
    # one device-to-host copy for the whole trajectory
    est = torch.stack(est).cpu().numpy()
    t_end = time.perf_counter()
    return est, (n - warm) / max(t_end - t_warm, 1e-9), t_end - t_loop


def sequence_ate(sys_, est, gt, odom, cfg):
    """(corrected trajectory [n, 7], ATEs): the online estimates re-anchored
    to the optimized keyframe graph (this drains the system's last window),
    and the (corrected, online, dead-reckoning) ATE RMSE in m over the
    frames with ground truth, Sim(3)-aligned for a monocular pinhole run
    and SE(3) otherwise; ATEs is None with fewer than 3 such frames."""
    from parakeet_slam_tpu_torch.eval import ate_rmse

    n = len(est)
    est_opt = sys_.corrected_trajectory(est)
    ok = ~np.isnan(gt[:n, :3]).any(axis=1)
    if ok.sum() < 3:
        return est_opt, None
    with_scale = cfg.frontend.camera == "pinhole"
    dr = _dead_reckoning(gt[:n][ok][0], odom[:n])
    ates = tuple(float(ate_rmse(t[ok, :3], gt[:n][ok, :3], with_scale=with_scale))
                 for t in (est_opt, est, dr))
    return est_opt, ates


def _kitti_gt_to_quat(gt34):
    """KITTI [T, 3, 4] world-from-cam0 matrices -> [T, 7] (t, qxyzw)."""
    from parakeet_slam_tpu_torch.core import geometry

    out = np.zeros((len(gt34), 7), np.float32)
    out[:, :3] = gt34[:, :, 3]
    out[:, 3:] = geometry.matrix_to_quat(torch.as_tensor(gt34[:, :, :3])).numpy()
    return out


def load_image_dataset(cfg, frames: int = 0):
    """The first `frames` frames (all for 0) of the config's TUM, KITTI or
    EuRoC sequence, as `cli run` reads them: (left images, right images or
    None, ground truth [T, 7] (t, qxyzw) or None, odometry [n, 6]). Images
    are callables i -> [H, W] float32; a KITTI sequence is read as stereo
    pairs when obs_dim is 3."""
    right = None
    if cfg.data.dataset == "tum":
        from parakeet_slam_tpu_torch.data.tum import load_tum

        seq = load_tum(cfg.data.path)
        gt = seq.gt_pose  # [T, 7] (t, qxyzw), NaN rows possible
    elif cfg.data.dataset == "euroc":
        from parakeet_slam_tpu_torch.data.euroc import load_euroc

        seq = load_euroc(cfg.data.path)
        gt = seq.gt_pose
    else:
        from parakeet_slam_tpu_torch.data.kitti import load_kitti

        seq = load_kitti(cfg.data.path)
        gt = _kitti_gt_to_quat(seq.gt_pose) if seq.gt_pose is not None else None
        if cfg.filter.obs_dim == 3:
            right = lambda i: seq.image(i, right=True)  # noqa: E731
    n = len(seq) if frames <= 0 else min(frames, len(seq))
    return seq.image, right, gt, _make_odometry(cfg.data, gt, n)


def _run_image_sequence(cfg, args, device):
    """A TUM RGB-D sequence (benchmark config 2), a KITTI stereo sequence
    (benchmark config 3) or one EuRoC session through the online system."""
    from parakeet_slam_tpu_torch.system import SLAMSystem
    from parakeet_slam_tpu_torch.utils.metrics_log import export_trajectory

    left, right, gt, odom = load_image_dataset(cfg, args.frames)
    n = len(odom)
    sys_ = SLAMSystem(cfg, device=device)
    est, fps, wall = run_image_sequence(sys_, left, odom, right=right)
    sys_.flush_flags()
    sys_.flush_metrics()
    line = (f"frames={n} keyframes={len(sys_.keyframes)} "
            f"loop_closures={len(sys_.loop_closures)} "
            f"fps={fps:.2f} (steady-state; incl-build {n / wall:.2f}) wall={wall:.1f}s")
    # Evaluation trajectory: the online estimates re-anchored to the
    # optimized keyframe graph (loop closures fix past drift only there).
    if gt is None:
        est_opt = sys_.corrected_trajectory(est)
    else:
        est_opt, ates = sequence_ate(sys_, est, gt, odom, cfg)
        if ates is not None:
            line += (f" ate_rmse={ates[0]:.4f} m (sim3={cfg.frontend.camera == 'pinhole'};"
                     f" online {ates[1]:.4f}; dead-reckoning {ates[2]:.4f})")
    print(line)
    if args.out:
        export_trajectory(args.out, est_opt)


def euroc_sessions(path: str) -> list[str]:
    """The session directories (MH*, each holding mav0/) under a EuRoC
    multi-session directory, in name order; empty for one sequence."""
    import os

    if not os.path.isdir(path):
        return []
    return [os.path.join(path, d) for d in sorted(os.listdir(path))
            if d.startswith("MH") and os.path.isdir(os.path.join(path, d, "mav0"))]


def run_sessions(cfg, sessions, device, ckpt_dir: str, frames: int = 0, draws=None,
                 warm: int = 3):
    """Benchmark config 4's online part: EuRoC sessions (`EuRoCSequence`s)
    in sequence through one system. At each session boundary the run goes
    through a snapshot (`save_checkpoint` to `<ckpt_dir>/session_NN`), a
    fresh `SLAMSystem` and `load_checkpoint`, and the first odometry row of
    the new session becomes the relocalization prior from the last
    ground-truth pose of the session before to the first of this one.
    `frames` cuts each session to its first frames (0: all); `draws` holds
    each frame's (motion_noise, resample_u0) over all sessions in order, in
    place of the system's own. Returns a dict: the final `system`, the
    online estimates `est` [N, 7], ground truth `gt` [N, 7] and odometry
    `odom` [N, 6] over all sessions, and per session (`sessions`) its
    frames, frames/s from frame `warm`, wall seconds, keyframes and
    closures at its end, and the seconds and bytes of the snapshot that
    began it (None for the first)."""
    from parakeet_slam_tpu_torch.core import geometry
    from parakeet_slam_tpu_torch.system import SLAMSystem

    sys_ = SLAMSystem(cfg, device=device)
    est_all, gt_all, odom_all, per = [], [], [], []
    prev_gt_last = None
    for si, seq in enumerate(sessions):
        n = len(seq) if frames <= 0 else min(frames, len(seq))
        gt = seq.gt_pose
        odom = _make_odometry(cfg.data, gt, n)
        boundary = None
        if si > 0:
            prefix = f"{ckpt_dir}/session_{si:02d}"
            t0 = time.perf_counter()
            sys_.save_checkpoint(prefix)
            t_save = time.perf_counter() - t0
            sys_ = SLAMSystem(cfg, device=device)
            t0 = time.perf_counter()
            sys_.load_checkpoint(prefix)
            if sys_.device.type == "cuda":
                torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            n_bytes = sum(os.path.getsize(prefix + ext) for ext in (".state.npz", ".kf.npz"))
            boundary = {"save_s": t_save, "load_s": t_load, "bytes": n_bytes}
            if prev_gt_last is not None and not np.isnan(gt[0, :3]).any():
                # coarse relocalization prior across the jump between sessions
                # (from the ground truth, as the odometry itself is)
                odom[0] = geometry.se3_log(geometry.se3_between(
                    torch.as_tensor(prev_gt_last), torch.as_tensor(gt[0]))).numpy()
        start = sum(len(e) for e in est_all)
        est, fps, wall = run_image_sequence(
            sys_, seq.image, odom, warm=warm,
            draws=None if draws is None else draws[start:start + n])
        est_all.append(est)
        gt_all.append(gt[:n])
        odom_all.append(odom)
        ok = ~np.isnan(gt[:n, :3]).any(axis=1)
        prev_gt_last = gt[:n][ok][-1] if ok.any() else prev_gt_last
        per.append({"frames": n, "fps": fps, "wall": wall, "keyframes": len(sys_.keyframes),
                    "closures": len(sys_.loop_closures), "boundary": boundary})
    return {"system": sys_, "est": np.concatenate(est_all), "gt": np.concatenate(gt_all),
            "odom": np.concatenate(odom_all), "sessions": per}


def joint_ba(sys_, iters: int = 0):
    """Benchmark config 4's joint bundle adjustment over all keyframes of a
    multi-session run (`SLAMSystem.ba_problem`, then `solve_ba`), solved
    twice: the second, warm solve is timed. Returns (result, problem, warm
    seconds), or None with fewer than two keyframes; the keyframes are left
    as they are. iters=0 means backend.gn_iters."""
    prob = sys_.ba_problem()
    if prob is None:
        return None
    iters = iters or sys_.cfg.backend.gn_iters
    sync = torch.cuda.synchronize if sys_.device.type == "cuda" else (lambda: None)
    sys_.solve_ba(prob, iters)
    sync()
    t0 = time.perf_counter()
    res = sys_.solve_ba(prob, iters)
    res.costs.cpu()
    return res, prob, time.perf_counter() - t0


def _run_euroc_multisession(cfg, args, roots, device, draws=None):
    """Benchmark config 4: EuRoC MH sessions in sequence with the checkpoint
    round trip at each boundary (`run_sessions`, `draws` as there), then one
    joint bundle adjustment over all sessions' keyframes (`joint_ba`, `--ba`
    LM iterations, timed warm). Prints the sessions and one summary line,
    exports the trajectory re-anchored to the adjusted keyframes, and
    returns the run: `run_sessions`'s dict with `est_corrected` and `ates`
    (`sequence_ate`'s), `ba` (`joint_ba`'s result) and `est_ba` (the online
    estimates re-anchored to the adjusted keyframes)."""
    import tempfile

    from parakeet_slam_tpu_torch.data.euroc import load_multi_session
    from parakeet_slam_tpu_torch.dist.multihost import process_index
    from parakeet_slam_tpu_torch.utils.metrics_log import export_trajectory

    sessions = load_multi_session(roots)
    ckpt_dir = cfg.checkpoint_dir
    if not ckpt_dir and process_index() == 0:
        ckpt_dir = tempfile.mkdtemp(prefix="euroc_ms_")
    if torch.distributed.is_initialized():
        # the ranks share rank 0's snapshot directory
        box = [ckpt_dir]
        torch.distributed.broadcast_object_list(box, src=0)
        ckpt_dir = box[0]
    t0 = time.perf_counter()
    run = run_sessions(cfg, sessions, device, ckpt_dir, frames=args.frames, draws=draws)
    wall = time.perf_counter() - t0
    sys_, est, gt, odom = run["system"], run["est"], run["gt"], run["odom"]
    for si, r in enumerate(run["sessions"]):
        print(f"session {si + 1}/{len(sessions)}: frames={r['frames']} "
              f"keyframes={r['keyframes']} closures={r['closures']}")
    sys_.flush_flags()
    sys_.flush_metrics()
    n = len(est)
    line = (f"sessions={len(sessions)} frames={n} keyframes={len(sys_.keyframes)} "
            f"loop_closures={len(sys_.loop_closures)} fps={n / wall:.2f} (incl-build)")
    est_opt, ates = run["est_corrected"], run["ates"] = sequence_ate(sys_, est, gt, odom, cfg)
    if ates is not None:
        line += (f" ate_rmse={ates[0]:.4f} m (sim3={cfg.frontend.camera == 'pinhole'}; "
                 f"online {ates[1]:.4f}; dead-reckoning {ates[2]:.4f})")
    out = run["ba"] = joint_ba(sys_, args.ba)
    if out is not None:
        from parakeet_slam_tpu_torch.eval import ate_rmse

        res, prob, dt = out
        iters = len(res.costs)
        poses = res.problem.cam_pose.cpu().numpy()
        for i, kf in enumerate(sys_.keyframes):
            kf.pose = poses[i]
        est_opt = run["est_ba"] = sys_.corrected_trajectory(est, final_optimize=False)
        line += (f" | BA: points={int(prob.pt_valid.sum())} obs={int(prob.obs_valid.sum())} "
                 f"iters/s={iters / dt:.2f} cost={float(res.costs[-1]):.1f}")
        ok = ~np.isnan(gt[:, :3]).any(axis=1)
        if ok.sum() >= 3:
            line += f" ate_ba={float(ate_rmse(est_opt[ok, :3], gt[ok, :3], with_scale=True)):.4f} m"
    print(line)
    if args.out:
        export_trajectory(args.out, est_opt)
    return run


def _dead_reckoning(start_pose, odom):
    """Integrate the odometry stream the filter consumes from a start pose
    (the control a SLAM run must beat): [n, 7] poses."""
    from parakeet_slam_tpu_torch.core import geometry

    p = torch.as_tensor(np.asarray(start_pose, np.float32))
    out = []
    for u in torch.as_tensor(np.asarray(odom, np.float32)):
        p = geometry.se3_compose(p, geometry.se3_exp(u))
        out.append(p)
    return torch.stack(out).numpy()


def _make_odometry(data_cfg, gt, n):
    """Per-frame body-frame twist increments [n, 6] for image datasets.

    odom_source="gt": noisy ground-truth increments (TUM ships no odometry);
    NaN gt rows give zero increments. odom_source="none": zeros. The noise
    is the reference's numpy stream."""
    from parakeet_slam_tpu_torch.core import geometry

    odom = np.zeros((n, 6), np.float32)
    if data_cfg.odom_source != "gt" or gt is None:
        return odom
    rng = np.random.default_rng(data_cfg.seed)
    ok = ~np.isnan(gt[:n, :3]).any(axis=1)
    rel = geometry.se3_log(geometry.se3_between(
        torch.as_tensor(gt[: n - 1]), torch.as_tensor(gt[1:n]))).numpy()
    good = ok[:-1] & ok[1:]
    sig_t, sig_r = data_cfg.odom_noise
    noise = np.concatenate(
        [rng.normal(0, sig_t, (n - 1, 3)), rng.normal(0, sig_r, (n - 1, 3))], axis=1,
    ).astype(np.float32)
    odom[1:][good] = (rel + noise)[good]
    return odom


def cmd_synth(args):
    """Write a synthetic dataset in the TUM, KITTI or EuRoC on-disk format
    (no dataset download is needed; see data/synth_vision.py). EuRoC writes
    `--sessions` sessions MH01..MH0N of one machine hall."""
    from parakeet_slam_tpu_torch.data import synth_vision as sv

    t0 = time.time()
    if args.kind == "tum":
        world = sv.make_desk_world(num_landmarks=args.landmarks or 1000,
                                   num_steps=args.steps or 600, seed=args.seed)
        sv.write_tum_format(world, args.out)
    elif args.kind == "kitti":
        world = sv.make_drive_world(num_landmarks=args.landmarks or 10000,
                                    num_steps=args.steps or 700, seed=args.seed)
        sv.write_kitti_format(world, args.out)
    else:
        for s in range(args.sessions):
            world = sv.make_hall_world(num_landmarks=args.landmarks or 8000,
                                       num_steps=args.steps or 400, session=s, seed=args.seed)
            sv.write_euroc_format(world, f"{args.out}/MH{s + 1:02d}")
            print(f"  session MH{s + 1:02d}: {len(world)} frames")
    print(f"wrote {args.kind} dataset: {len(world)} frames, {len(world.landmarks)} landmarks "
          f"-> {args.out} ({time.time() - t0:.1f}s)")


def cmd_eval(args):
    """ATE RMSE between two TUM-format trajectories (ts x y z ...), over
    their common first frames."""
    from parakeet_slam_tpu_torch.eval import ate_rmse

    device = resolve_device(args.device)

    def load_traj(path):
        return torch.as_tensor(np.loadtxt(path)[:, 1:4], dtype=torch.float32, device=device)

    est, gt = load_traj(args.est), load_traj(args.gt)
    n = min(len(est), len(gt))
    ate = float(ate_rmse(est[:n], gt[:n]))
    print(json.dumps({"ate_rmse_m": round(ate, 5), "frames": n}))


def measure_baseline(steps: int = 100) -> float:
    """The numpy baseline's frames/s on the corridor (bench.py's
    `measure_baseline`: 64 particles, 100 landmarks, 16 observations a
    frame, seed 7, timed over `steps` frames after 50 warm-up frames)."""
    from parakeet_slam_tpu_torch.baseline.numpy_fastslam import NumpyFastSLAM
    from parakeet_slam_tpu_torch.data import make_corridor

    sim = make_corridor(num_landmarks=100, num_steps=500, max_obs=16, seed=7)
    slam = NumpyFastSLAM(
        num_particles=64, motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
        sig_noise=0.5, max_range=6.5, fov_half_angle=2.5, seed=0,
    )
    warm = 50
    for i in range(warm):
        slam.motion_update(sim.odom[i])
        slam.measurement_update(sim.obs_z[i], sim.obs_sig[i], sim.obs_valid[i])
    t0 = time.time()
    for i in range(warm, warm + steps):
        slam.motion_update(sim.odom[i])
        slam.measurement_update(sim.obs_z[i], sim.obs_sig[i], sim.obs_valid[i])
    return steps / (time.time() - t0)


def cmd_bench(args):
    if args.measure_baseline:
        fps = measure_baseline()
        print(f"numpy baseline fps: {fps:.3f}", file=sys.stderr)
        print(json.dumps({"metric": "baseline_fps", "value": fps, "unit": "frames/s"}))
        return
    device = resolve_device(args.device)
    if args.kernel:
        from parakeet_slam_tpu_torch.eval import bench_kernels

        names = list(bench_kernels.BENCHES) if args.kernel == "all" else [args.kernel]
        bench_kernels.run(names, device, args.shape)
        return
    r = measure_corridor(device, args.steps)
    print(json.dumps({
        "metric": "corridor_online_fastslam_fps_per_chip",
        "value": round(r["fps"], 2),
        "unit": "frames/s",
        "vs_baseline": round(r["fps"] / NUMPY_BASELINE_FPS, 2),
        "ate_rmse_m": round(r["ate"], 4),
        "ate_std_m": round(r["ate_std"], 4),
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="parakeet_slam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run SLAM on a dataset config")
    p_run.add_argument("--config", required=True)
    p_run.add_argument(
        "--set", nargs="+", action="extend", default=[],
        help="dotted overrides k=v (repeatable)",
    )
    p_run.add_argument("--out", default="",
                       help="trajectory output (corridor: x y theta rows; vision: TUM format)")
    p_run.add_argument("--frames", type=int, default=0,
                       help="first N frames of a TUM, KITTI or EuRoC sequence (of each session)")
    p_run.add_argument("--ba", type=int, default=0,
                       help="joint-BA LM iterations after a EuRoC multi-session run "
                            "(0: backend.gn_iters)")
    p_run.add_argument("--device", default="cuda")
    p_run.set_defaults(fn=cmd_run)

    p_synth = sub.add_parser("synth", help="write a synthetic TUM-, KITTI- or EuRoC-format dataset")
    p_synth.add_argument("--kind", required=True, choices=("tum", "kitti", "euroc"))
    p_synth.add_argument("--out", required=True)
    p_synth.add_argument("--steps", type=int, default=0)
    p_synth.add_argument("--landmarks", type=int, default=0)
    p_synth.add_argument("--seed", type=int, default=20)
    p_synth.add_argument("--sessions", type=int, default=3,
                         help="euroc: number of MH sessions sharing one world")
    p_synth.set_defaults(fn=cmd_synth)

    p_eval = sub.add_parser("eval", help="ATE between two TUM trajectories")
    p_eval.add_argument("--est", required=True)
    p_eval.add_argument("--gt", required=True)
    p_eval.add_argument("--device", default="cuda")
    p_eval.set_defaults(fn=cmd_eval)

    p_bench = sub.add_parser("bench", help="corridor frames/s and 5-seed ATE, or one kernel")
    p_bench.add_argument("--steps", type=int, default=500)
    p_bench.add_argument(
        "--kernel", default="",
        choices=["", "all", "ekf_update", "ekf_update_3d", "resample", "fs1_step", "fs2_step",
                 "match", "schur", "ba_iteration"],
        help="one JSON row per kernel bench instead of the corridor headline",
    )
    p_bench.add_argument("--shape", type=int, nargs="+", default=None, metavar="N",
                         help="P L [Z] in place of the kernel bench's shape (match: N M; "
                              "schur: N; ba_iteration: C Pts obs_per_cam)")
    p_bench.add_argument("--device", default="cuda")
    p_bench.add_argument("--measure-baseline", action="store_true",
                         help="the numpy baseline's frames/s on this host (no card)")
    p_bench.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
