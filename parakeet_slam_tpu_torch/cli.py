"""Command-line interface of the port: run on the corridor, a TUM sequence
or the panoramic world, write a synthetic TUM dataset, the corridor
benchmark, and the per-kernel benchmarks.

  python -m parakeet_slam_tpu_torch.cli run --config configs/corridor.yaml
  python -m parakeet_slam_tpu_torch.cli run --config configs/corridor.yaml --device cpu
  python -m parakeet_slam_tpu_torch.cli synth --kind tum --out data_synth/tum
  python -m parakeet_slam_tpu_torch.cli run --config configs/tum_fr1_desk.yaml \\
      --set data.path=data_synth/tum
  python -m parakeet_slam_tpu_torch.cli run --config configs/panoramic.yaml
  python -m parakeet_slam_tpu_torch.cli bench
  python -m parakeet_slam_tpu_torch.cli bench --kernel fs2_step
  python -m parakeet_slam_tpu_torch.cli bench --kernel ekf_update_3d --device cpu --shape 16 256 8
  python -m parakeet_slam_tpu_torch.cli bench --kernel ba_iteration --device cpu --shape 4 200 60
  python -m parakeet_slam_tpu_torch.cli eval --est est.txt --gt groundtruth.txt

`--device` defaults to cuda and fails when there is no card; only
`--device cpu` runs on the CPU (through the kernels' plain twins). Any
config field can be overridden with `--set filter.num_particles=512`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# Pure-numpy reference-class FastSLAM on the corridor, frames/s (bench.py).
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
        "resamples": sum(m.resampled for m in metrics),
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
    from parakeet_slam_tpu_torch.core.config import load_config

    if args.ba:
        raise NotImplementedError(
            "run --ba (joint BA after the EuRoC multi-session run) is not ported yet "
            "(ROADMAP Queue 1 item 2)")
    device = resolve_device(args.device)
    cfg = load_config(args.config, _parse_overrides(args.set))
    if cfg.data.dataset == "panoramic":
        return _run_panoramic(cfg, args, device)
    if cfg.data.dataset == "tum":
        return _run_tum(cfg, args, device)
    if cfg.data.dataset != "corridor":
        raise NotImplementedError(
            f"dataset {cfg.data.dataset!r} is not ported yet (ROADMAP Queue 1)"
        )
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


def run_tum_sequence(sys_, frames, odom, warm: int = 3):
    """Drive an online system over `frames` (a sequence of [H, W] images,
    or a callable i -> image) with odometry [n, 6], as `cli run` drives a
    TUM sequence. Returns (online estimates [n, 7] on the host, steady-state
    frames/s from frame `warm` on, wall seconds)."""
    image = frames if callable(frames) else frames.__getitem__
    n = len(odom)
    warm = min(warm, max(0, n - 1))
    sync = torch.cuda.synchronize if sys_.device.type == "cuda" else (lambda: None)
    est = []
    t_loop = t_warm = time.perf_counter()
    for i in range(n):
        est.append(sys_.process_frame(image(i), odom[i]))
        if i + 1 == warm:
            sync()
            t_warm = time.perf_counter()
    # one device-to-host copy for the whole trajectory
    est = torch.stack(est).cpu().numpy()
    t_end = time.perf_counter()
    return est, (n - warm) / max(t_end - t_warm, 1e-9), t_end - t_loop


def tum_ate(sys_, est, gt, odom, cfg):
    """(corrected trajectory [n, 7], ATEs): the online estimates re-anchored
    to the optimized keyframe graph (this drains the system's last window),
    and the (corrected, online, dead-reckoning) ATE RMSE in m over the
    frames with ground truth, Sim(3)-aligned for a monocular pinhole run;
    ATEs is None with fewer than 3 such frames."""
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


def _run_tum(cfg, args, device):
    """A TUM RGB-D sequence (benchmark config 2) through the online system."""
    from parakeet_slam_tpu_torch.data.tum import load_tum
    from parakeet_slam_tpu_torch.system import SLAMSystem
    from parakeet_slam_tpu_torch.utils.metrics_log import export_trajectory

    seq = load_tum(cfg.data.path)
    gt = seq.gt_pose  # [T, 7] (t, qxyzw), NaN rows possible
    n = len(seq) if args.frames <= 0 else min(args.frames, len(seq))
    odom = _make_odometry(cfg.data, gt, n)
    sys_ = SLAMSystem(cfg, device=device)
    est, fps, wall = run_tum_sequence(sys_, seq.image, odom)
    sys_.flush_flags()
    sys_.flush_metrics()
    line = (f"frames={n} keyframes={len(sys_.keyframes)} "
            f"loop_closures={len(sys_.loop_closures)} "
            f"fps={fps:.2f} (steady-state; incl-build {n / wall:.2f}) wall={wall:.1f}s")
    # Evaluation trajectory: the online estimates re-anchored to the
    # optimized keyframe graph (loop closures fix past drift only there).
    est_opt, ates = tum_ate(sys_, est, gt, odom, cfg)
    if ates is not None:
        line += (f" ate_rmse={ates[0]:.4f} m (sim3={cfg.frontend.camera == 'pinhole'};"
                 f" online {ates[1]:.4f}; dead-reckoning {ates[2]:.4f})")
    print(line)
    if args.out:
        export_trajectory(args.out, est_opt)


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
    """Write a synthetic dataset in the TUM on-disk format (no dataset
    download is needed; see data/synth_vision.py)."""
    from parakeet_slam_tpu_torch.data import synth_vision as sv

    if args.sessions is not None:
        raise NotImplementedError(
            "synth --sessions (EuRoC multi-session worlds) is not ported yet "
            "(ROADMAP Queue 1 item 2)")
    if args.kind != "tum":
        raise NotImplementedError(f"synth --kind {args.kind} is not ported yet (ROADMAP Queue 1)")
    t0 = time.time()
    world = sv.make_desk_world(num_landmarks=args.landmarks or 1000,
                               num_steps=args.steps or 600, seed=args.seed)
    sv.write_tum_format(world, args.out)
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


def cmd_bench(args):
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
    p_run.add_argument("--frames", type=int, default=0, help="first N frames of a TUM sequence")
    p_run.add_argument("--ba", type=int, default=0,
                       help="joint-BA LM iterations after a EuRoC multi-session run (not ported)")
    p_run.add_argument("--device", default="cuda")
    p_run.set_defaults(fn=cmd_run)

    p_synth = sub.add_parser("synth", help="write a synthetic TUM-format dataset")
    p_synth.add_argument("--kind", required=True, choices=("tum", "kitti", "euroc"))
    p_synth.add_argument("--out", required=True)
    p_synth.add_argument("--steps", type=int, default=0)
    p_synth.add_argument("--landmarks", type=int, default=0)
    p_synth.add_argument("--seed", type=int, default=20)
    p_synth.add_argument("--sessions", type=int, default=None,
                         help="euroc: number of sessions sharing one world (not ported)")
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
    p_bench.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
