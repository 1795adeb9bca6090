"""Command-line interface of the port: run on the corridor, the corridor
benchmark, and the per-kernel benchmarks.

  python -m parakeet_slam_tpu_torch.cli run --config configs/corridor.yaml
  python -m parakeet_slam_tpu_torch.cli run --config configs/corridor.yaml --device cpu
  python -m parakeet_slam_tpu_torch.cli bench
  python -m parakeet_slam_tpu_torch.cli bench --kernel fs2_step
  python -m parakeet_slam_tpu_torch.cli bench --kernel ekf_update_3d --device cpu --shape 16 256 8

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
    """Driver config 1 (configs/corridor.yaml, bench.py), built in code."""
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

    device = resolve_device(args.device)
    cfg = load_config(args.config, _parse_overrides(args.set))
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
    p_run.add_argument("--out", default="", help="trajectory output (x y theta rows)")
    p_run.add_argument("--device", default="cuda")
    p_run.set_defaults(fn=cmd_run)

    p_bench = sub.add_parser("bench", help="corridor frames/s and 5-seed ATE, or one kernel")
    p_bench.add_argument("--steps", type=int, default=500)
    p_bench.add_argument(
        "--kernel", default="",
        choices=["", "all", "ekf_update", "ekf_update_3d", "resample", "fs1_step", "fs2_step"],
        help="one JSON row per kernel bench instead of the corridor headline",
    )
    p_bench.add_argument("--shape", type=int, nargs="+", default=None, metavar="N",
                         help="P L [Z] in place of the kernel bench's shape")
    p_bench.add_argument("--device", default="cuda")
    p_bench.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
