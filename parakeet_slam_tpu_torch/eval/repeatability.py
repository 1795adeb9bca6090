"""Run-to-run repeatability of the online system (benchmark config 2).

    python -m parakeet_slam_tpu_torch.eval.repeatability [--frames 120] [--runs 2]
        [--deterministic] [--device cuda]

Drives `SLAMSystem` over the in-memory desk world (`make_desk_world`, as
`chip_smoke.py` phase 10 does) `--runs` times in one process from the same
seed. After every frame it hashes each field of the filter state (pose,
log_w, lm_mean, lm_cov, lm_desc, lm_valid, lm_count) and of the pose graph
(poses, edges), and prints, for each run after the first, the first frame
and field that differ from the first run, or that none does. With
`--deterministic` the last run goes under
`torch.use_deterministic_algorithms(True, warn_only=True)`, and the ops that
have no deterministic implementation on the device are listed from its
warnings. It imports the package from the path, so that an older tree can
be checked with `PYTHONPATH=<tree> python3 <this file>`.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import warnings

import numpy as np
import torch

STATE_FIELDS = ("pose", "log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid", "lm_count")
GRAPH_FIELDS = ("poses", "node_valid", "edge_ij", "edge_rel", "edge_info", "edge_valid")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__" and REPO not in sys.path:
    sys.path.append(REPO)  # run as a file: a tree on PYTHONPATH comes first


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def state_digests(sys_) -> dict:
    """{field: sha1 of its bytes} of the system's filter state and graph."""
    out = {f"state.{k}": _digest(getattr(sys_.state, k)) for k in STATE_FIELDS}
    out.update({f"graph.{k}": _digest(getattr(sys_.graph, k)) for k in GRAPH_FIELDS})
    return out


def desk_inputs(frames: int, config: str = "configs/tum_fr1_desk.yaml"):
    """(config, rendered images, odometry [frames, 6], ground truth) of the
    desk world at the config's widths."""
    from parakeet_slam_tpu_torch import cli
    from parakeet_slam_tpu_torch.core.config import load_config
    from parakeet_slam_tpu_torch.data.synth_vision import make_desk_world

    cfg = load_config(os.path.join(REPO, config))
    world = make_desk_world(num_steps=frames)
    images = [world.render(i) for i in range(frames)]
    return cfg, images, cli._make_odometry(cfg.data, world.gt_pose, frames), world.gt_pose


def run_once(cfg, images, odom, device, digests: bool = True) -> dict:
    """One run of the online system: per-frame digests (when asked), the
    online estimates, keyframe count, resample count and graph poses, all
    on the host."""
    from parakeet_slam_tpu_torch.system import SLAMSystem

    sys_ = SLAMSystem(cfg, device=device)
    resampled = []
    sys_.metrics.log = lambda frame, **rec: resampled.append(rec["resampled"])
    per_frame, est = [], []
    for i in range(len(odom)):
        est.append(sys_.process_frame(images[i], odom[i]))
        if digests:
            per_frame.append(state_digests(sys_))
    sys_.flush_flags()
    sys_.flush_metrics()
    return {"digests": per_frame, "est": torch.stack(est).cpu().numpy(),
            "keyframes": len(sys_.keyframes), "closures": len(sys_.loop_closures),
            "resamples": int(sum(resampled)), "graph_poses": sys_.graph.poses.cpu().numpy(),
            "system": sys_}


def first_difference(a: list, b: list):
    """(frame, [fields]) of the first frame whose digests differ, or None."""
    for i, (da, db) in enumerate(zip(a, b)):
        fields = [k for k in da if da[k] != db[k]]
        if fields:
            return i, fields
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(prog="parakeet_slam_tpu_torch.eval.repeatability")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from parakeet_slam_tpu_torch.cli import resolve_device

    device = resolve_device(args.device)
    cfg, images, odom, _ = desk_inputs(args.frames)
    runs, refused = [], set()
    last = args.runs - 1
    for r in range(args.runs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if args.deterministic and r == last:
                torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                runs.append(run_once(cfg, images, odom, device))
            finally:
                torch.use_deterministic_algorithms(False)
        if args.deterministic and r == last:
            refused = {str(w.message).split("\n")[0] for w in caught
                       if "deterministic" in str(w.message)}
        o = runs[-1]
        print(f"run {r}{' (deterministic algorithms)' if args.deterministic and r == last else ''}: "
              f"keyframes={o['keyframes']} closures={o['closures']} "
              f"resamples={o['resamples']}")
    if args.deterministic:
        print(f"ops without a deterministic implementation: {len(refused)}")
        for msg in sorted(refused):
            print(f"  {msg[:200]}")
    for r, o in enumerate(runs[1:], start=1):
        diff = first_difference(runs[0]["digests"], o["digests"])
        same = (np.array_equal(o["est"], runs[0]["est"])
                and np.array_equal(o["graph_poses"], runs[0]["graph_poses"]))
        where = "none" if diff is None else f"frame {diff[0]}, fields {', '.join(diff[1])}"
        print(f"run {r} vs run 0: first difference: {where}; estimates and graph poses "
              f"{'bit-equal' if same else 'differ'}")


if __name__ == "__main__":
    main()
