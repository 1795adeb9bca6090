"""Device time of the update path's two sweep kernels, and the paths around
them, for comparing trees.

    python3 parakeet_slam_tpu_torch/eval/ab_kernels.py [--root DIR] [--twin]
        [--parts kernels,update_3d,hamming,paths,posegraph]

Imports `parakeet_slam_tpu_torch` from DIR (default: the checkout that holds
this file), so that an older tree unpacked beside it (`git archive` of the
parent commit into a git-ignored directory) is timed by the same code in
the same call: run it for each tree in turns (parent, change, change,
parent). The timing (`eval/profiling.py`) and the inputs
(`eval/kernel_inputs.py`: the shapes and data `chip_smoke.py` checks) are
always this checkout's.
The parts (default `kernels`):
  - `kernels`: the device's time alone, on the inputs `chip_smoke.py` uses,
    of `measurement_update_2d` at the corridor shape (P=64, L=192, Z=16,
    S=3) and the real size (P=2048, L=10240, Z=32, S=3), half the lanes
    valid, the state restored before each call outside its events; and of
    `score_3d` at the KITTI shape (P=2048, L=10240, Z=128, stereo, W=8) and
    the bench shape (P=1024, L=8192, Z=32, equirect). With `--twin`, each
    plain twin is timed in turns with its kernel, around single calls (its
    thousands of launches overflow the launch queue behind a sleep);
  - `update_3d`: the device's time alone of `measurement_update_3d`, the
    state restored before each call outside its events: scoring the frame
    itself at the KITTI shape (stereo, P=2048, L=10240, Z=128), the bench
    shape (equirect, P=1024, L=8192, Z=32) and the panoramic config's shape
    (equirect, P=1024, L=8192, Z=128); fed `score_3d`'s scores (`ext`, as
    FastSLAM 2.0 runs it) at the KITTI shape, with and without the cull,
    and config 2's (pinhole, P=512, L=1024, Z=64);
  - `hamming`: the device's time alone of `hamming_top2` at the bench shape
    (N=1024, M=131072; all valid, and 1 in 5 invalid), config 2's closure
    match (F=256 against a store of 64 keyframes, 40 written and 33
    eligible) and the panoramic config's (F=512 against a store of 2048,
    1100 written and the first 1025 eligible), each forward (the store as
    the database) and reverse (the store as the queries);
  - `paths`: the corridor benchmark (`cli.measure_corridor`: config 1, five
    seeds of 500 frames, frames/s on the host clock and ATE) and the
    `fs2_step` bench row (one FastSLAM 2.0 step at P=1024, L=8192, Z=32,
    equirect, around single calls);
  - `posegraph`: `optimize_pose_graph` (10 LM iterations) on a drifted
    chain of K keyframes with 4K edges (the chain and seeded loop edges),
    K = 64 (config 2's graph after `shrink_to_active`), 256, 512, 1024,
    2048, around single calls.
Prints one JSON line per kernel, shape, path or K, after the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
UPDATE_SHAPES = ((64, 192, 16, 3), (2048, 10240, 32, 3))
SCORE_SHAPES = (("stereo_3d", (2048, 10240, 128)), ("equirect_3d", (1024, 8192, 32)))
POSEGRAPH_K = (64, 256, 512, 1024, 2048)


def _local(name):
    """This checkout's `eval/<name>.py`, whatever tree `--root` imports:
    the timing and the inputs are the same for every tree."""
    spec = importlib.util.spec_from_file_location(f"ab_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KI = _local("kernel_inputs")  # the shapes and inputs `chip_smoke.py` checks


def time_update_2d(shape, device, queued, single, twin):
    import torch

    from parakeet_slam_tpu_torch.kernels import ekf_update

    P, L, Z, S = shape
    fr = KI.prefilled_frame(P, L, Z, S, seed=sum(shape))
    T = {k: torch.as_tensor(v, device=device) for k, v in fr.items()}
    keys = ("pose", "log_w", "lm_mean", "lm_cov", "lm_sig", "lm_valid", "lm_count")
    state = [T[k] for k in keys]
    obs = [T["z"], T["sig"], T["valid"]]
    kw = dict(sig_dim=S, r_var=(0.01, 0.0009), sig_var=0.25, log_p0=-8.0, init_infl=1.0,
              max_range=6.5, fov_half=2.5, cull=True)
    work = [t.clone() for t in state]

    def restore(i=0):
        for w, s in zip(work, state):
            w.copy_(s)

    kernel = lambda i=0: ekf_update.measurement_update_2d(*work, *obs, **kw)  # noqa: E731
    plain = lambda i=0: ekf_update.measurement_update_2d_reference(*state, *obs, **kw)  # noqa: E731
    reps = 20 if P < 1024 else 10
    out = {"kernel": "ekf_update_2d", "shape": list(shape)}
    turns = [queued(kernel, reps=reps, prepare=restore)]
    if twin:
        turns += [single(plain, 3), queued(kernel, reps=reps, prepare=restore), single(plain, 3)]
        out["plain_ms"] = (turns[1] + turns[3]) / 2
    out["ms"] = turns[0] if not twin else (turns[0] + turns[2]) / 2
    out["turns"] = turns
    return out


def time_score_3d(model, shape, device, queued, single, twin):
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d as E

    T = _frame_3d(model, shape, device)
    args = tuple(T[k] for k in ("pose", "lm_mean", "lm_cov", "lm_desc", "lm_valid", "z", "desc"))
    kw = {k: v for k, v in KI.update_3d_kwargs(model).items() if k in KI.SCORE_3D_KEYS}
    kernel = lambda i=0: E.score_3d(*args, **kw)  # noqa: E731
    plain = lambda i=0: E.score_3d_reference(*args, **kw)  # noqa: E731
    out = {"kernel": "score_3d", "model": model, "shape": list(shape)}
    turns = [queued(kernel, reps=10)]
    if twin:
        turns += [single(plain, 2), queued(kernel, reps=10), single(plain, 2)]
        out["plain_ms"] = (turns[1] + turns[3]) / 2
    out["ms"] = turns[0] if not twin else (turns[0] + turns[2]) / 2
    out["turns"] = turns
    return out


def _frame_3d(model, shape, device):
    import numpy as np
    import torch

    P, L, Z = shape
    fr = KI.prefilled_frame_3d(P, L, Z, model, seed=P + L + Z)
    return {k: torch.as_tensor(v.view(np.int32) if v.dtype == np.uint32 else v, device=device)
            for k, v in fr.items()}


def time_update_3d(what, model, shape, ext, cull, device, queued):
    from parakeet_slam_tpu_torch.kernels import ekf_update_3d as E

    T = _frame_3d(model, shape, device)
    state = [T[k] for k in ("pose", "log_w", "lm_mean", "lm_cov", "lm_desc", "lm_valid",
                            "lm_count")]
    obs = [T["z"], T["desc"], T["valid"]]
    kw = KI.update_3d_kwargs(model, cull=cull)
    scores = ()
    if ext:
        scores = E.score_3d(*(T[k] for k in ("pose", "lm_mean", "lm_cov", "lm_desc",
                                              "lm_valid", "z", "desc")),
                            **{k: kw[k] for k in KI.SCORE_3D_KEYS})
    work = [t.clone() for t in state]

    def restore(i=0):
        for w, s in zip(work, state):
            w.copy_(s)

    kernel = lambda i=0: E.measurement_update_3d(*work, *obs, *scores, **kw)  # noqa: E731
    return {"kernel": "measurement_update_3d", "what": what, "model": model,
            "shape": list(shape), "mode": "ext" if ext else "self", "cull": cull,
            "ms": queued(kernel, reps=10, prepare=restore)}


def time_hamming(device, queued):
    """Rows of (case, device ms) for the bench shape and both closure shapes."""
    import torch

    from parakeet_slam_tpu_torch.kernels import match

    T = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    N, M = KI.HAMMING_BENCH
    qd, db, v5 = (T(a) for a in KI.hamming_bench())
    cases = [("bench all valid", (N, M), qd, db, torch.ones(M, dtype=torch.bool, device=device)),
             ("bench 1 in 5 invalid", (N, M), qd, db, v5)]
    for what, F, cap, written, eligible in KI.CLOSURE_SHAPES:
        q, qv, store, ok = (T(a) for a in KI.closure_match(F, cap, written, eligible, seed=cap))
        shape = (F, cap, written, eligible)
        cases += [(f"{what} closure forward", shape, q, store, ok),
                  (f"{what} closure reverse", shape, store, q, qv)]
    rows = []
    for what, shape, a, b, v in cases:
        ms = queued(lambda i=0: match.hamming_top2(a, b, v), reps=20)
        rows.append({"kernel": "hamming_top2", "what": what, "shape": list(shape), "ms": ms})
    return rows


def time_paths(device, single):
    from parakeet_slam_tpu_torch import cli
    from parakeet_slam_tpu_torch.eval import bench_kernels

    c = cli.measure_corridor(device)
    corridor = {"path": "corridor", "fps": c["fps"], "fps_runs": c["fps_runs"], "ate": c["ate"],
                "ates": c["ates"], "resamples": c["resamples"]}
    ms = bench_kernels.BENCHES["fs2_step"](device)[0]
    return [corridor, {"path": "fs2_step", "shape": [1024, 8192, 32], "ms": ms}]


def time_posegraph(K, device, single):
    """optimize_pose_graph on K keyframes along a circle, the estimates
    drifted from the truth by seeded tangent noise, edges measured from the
    truth: the chain, then loop edges between seeded pairs up to 4K."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.backend import graph as G
    from parakeet_slam_tpu_torch.backend import posegraph as PG
    from parakeet_slam_tpu_torch.core import geometry as geo

    rng = np.random.default_rng(K)
    E = 4 * K
    th = np.linspace(0.0, 4 * np.pi, K, endpoint=False)
    twist = np.zeros((K, 6), np.float32)
    twist[:, 0], twist[:, 1], twist[:, 5] = 20 * np.cos(th), 20 * np.sin(th), th
    gt = geo.se3_exp(torch.as_tensor(twist, device=device))
    est = geo.se3_compose(gt, geo.se3_exp(torch.as_tensor(
        0.05 * rng.normal(size=(K, 6)), dtype=torch.float32, device=device)))
    loops = rng.integers(0, K, (E - (K - 1), 2))
    ij = np.concatenate([np.stack([np.arange(K - 1), np.arange(1, K)], 1), loops]).astype(np.int32)
    ij_t = torch.as_tensor(ij, device=device).long()
    rel = geo.se3_between(gt[ij_t[:, 0]], gt[ij_t[:, 1]])
    g = G.PoseGraph(poses=est, node_valid=torch.ones(K, dtype=torch.bool, device=device),
                    edge_ij=torch.as_tensor(ij, device=device), edge_rel=rel,
                    edge_info=torch.ones(E, 6, device=device),
                    edge_valid=torch.ones(E, dtype=torch.bool, device=device),
                    n_nodes=K, n_edges=E)
    ms, (out, costs) = single(lambda: PG.optimize_pose_graph(g, iters=10), 3, True)
    return {"path": "optimize_pose_graph", "K": K, "E": E, "iters": 10, "ms": ms,
            "cost_first": float(costs[0]), "cost_last": float(costs[-1]),
            "finite": bool(torch.isfinite(out.poses).all())}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ab_kernels")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--twin", action="store_true")
    ap.add_argument("--parts", default="kernels",
                    help="comma-separated: kernels, update_3d, hamming, paths, posegraph")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import parakeet_slam_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: needs a CUDA device")
    pkg = os.path.dirname(os.path.abspath(parakeet_slam_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"ab_kernels: imported {pkg}, not the tree under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"root {root}; card: {card}")
    prof = _local("profiling")
    queued = prof.queued

    def single(fn, reps, out=False):
        ms, res = prof.timed(fn, reps=reps)
        return (ms, res) if out else ms

    device = torch.device("cuda", 0)
    parts = args.parts.split(",")
    if "kernels" in parts:
        for shape in UPDATE_SHAPES:
            print(json.dumps(time_update_2d(shape, device, queued, single, args.twin)), flush=True)
        for model, shape in SCORE_SHAPES:
            print(json.dumps(time_score_3d(model, shape, device, queued, single, args.twin)),
                  flush=True)
    if "update_3d" in parts:
        # chip_smoke.py's timed cases, and KITTI fed scores without the cull
        # (the cull's share)
        for what, model, shape, ext, cull in (*((*c, True) for c in KI.UPDATE_3D_CASES),
                                              ("kitti", "stereo_3d", KI.KITTI_3D, True, False)):
            print(json.dumps(time_update_3d(what, model, shape, ext, cull, device, queued)),
                  flush=True)
    if "hamming" in parts:
        for row in time_hamming(device, queued):
            print(json.dumps(row), flush=True)
    if "paths" in parts:
        for row in time_paths(device, single):
            print(json.dumps(row), flush=True)
    if "posegraph" in parts:
        for K in POSEGRAPH_K:
            print(json.dumps(time_posegraph(K, device, single)), flush=True)


if __name__ == "__main__":
    main()
