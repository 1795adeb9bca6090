"""Device time of the update path's two sweep kernels, and the paths around
them, for comparing trees.

    python3 parakeet_slam_tpu_torch/eval/ab_kernels.py [--root DIR] [--twin]
        [--parts kernels,update_3d,hamming,cinv,paths,posegraph,eager_solves]

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
  - `cinv`: the device's time alone of `apply_cinv` (and the kernel's own
    duration from torch.profiler's records, without the gaps between
    launches) at the kernel bench's N=262144, at N=131072, 524288 and
    1048576 (eight operand sets in turn, so that no launch finds its
    operands in the L2), at a bucket of the full-width BA problem, N=46,080
    (one operand set, which stays in the L2 as a bucket does across the
    solver's PCG iterations) and at N=1 (the launch floor); then one
    `Tensor.copy_` moving the bytes of N=262144, the card's own copy as a
    yardstick;
  - `paths`: the corridor benchmark (`cli.measure_corridor`: config 1, five
    seeds of 500 frames, frames/s on the host clock and ATE) and the
    `fs2_step` bench row (one FastSLAM 2.0 step at P=1024, L=8192, Z=32,
    equirect, around single calls);
  - `posegraph`: `optimize_pose_graph` (10 LM iterations) on a drifted
    chain of K keyframes with 4K edges (the chain and seeded loop edges),
    K = 64 (config 2's graph after `shrink_to_active`), 256, 512, 1024,
    2048: eager and, where the tree has it, captured as one CUDA graph a
    solve (`posegraph.CapturedSolver`), in turns, each call between CUDA
    events; the captured poses and costs against the eager ones;
  - `eager_solves`: the eager results of the functions that solve small
    linear systems (`optimize_pose_graph` at K = 64 and 256, the closure
    refine and the depth-relaxed refine at config 2's camera on seeded
    correspondences, Nc = 4 of F = 256), each as the SHA-256 of its output
    bytes: two trees whose digests agree compute them bit for bit alike.
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


def _kernel_ms(call, name, reps=20):
    """Median device duration of the kernels whose name holds `name` over
    `reps` calls, from torch.profiler's activity records: the kernel alone,
    without the gaps between launches that `queued` counts."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            call(i)
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return statistics.median(durs) if durs else None


def time_cinv(device, queued):
    """Rows of (N, device ms) of `apply_cinv` on contiguous operands."""
    import torch

    from parakeet_slam_tpu_torch.kernels import schur

    T = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    rows = []
    for N, n_sets in ((262144, 8), (46080, 1), (1, 1), (131072, 8), (524288, 8), (1048576, 8)):
        sets = [tuple(T(a) for a in KI.schur_blocks(N, seed=100 + i)) for i in range(n_sets)]
        call = lambda i: schur.apply_cinv(*sets[i % n_sets])  # noqa: E731
        rows.append({"kernel": "apply_cinv", "N": N, "ms": queued(call, reps=20),
                     "kernel_ms": _kernel_ms(call, "apply_cinv")})
    # the yardstick: one copy kernel moving the same bytes as N=262144 (C, u
    # and y as laid out, half read and half written), eight sets in turn
    n = 262144 * (9 + 3 + 3) // 2
    bufs = [(torch.randn(n, device=device), torch.empty(n, device=device)) for _ in range(8)]
    copy = lambda i: bufs[i % 8][1].copy_(bufs[i % 8][0])  # noqa: E731
    rows.append({"kernel": "Tensor.copy_", "bytes": 2 * 4 * n, "ms": queued(copy, reps=20),
                 "kernel_ms": _kernel_ms(copy, "")})
    return rows


def time_paths(device, single):
    from parakeet_slam_tpu_torch import cli
    from parakeet_slam_tpu_torch.eval import bench_kernels

    c = cli.measure_corridor(device)
    corridor = {"path": "corridor", "fps": c["fps"], "fps_runs": c["fps_runs"], "ate": c["ate"],
                "ates": c["ates"], "resamples": c["resamples"]}
    ms = bench_kernels.BENCHES["fs2_step"](device)[0]
    return [corridor, {"path": "fs2_step", "shape": [1024, 8192, 32], "ms": ms}]


def posegraph_case(K, device):
    """A pose graph of K keyframes along a circle, the estimates drifted
    from the truth by seeded tangent noise, edges measured from the truth:
    the chain, then loop edges between seeded pairs up to E = 4K."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.backend import graph as G
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
    return G.PoseGraph(poses=est, node_valid=torch.ones(K, dtype=torch.bool, device=device),
                       edge_ij=torch.as_tensor(ij, device=device), edge_rel=rel,
                       edge_info=torch.ones(E, 6, device=device),
                       edge_valid=torch.ones(E, dtype=torch.bool, device=device),
                       n_nodes=K, n_edges=E)


def time_posegraph(K, device, turns=3):
    """optimize_pose_graph (10 LM iterations) on `posegraph_case(K)`:
    eager, and captured (`posegraph.CapturedSolver`, where the tree has it)
    in turns after a warm-up of each (the captured one's: its eager first
    solve and its capture); milliseconds of each call between CUDA events
    recorded around it."""
    import torch

    from parakeet_slam_tpu_torch.backend import posegraph as PG

    g = posegraph_case(K, device)
    solver = (PG.CapturedSolver(iters=10, graph=True, pool=torch.cuda.graph_pool_handle())
              if hasattr(PG, "CapturedSolver") else None)
    modes = {"eager": lambda: PG.optimize_pose_graph(g, iters=10)}
    if solver is not None:
        modes["captured"] = lambda: solver(g)

    def call(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    out = {m: call(fn)[1] for m, fn in modes.items()}
    if solver is not None:
        out["captured"] = call(modes["captured"])[1]  # the capture
    ms = {m: [] for m in modes}
    for _ in range(turns):
        for m, fn in modes.items():
            t, out[m] = call(fn)
            ms[m].append(t)
    poses, costs = out["eager"][0].poses, out["eager"][1]
    row = {"path": "optimize_pose_graph", "K": K, "E": 4 * K, "iters": 10,
           "ms": min(ms["eager"]), "ms_turns": ms["eager"], "cost_first": float(costs[0]),
           "cost_last": float(costs[-1]), "finite": bool(torch.isfinite(poses).all())}
    if solver is not None:
        step = solver.steps[(K, 4 * K)]
        row.update(ms_captured=min(ms["captured"]), ms_captured_turns=ms["captured"],
                   captured_equal=bool(torch.equal(out["captured"][0].poses, poses)
                                       and torch.equal(out["captured"][1], costs)),
                   capture_s=step.capture_s, instantiate_s=step.instantiate_s,
                   pool_bytes=step.pool_bytes)
    return row


def eager_solves(device):
    """Rows of `eager_solves` (module docstring): {"case", "sha256"}."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from parakeet_slam_tpu_torch import system
    from parakeet_slam_tpu_torch.backend import posegraph as PG
    from parakeet_slam_tpu_torch.core.config import load_config

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    rows = []
    for K in (64, 256):
        out, costs = PG.optimize_pose_graph(posegraph_case(K, device), iters=10)
        rows.append({"case": f"optimize_pose_graph K={K}", "sha256": digest(out.poses, costs)})
    rng = np.random.default_rng(7)
    Nc, F = 4, 256
    pa = np.stack([rng.uniform(-1.5, 1.5, (Nc, F)), rng.uniform(-1, 1, (Nc, F)),
                   rng.uniform(2, 6, (Nc, F))], -1).astype(np.float32)
    t = rng.uniform(-0.3, 0.3, (Nc, 1, 3)).astype(np.float32)
    pb = (pa + t + 0.01 * rng.normal(size=pa.shape)).astype(np.float32)
    valid = np.arange(F)[None] < rng.integers(20, F, (Nc, 1))
    rel0 = np.concatenate([t[:, 0] + 0.02, np.tile([[0.0, 0.0, 0.0, 1.0]], (Nc, 1))], -1)
    args = [torch.as_tensor(a, device=device) for a in (rel0.astype(np.float32), pa, pb, valid)]
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "configs/tum_fr1_desk.yaml"))
    for sigma, name in ((0.0, "_refine_rel_impl"), (0.3, "_refine_rel_depth_impl")):
        c = dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, loop_refine_depth_sigma=sigma))
        s = system.SLAMSystem(c, device=device, capture=False)
        rows.append({"case": name, "sha256": digest(getattr(s, name)(*args))})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ab_kernels")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--twin", action="store_true")
    ap.add_argument("--parts", default="kernels",
                    help="comma-separated: kernels, update_3d, hamming, cinv, paths, posegraph, "
                         "eager_solves")
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
    if "cinv" in parts:
        for row in time_cinv(device, queued):
            print(json.dumps(row), flush=True)
    if "paths" in parts:
        for row in time_paths(device, single):
            print(json.dumps(row), flush=True)
    if "posegraph" in parts:
        for K in POSEGRAPH_K:
            print(json.dumps(time_posegraph(K, device)), flush=True)
    if "eager_solves" in parts:
        for row in eager_solves(device):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
