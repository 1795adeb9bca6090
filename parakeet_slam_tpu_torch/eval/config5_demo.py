"""Config-5 demonstration (port of `parakeet_slam_tpu.eval.config5_demo`):
the panoramic online system with its particle axis sharded, a
131,072-slot map, ring-streamed matching over a sharded descriptor
database, the distributed BA over 100,000+ points, and the weak-scaling
table, one JSON row each under the reference's keys. The distributed BA
also runs on a second, well-posed problem (`make_ring_ba`), and its rows
add the accepted cost and steps and the camera-position difference from the
one-rank solve.

    python -m parakeet_slam_tpu_torch.eval.config5_demo [--device cpu] [--parts ba]

on N processes with COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID set
(`dist/multihost.py`; NCCL with one card per rank); one process alone
starts a process group of one rank, so the sharded program runs through its
collectives at world size 1. Rank 0 prints, and writes the rows to --out
when given. Each part runs as the port runs by default (on CUDA the
captured programs: the system's frame graph with the sharded step's
collectives inside, the ring match's graph, the distributed BA's graph an
LM iteration) and again eagerly (`capture=False`) in the same process:
the rows hold both times and whether the two agree bit for bit. The BA problem is `eval/kernel_inputs.ba_bench_problem`'s
(numpy draws, where the reference draws with jax.random).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import os
import time

import numpy as np
import torch

from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.multihost import free_local_port, process_index


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _say(row):
    if process_index() == 0:
        print(json.dumps(row))
    return row


def _world() -> int:
    return torch.distributed.get_world_size() if mesh_mod.is_distributed() else 1


def _ranks_agree(tensors, group=None) -> bool:
    """Whether every rank of `group` (the default group when None) holds
    the same bits in `tensors`: their SHA-256 digests, all-gathered."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    if not mesh_mod.is_distributed():
        return True
    got = [None] * torch.distributed.get_world_size(group)
    torch.distributed.all_gather_object(got, h.hexdigest(), group=group)
    return len(set(got)) == 1


def demo_online_sharded(n_frames=6, L=131072, P=32, Z=16, device="cuda", image_size=(128, 256),
                        capture=None):
    """The panoramic online system with a 131,072-slot map, its particle
    axis sharded over every rank (dcn = 2 when the world size is even, as
    the reference's 2 x 4 mesh), run with `capture` (None: captured on
    CUDA) and again eagerly on the same frames and draws; rank 0 then runs
    the frames on one device and reports whether the estimates and
    keyframes are bit-equal. Frames 3 to n_frames are timed (the first
    runs eagerly, the second captures)."""
    from parakeet_slam_tpu_torch.core.config import (
        BackendConfig, DistConfig, FilterConfig, FrontendConfig, SLAMConfig,
    )
    from parakeet_slam_tpu_torch.data.panoramic import make_panoramic_world
    from parakeet_slam_tpu_torch.system import SLAMSystem

    H, W = image_size
    world = _world()
    map_axis = 2 if world % 2 == 0 else 1
    cfg = SLAMConfig(
        filter=FilterConfig(
            num_particles=P, max_landmarks=L, max_observations=Z,
            lm_dim=3, obs_dim=2, pose_dim=7, sig_dim=0, desc_words=8,
            measurement_model="equirect_3d", motion_model="se3_odometry",
            motion_noise=(0.02, 0.01), meas_noise=(3.0, 3.0),
            init_range_prior=14.0, init_range_sigma=8.0,
            new_landmark_loglik=-14.0, max_range=45.0,
        ),
        frontend=FrontendConfig(
            detector="fast", max_features=Z, fast_threshold=0.12,
            camera="equirect", image_size=(H, W),
        ),
        backend=BackendConfig(max_keyframes=64, keyframe_translation=1.0),
        dist=DistConfig(particle_axis=world // map_axis, map_axis=map_axis),
    )
    scene = make_panoramic_world(num_landmarks=300, num_steps=n_frames, image_size=(H, W),
                                 seed=11)
    images = [scene.render(t) for t in range(n_frames)]

    def run(capture_):
        sys_ = SLAMSystem(cfg, device=device, capture=capture_)
        if sys_._sharded is None:
            raise RuntimeError("the online system did not shard: no process group is up")
        est = [sys_.process_frame(images[t], scene.odom[t]) for t in range(min(2, n_frames))]
        _sync(device)
        t0 = time.perf_counter()
        est += [sys_.process_frame(images[t], scene.odom[t]) for t in range(2, n_frames)]
        _sync(device)
        fps = (n_frames - 2) / (time.perf_counter() - t0) if n_frames > 2 else None
        sys_.flush_flags()
        return sys_, torch.stack(est), fps

    sys_, est, fps = run(capture)
    eager, est_e, fps_e = run(False)
    same = (_bits_equal(est, est_e) and [k.frame for k in sys_.keyframes]
            == [k.frame for k in eager.keyframes])
    ranks = _ranks_agree([est, est_e, *(torch.as_tensor(k.pose) for k in sys_.keyframes)])
    parity = None
    if process_index() == 0:
        # the same frames and draws on one device (dist 1 x 1 fits no world
        # of several ranks; in a world of one it is the 1 x 1 mesh)
        one = SLAMSystem(dataclasses.replace(cfg, dist=DistConfig()), device=device)
        est1 = [one.process_frame(images[t], scene.odom[t]) for t in range(n_frames)]
        one.flush_flags()
        parity = (torch.equal(est, torch.stack(est1))
                  and [k.frame for k in one.keyframes] == [k.frame for k in sys_.keyframes])
    return _say({
        "bench": "online_sharded_filter",
        "mesh": dict(sys_.mesh.shape),
        "particles": P,
        "map_capacity": L,
        "captured": sys_.capture,
        "frames_per_s": None if fps is None else round(fps, 3),
        "frames_per_s_eager": None if fps_e is None else round(fps_e, 3),
        "keyframes": len(sys_.keyframes),
        "captured_equals_eager": same,
        "ranks_agree": ranks,
        "parity_vs_one_device": parity,
    })


def _bits_equal(a, b) -> bool:
    """Two tensors equal bit for bit (NaN by its bits, -0.0 apart from 0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(bits), b.contiguous().view(bits)
    return torch.equal(a, b)


def demo_ring_match(M=131072, N=256, W=8, device="cuda", reps=5, capture=None):
    """Matching against the whole database, sharded over every rank and
    streamed round the ring (`dist/ring_match.py`), with `capture` (None:
    the ring's graph on CUDA) and eagerly, checked against the dense twin
    on the whole database and against each other."""
    from parakeet_slam_tpu_torch.dist.ring_match import ring_hamming_top2
    from parakeet_slam_tpu_torch.kernels import match as match_mod

    mesh = mesh_mod.make_mesh(map_axis=1)
    rng = np.random.default_rng(0)
    T = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    qd = T(rng.integers(0, 2**32, (N, W), dtype=np.uint32).view(np.int32))
    db = T(rng.integers(0, 2**32, (M, W), dtype=np.uint32).view(np.int32))
    dbv = T(rng.random(M) > 0.05)
    rows = mesh_mod.particle_sharding(mesh).rows(M)
    db_l, dbv_l = db[rows].contiguous(), dbv[rows].contiguous()
    qv = torch.ones(N, dtype=torch.bool, device=device)

    def timed(capture_):
        for _ in range(2):  # warm-up (and, captured, the capture)
            out = ring_hamming_top2(qd, qv, db_l, dbv_l, mesh, capture=capture_)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = ring_hamming_top2(qd, qv, db_l, dbv_l, mesh, capture=capture_)
        _sync(device)
        return out, (time.perf_counter() - t0) / reps

    out, dt = timed(capture)
    out_e, dt_e = timed(False)
    _, b1, b2 = out
    _, r1, r2 = match_mod.hamming_top2_reference(qd, db, dbv)
    return _say({
        "bench": "ring_match",
        "db_size": M,
        "queries": N,
        "devices": mesh.size,
        "ms": round(dt * 1e3, 4),
        "ms_eager": round(dt_e * 1e3, 4),
        "captured_equals_eager": all(torch.equal(a, b) for a, b in zip(out, out_e)),
        "ranks_agree": _ranks_agree(out),
        "parity_vs_reference": bool(torch.equal(b1, r1) and torch.equal(b2, r2)),
    })


def make_big_ba(C=64, Pts=110000, obs_per_cam=2000, seed=0, device="cuda"):
    """(camera, BAProblem): the reference's `_make_big_ba` layout (C
    cameras, Pts points, C * obs_per_cam observations) from
    `kernel_inputs.ba_bench_problem`'s numpy draws."""
    from parakeet_slam_tpu_torch.backend.graph import make_ba_problem
    from parakeet_slam_tpu_torch.eval.kernel_inputs import BA_BENCH_CAMERA, ba_bench_problem
    from parakeet_slam_tpu_torch.frontend.camera import Pinhole

    return Pinhole(*BA_BENCH_CAMERA), make_ba_problem(
        **ba_bench_problem(C=C, Pts=Pts, obs_per_cam=obs_per_cam, seed=seed), device=device)


# The LM's initial damping: from the reference's 1e-4 on these numpy draws
# every candidate of the first iterations is rejected (float32 overflows
# points seen once: the reference's solver rejects them too, at 1.9e12,
# 1.3e10 and 1.9e6 against 8,800), where 1e-2 descends from the first.
BA_LAM = 1e-2
BA_HUBER = 50.0  # the reference's Huber threshold in pixels


def make_ring_ba(C=32, Pts=4000, seed=11, device="cuda"):
    """(camera, BAProblem): `kernel_inputs.ring_ba_problem`, a well-posed
    problem whose points are each seen by many cameras."""
    from parakeet_slam_tpu_torch.backend.graph import make_ba_problem
    from parakeet_slam_tpu_torch.eval.kernel_inputs import RING_BA_CAMERA, ring_ba_problem
    from parakeet_slam_tpu_torch.frontend.camera import Pinhole

    fields, _ = ring_ba_problem(C=C, Pts=Pts, seed=seed)
    return Pinhole(*RING_BA_CAMERA), make_ba_problem(**fields, device=device)


def _sharded_cost(cam, sp, mesh, cam_pose, points):
    """The cost of (cam_pose, all points) on the sharded problem `sp`, with
    `dist_ba`'s own arithmetic: this rank's block, summed over `dcn`."""
    from parakeet_slam_tpu_torch.dist import dist_ba

    S = mesh.axis_size(mesh_mod.MAP_AXIS)
    k = mesh.axis_index(mesh_mod.MAP_AXIS)
    rows = mesh_mod.RowSharding(mesh, mesh_mod.MAP_AXIS).rows(sp.num_points)
    O_l = sp.num_obs // S
    o = slice(k * O_l, (k + 1) * O_l)
    c = dist_ba._cost(cam, cam_pose, points[rows], sp.obs_cam[o].long(),
                      sp.obs_pt[o].long() - rows.start, sp.obs_uv[o], sp.obs_valid[o], BA_HUBER)
    return float(mesh_mod.all_reduce_sum(c, mesh, mesh_mod.MAP_AXIS))


def demo_dist_ba(Pts=110000, iters=3, pcg_iters=15, map_axes=(1, 2, 4), device="cuda",
                 obs_per_cam=2000, lam=BA_LAM, problem="bench", capture=None):
    """The distributed BA, point blocks sharded over `dcn`; weak scaling
    over the map axis (the sizes that fit the world). `problem` "bench" is
    the 100,000+ point layout, most points seen once; "ring" is
    `make_ring_ba` (C=32, Pts points, each seen by many cameras). Each row
    holds the last candidate's cost (`final_cost`, the reference's key), the
    last accepted cost and the number of accepted LM steps, replayed from
    the candidates' costs with the solver's own rule and cost arithmetic,
    and the largest camera-position difference from the S=1 solve. The
    solve runs with `capture` (None: one graph an LM iteration on CUDA)
    and again eagerly: `lm_iters_per_s_eager` and whether costs, poses and
    points agree bit for bit (`captured_equals_eager`)."""
    from parakeet_slam_tpu_torch.dist import dist_ba

    if problem == "ring":
        cam, prob = make_ring_ba(Pts=Pts, device=device)
    else:
        cam, prob = make_big_ba(Pts=Pts, obs_per_cam=obs_per_cam, device=device)
    rows, base, cam1 = [], None, None
    for S in map_axes:
        if S > _world():
            continue
        mesh = mesh_mod.make_mesh(n_devices=S, map_axis=S)
        if not mesh.is_member:
            continue
        sp = dist_ba.shard_problem(prob, S)

        def call(capture_):
            return dist_ba.optimize_ba_distributed(cam, sp, mesh, iters=iters, lam=lam,
                                                   pcg_iters=pcg_iters, huber_delta=BA_HUBER,
                                                   capture=capture_)

        def timed(capture_):
            call(capture_)  # warm-up (and, captured, the capture)
            _sync(device)
            t0 = time.perf_counter()
            res = call(capture_)
            _sync(device)
            return res, iters / (time.perf_counter() - t0)

        (out, costs), ips = timed(capture)
        (out_e, costs_e), ips_e = timed(False)
        same = (_bits_equal(costs, costs_e) and _bits_equal(out.cam_pose, out_e.cam_pose)
                and _bits_equal(out.points, out_e.points))
        ranks = _ranks_agree([costs, out.cam_pose, out.points],
                             mesh.axis_group(mesh_mod.BOTH_AXES))
        base = ips if base is None else base
        # the solver accepts a candidate whose cost is below the current one
        accepted = _sharded_cost(cam, sp, mesh, sp.cam_pose, sp.points)
        n_acc = 0
        for c in costs.tolist():
            if c < accepted:
                accepted, n_acc = c, n_acc + 1
        cam_pos = out.cam_pose[:, :3].cpu()
        cam1 = cam_pos if cam1 is None else cam1
        rows.append(_say({
            "bench": "dist_ba",
            "problem": problem,
            "points": int(prob.num_points),
            "obs": int(prob.obs_valid.sum()),
            "map_shards": S,
            "lm_iters_per_s": round(ips, 3),
            "lm_iters_per_s_eager": round(ips_e, 3),
            "captured_equals_eager": same,
            "ranks_agree": ranks,
            "efficiency_vs_1shard": round(ips / base, 3),
            "final_cost": float(costs[-1]),
            "accepted_cost": accepted,
            "returned_cost": _sharded_cost(cam, sp, mesh, out.cam_pose, out.points),
            "accepted_steps": n_acc,
            "max_cam_pos_diff_vs_1shard": float((cam_pos - cam1).abs().max()),
        }))
    return rows


def main(argv=None):
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost
    from parakeet_slam_tpu_torch.eval.scaling import measure_scaling

    ap = argparse.ArgumentParser(prog="parakeet_slam_tpu_torch.eval.config5_demo")
    ap.add_argument("--out", default="", help="write the rows as one JSON file (rank 0)")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--ba-points", type=int, default=110000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", default="online,ring,ba,scaling",
                    help="comma list of the demos to run: online, ring, ba, scaling")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device available (use --device cpu)")
    own_group = False
    if not initialize_multihost():
        # one process: a group of one rank, so the collectives run
        torch.distributed.init_process_group(
            "nccl" if args.device == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{free_local_port()}", world_size=1, rank=0)
        own_group = True
    try:
        art = {"devices": _world(), "platform": args.device,
               "kind": torch.cuda.get_device_name() if args.device == "cuda" else "cpu"}
        _say({"devices": art["devices"], "kind": art["kind"]})
        if "online" in parts:
            art["online"] = demo_online_sharded(n_frames=args.frames, device=args.device)
        if "ring" in parts:
            art["ring_match"] = demo_ring_match(device=args.device)
        if "ba" in parts:
            art["dist_ba"] = demo_dist_ba(Pts=args.ba_points, device=args.device)
            art["dist_ba_ring"] = demo_dist_ba(Pts=4000, iters=6, pcg_iters=60, lam=1e-4,
                                               device=args.device, problem="ring")
        if "scaling" in parts:
            art["filter_weak_scaling"] = measure_scaling(device=args.device)
        if args.out and process_index() == 0:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(art, f, indent=1)
            print(f"wrote {args.out}")
    finally:
        # the captured programs hold NCCL's communicators: free their graphs
        # (kept in reference cycles with their meshes) before the group goes
        gc.collect()
        if args.device == "cuda":
            torch.cuda.synchronize()
        if own_group:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
