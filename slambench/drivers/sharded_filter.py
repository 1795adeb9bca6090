"""The sharded filter of config 5 in a closed loop on every rank (traffic
kind `sharded_filter`).

Each rank builds the configuration's filter on the particle axis of a mesh
of all ranks (`dist.sharded_filter.ShardedFastSLAM`, its rows of the
state), makes every frame's observations, odometry and draws on its card
from the seed (the same on every rank; `worlds/panoramic.py`), and runs the
step and the estimate as one captured program (`filter.captured
.CapturedStep`: the PR 15 graph, NCCL's gathers and the ring's transfers
inside). Set-up runs `warmup_frames` frames (the eager first frame, the
capture, NCCL's first connections). The window copies each frame's
inputs into the step's static inputs and replays it; every `sync_every`
frames rank 0 tells all ranks whether the window has closed (a one-element
broadcast read on the host), so every rank stops at the same frame.
`frames_per_s.sharded` is rank 0's frames over its window.

`--trace 1` profiles `trace_frames` frames on every rank at once.

Correct: `checked_frames` frames drawn from the seed among the window's
first frames: every rank's state before and after each is gathered to rank
0, whose reference works the frame out again on the whole state on one
device (`reference/filter.py`), and the first warm-up frame from the
reference's own initial state."""

from __future__ import annotations

import math
import random
import time
from types import SimpleNamespace

from slambench.harness import spec
from slambench.harness.trace import Stretch
from slambench.reference import filter as fref
from slambench.worlds.panoramic import PanoWalk


def _gather(state, group_size):
    """Every rank's rows of each state leaf, concatenated in rank order on
    every rank (plain all-gathers)."""
    import torch
    import torch.distributed as tdist

    out = {}
    for f in fref.STATE_FIELDS:
        t = getattr(state, f).contiguous()
        if group_size == 1:
            out[f] = t.clone()
            continue
        full = torch.empty((group_size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                           device=t.device)
        tdist.all_gather_into_tensor(full, t)
        out[f] = full
    return out


def run(run):
    import torch
    import torch.distributed as tdist

    import parakeet_slam_tpu_torch  # noqa: F401
    from parakeet_slam_tpu_torch.core.state import Observation
    from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost
    from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
    from parakeet_slam_tpu_torch.filter import captured, make_filter

    cuda = run.device == "cuda"
    initialize_multihost()
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    rank = tdist.get_rank() if tdist.is_initialized() else 0
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    p = run.cell.traffic["params"]
    cfg = spec.port_config(run.cell.config)
    fc = cfg.filter
    P, Z, W = fc.num_particles, fc.max_observations, fc.desc_words
    warm = int(p["warmup_frames"])
    every = int(p["sync_every"])
    n_frames = warm + int(math.ceil(float(p["max_rate_fps"]) * run.seconds)) + 2 * every
    walk = PanoWalk(p, run.seed, dev, n_frames, Z, W, cfg.frontend.image_size)
    g = torch.Generator(device=dev).manual_seed(run.seed ^ 0x5EED)
    slam = make_filter(fc, cfg.frontend)
    mesh = mesh_mod.make_mesh(map_axis=cfg.dist.map_axis)
    sharded = ShardedFastSLAM(slam, mesh)
    noise = torch.randn(n_frames, P, slam.noise_dim, generator=g, device=dev)
    u0 = torch.rand(n_frames, generator=g, device=dev) / P
    state = sharded.init_state(device=dev)

    def obs_of(i):
        return Observation(z=walk.z[i], sig=torch.zeros(Z, 0, device=dev), desc=walk.desc[i],
                           valid=walk.valid[i])

    def fn(st, x):
        st, metrics = sharded.step(st, x["u"], x["obs"], x["noise"], x["u0"])
        return st, (sharded.estimate_pose(st), metrics.num_landmarks, metrics.match_frac)

    inputs = {"u": walk.odom[0].clone(), "obs": captured.clone(obs_of(0)),
              "noise": sharded.local_draws(noise[0]).clone(), "u0": u0[0].clone()}
    cs = captured.CapturedStep(fn, state, inputs, graph=cuda)

    def frame(i):
        x = cs.inputs
        x["u"].copy_(walk.odom[i])
        x["obs"].z.copy_(walk.z[i])
        x["obs"].desc.copy_(walk.desc[i])
        x["obs"].valid.copy_(walk.valid[i])
        x["noise"].copy_(sharded.local_draws(noise[i]))
        x["u0"].copy_(u0[i])
        cs()
        return cs.take()

    ref = fref.Frame(run.cell.config["run"], dev) if rank == 0 else None
    frame(0)
    start = (_gather(cs.state, world), [t.clone() for t in cs.take()])
    for i in range(1, warm):
        frame(i)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    if world > 1:
        tdist.barrier()
    if rank == 0:
        run.setup_done()

    rng = random.Random(run.seed)
    lo, hi = p["checked_window_frames"]
    checked = sorted(rng.sample(range(warm + lo, warm + hi), int(p["checked_frames"])))
    snaps, ests = {}, []
    t0 = time.perf_counter()
    i = warm
    trace_pending = False
    lanes = []
    while True:
        if i + every > n_frames:
            run.errors.append(f"the window used up its {n_frames - warm} frames")
            break
        if trace_pending:
            n_tr = int(p["trace_frames"])
            lanes, matched = [float(ests[-1][1])], []
            with Stretch() as st:
                for _ in range(n_tr):
                    ests.append(frame(i))
                    lanes.append(ests[-1][1])
                    matched.append(ests[-1][2])
                    i += 1
            run.stretch = st.summary
            run.counters.update(frames_traced=n_tr, lanes_mean=[float(x) for x in lanes[:-1]],
                                match_frac=[float(x) for x in matched],
                                local_particles=sharded.local_particles)
            trace_pending = False
        for _ in range(every):
            pre = _gather(cs.state, world) if i in checked else None
            out = frame(i)
            if pre is not None:
                snaps[i] = (pre, _gather(cs.state, world), [t.clone() for t in out])
            ests.append(out)
            i += 1
        # rank 0 decides: 0 go on, 1 the window has closed, 2 trace next
        if rank == 0:
            el = time.perf_counter() - t0
            flag.fill_(1 if el >= run.seconds else
                       2 if run.trace and run.stretch is None and el >= run.seconds / 2 else 0)
        if world > 1:
            tdist.broadcast(flag, 0)
        f = int(flag.item())
        if f == 1:
            break
        trace_pending = f == 2
    sync()
    window = time.perf_counter() - t0
    n = i - warm
    run.attempted = n
    if rank == 0:
        run.e2e["frames_per_s.sharded"] = n / window
        run.note(f"sharded_filter: {world} ranks, {n} frames in {window:.3f} s")
    if cuda:
        peak = torch.tensor([torch.cuda.max_memory_allocated()], dtype=torch.int64, device=dev)
        if world > 1:
            tdist.all_reduce(peak, op=tdist.ReduceOp.MAX)
        run.memory_peak_bytes = int(peak.item())
    if run.trace and run.stretch is not None:
        nccl = sum(e - s for name, s, e in run.stretch.kernels("nccl")) / 1e3
        run.counters["nccl_ms_per_frame"] = nccl / run.counters["frames_traced"]
        mine = torch.tensor([run.stretch.busy_s, run.stretch.wall_s], dtype=torch.float64,
                            device=dev)
        if world > 1:
            tdist.all_reduce(mine)
        run.busy_s, run.window_s = float(mine[0]) / world, float(mine[1]) / world
    est_host = torch.stack([e[0] for e in ests]).cpu()
    run.failed = int((~torch.isfinite(est_host).all(dim=1)).sum())

    # free the program's graph before the group and the reference
    del cs
    import gc

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank == 0:
        got = [_check(ref, None, start[0], start[1], 0, walk, noise, u0, obs_of, run)]
        for k in checked:
            if k in snaps:
                pre, post, out = snaps[k]
                got.append(_check(ref, pre, post, out, k, walk, noise, u0, obs_of, run))
            else:
                run.errors.append(f"checked frame {k} is past the window's end")
        run.hold([n for n, _ in got], [c for _, c in got])
    if world > 1:
        tdist.barrier()
        tdist.destroy_process_group()


def _check(ref, pre, post, out, k, walk, noise, u0, obs_of, run):
    import torch

    dev = ref.device
    o = obs_of(k)
    obs = ref.observation(o.z, o.desc, o.valid)
    last_kf = torch.zeros(7, device=dev)
    has = torch.ones((), dtype=torch.bool, device=dev)

    def one(ctl):
        src = (ref.init_state() if pre is None
               else SimpleNamespace(**{f: v.clone() for f, v in pre.items()}))
        return ref.step(src, walk.odom[k], obs, noise[k], u0[k], last_kf, has, bf16_state=ctl)

    t0 = time.perf_counter()
    r = one(False)
    run.note(f"frame {k}: the reference took {time.perf_counter() - t0:.2f} s")
    snap = ref.snapshot(r[0], r[1])  # the cell's step makes no snapshot: compare the reference's
    nums = fref.compare(SimpleNamespace(**post), out[0], r[2], snap, r)
    # the cell's step makes no keyframe test and no snapshot
    unused = ("flag_differs", "snapshot_mismatch_share")
    nums = {k2: v for k2, v in nums.items() if k2 not in unused}
    run.note(f"frame {k}: program against the reference: "
             + " ".join(f"{a}={b!r}" for a, b in nums.items()))
    cn = None
    if run.with_control:
        c = one(True)
        cn = {a: b for a, b in fref.compare(c[0], c[1], c[2], c[3], r).items()
              if a not in unused}
        run.note(f"frame {k}: control (the reference, its state in bfloat16) against the "
                 "reference: " + " ".join(f"{a}={b!r}" for a, b in cn.items()))
    return nums, cn
