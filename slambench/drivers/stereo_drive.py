"""A closed loop of stereo pairs through the online system (traffic kind
`stereo_drive`).

Set-up makes the street world from the seed, renders the run's frame
supply on the card (`max_rate_fps` over `--seconds`, plus 8, after
`warmup_frames`), draws each frame's odometry noise and the filter's draws
(`motion_noise`, `resample_u0`), builds `SLAMSystem` on the card and runs
the warm-up frames through `process_stereo_frame` (the frame graph's eager
first frame and its capture, the first keyframes), then warms the shapes
the keyframe flush meets later (`flush_shapes`). The window hands the
frames to `process_stereo_frame` one after the other, as host float32
arrays, until `--seconds` have passed or the supply is used up, whichever
comes first: `max_rate_fps` sizes the supply and does not cap the rate. A
run that ends on its supply is correct, and notes it. The frames stay on
the lap's outbound stretch: no revisit falls in the supply.

Per frame, the latency is the time from the host's submission of the frame
to a CUDA event recorded after the call (its estimate complete on the
device), placed on the host's clock against an event recorded after a
synchronisation at the window's start; no synchronisation is added to the
loop. `frames_per_s` is the window's frames over the time to the last
one's completion.

`--trace 1` profiles `trace_frames` frames from the earlier of half of
`--seconds` and the middle of the supply, so that a run which ends on its
supply profiles them too, and turns the program's tracer and the card's
clock sampler on over the window (`harness/spans.py`).

Correct: `checked_frames` frames drawn from the seed among the window's
first frames, each worked out again by the reference from the state the
program held before it (`reference/filter.py`), and the first warm-up
frame from the reference's own initial state."""

from __future__ import annotations

import math
import random
import statistics
import time
from types import SimpleNamespace

from slambench.harness import spans, spec
from slambench.harness.trace import Stretch
from slambench.reference import filter as fref
from slambench.worlds.drive import DriveWorld


def _clone_state(state):
    return {f: getattr(state, f).clone() for f in fref.STATE_FIELDS}


def _warm_flush_shapes(sys_, p, run):
    """Capture, in set-up, the flush's programs at the shapes the window
    will meet: closure verification at each batch of `verify_batches`
    candidates, the keyframe store's closure match at each capacity of
    `store_capacities`, and the pose-graph solve at each view of
    `solve_views` [nodes, edges] (each step's eager first call and its
    capture). The program offers no public warm-up, so this reaches the
    system's own step tables; the warm-up solves run on a two-node graph of
    each view's shape and leave the system's graph alone."""
    import numpy as np
    import torch

    from parakeet_slam_tpu_torch.backend import graph as graph_mod
    from parakeet_slam_tpu_torch.backend import posegraph as pg_mod

    F = sys_.cfg.frontend.max_features
    W = sys_.cfg.filter.desc_words
    t0 = time.perf_counter()
    for nc in p["flush_shapes"]["verify_batches"]:
        pa = np.zeros((nc, F, 3), np.float32)
        valid = np.zeros((nc, F), bool)
        for _ in range(2):
            sys_._verify_batch(pa, pa, valid)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for cap in p["flush_shapes"]["store_capacities"]:
        sys_._store_buffers(cap, F, W)
        cs = sys_._match_steps[(cap, F, W)]
        for _ in range(2):
            cs()
        cs.take()
        cs.inputs["db"].zero_()
        cs.inputs["dbv"].zero_()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if sys_._pg_solver is None:
        sys_._pg_solver = pg_mod.CapturedSolver(iters=sys_.cfg.backend.gn_iters, graph=True,
                                                pool=sys_._graph_pool())
    ident = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], device=sys_.device)
    step = ident.clone()
    step[0] = 1.0
    for kc, ec in p["flush_shapes"]["solve_views"]:
        g = graph_mod.make_pose_graph(kc, ec, device=sys_.device)
        g = graph_mod.add_node(graph_mod.add_node(g, ident), step)
        g = graph_mod.add_edge(g, 0, 1, step)
        for _ in range(2):
            sys_._pg_solver(g)
    torch.cuda.synchronize()
    run.note(f"stereo_drive set-up: the flush's shapes: verify {t1 - t0:.2f} s, closure match "
             f"{t2 - t1:.2f} s, pose-graph solve {time.perf_counter() - t2:.2f} s")


def run(run):
    import torch

    import parakeet_slam_tpu_torch  # noqa: F401
    from parakeet_slam_tpu_torch.system import SLAMSystem

    cuda = run.device == "cuda"
    dev = torch.device(run.device, 0) if cuda else torch.device(run.device)
    p = run.cell.traffic["params"]
    cfg = spec.port_config(run.cell.config)
    warm = int(p["warmup_frames"])
    n_frames = warm + int(math.ceil(float(p["max_rate_fps"]) * run.seconds)) + 8
    if n_frames > int(p["lap_frames"]) - int(p["revisit_margin_frames"]):
        raise SystemExit("stereo_drive: the run's frames would reach the lap's revisit")
    t_phase = time.perf_counter()
    world = DriveWorld(p, run.seed, dev, n_frames)
    left, right = world.render_stereo(0, n_frames)
    run.note(f"stereo_drive set-up: {n_frames} stereo pairs rendered in "
             f"{time.perf_counter() - t_phase:.2f} s")
    odom = world.odom.cpu().numpy()
    P = cfg.filter.num_particles
    g = torch.Generator(device=dev).manual_seed(run.seed ^ 0x5EED)
    sys_ = SLAMSystem(cfg, device=str(dev))
    noise = torch.randn(n_frames, P, sys_.slam.noise_dim, generator=g, device=dev)
    u0 = torch.rand(n_frames, generator=g, device=dev) / P
    ref = fref.Frame(run.cell.config["run"], dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # what a frame hands to `_post_step`, for the checked frames
    seen = {}
    post_step = sys_._post_step

    def keep(*out):
        seen["out"] = out
        return post_step(*out)

    sys_._post_step = keep

    def frame(i):
        return sys_.process_stereo_frame(left[i], right[i], odom[i], motion_noise=noise[i],
                                         resample_u0=u0[i])

    # the start: frame 0 from the initial state, checked against the
    # reference's own initial state
    start_kf = (sys_._last_kf_dev.clone(), sys_._has_kf_dev.clone())
    t_phase = time.perf_counter()
    frame(0)
    start = (_clone_state(sys_.state), [t.clone() for t in seen["out"][:2]],
             [t.clone() for t in seen["out"][2]])
    for i in range(1, warm):
        frame(i)
    sync()
    t_warm = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    if cuda:
        _warm_flush_shapes(sys_, p, run)
    sync()
    run.note(f"stereo_drive set-up: {warm} warm-up frames {t_warm:.2f} s, the flush's shapes "
             f"{time.perf_counter() - t_phase:.2f} s")
    keys_before = _program_keys(sys_)
    run.setup_done()

    # checked frames: none that flushes, since a flush may correct the state
    # after the frame's graph
    rng = random.Random(run.seed)
    lo, hi = p["checked_window_frames"]
    pool = [k for k in range(warm + lo, warm + hi) if (k + 1) % sys_.kf_flag_lag != 0]
    checked = sorted(rng.sample(pool, int(p["checked_frames"])))
    snaps = {}
    lat_sub, calls, events, ests = [], [], [], []
    stretch_at = None
    t_trace, i_trace = run.seconds / 2, warm + (n_frames - warm) // 2
    ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
    w = spans.window_begin(run)
    sync()
    if cuda:
        ev0.record()
    t0 = time.perf_counter()
    i = warm
    while True:
        if i >= n_frames:
            run.note(f"stereo_drive: the window ended on its frame supply after {i - warm} "
                     f"frames, {time.perf_counter() - t0:.3f} s")
            break
        tracing = (run.trace and stretch_at is None and i > max(checked, default=-1)
                   and (i >= i_trace or time.perf_counter() - t0 >= t_trace))
        if tracing:
            stretch_at = i
            n_tr = min(int(p["trace_frames"]), n_frames - i)
            # the valid lanes a traced frame starts from: the frame before's
            traced = [seen["out"][3].num_landmarks]
            with Stretch() as st:
                for k in range(n_tr):
                    lat_sub.append(time.perf_counter() - t0)
                    ests.append(frame(i))
                    calls.append(time.perf_counter() - t0 - lat_sub[-1])
                    traced.append(seen["out"][3].num_landmarks)
                    events.append(_event(cuda))
                    i += 1
            run.stretch = st.summary
            lanes = [float(t) for t in traced[:-1]]
            score = [e - s for _, s, e in run.stretch.kernels("score_3d_kernel")]
            run.note(f"stereo_drive trace: valid lanes a particle {lanes}, score_3d us {score}")
            run.counters.update(frames_traced=n_tr, particles=P, lanes_mean=lanes,
                                flush_frames_traced=sum(1 for k in range(stretch_at, i)
                                                        if (k + 1) % sys_.kf_flag_lag == 0))
            continue
        pre = None
        if i in checked:
            pre = (_clone_state(sys_.state), sys_._last_kf_dev.clone(), sys_._has_kf_dev.clone())
        lat_sub.append(time.perf_counter() - t0)
        ests.append(frame(i))
        calls.append(time.perf_counter() - t0 - lat_sub[-1])
        events.append(_event(cuda))
        if pre is not None:
            out = seen["out"]
            snaps[i] = (pre, _clone_state(sys_.state), out[0].clone(), out[1].clone(),
                        [t.clone() for t in out[2]])
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    sync()
    window = time.perf_counter() - t0
    if w is not None:
        sys_.flush_metrics()
    spans.window_end(run, w)
    n = i - warm
    run.attempted = n
    # each frame's completion, in ms after the window's start: on the card by
    # its event; on the CPU, which runs a call to its end, when the call returned
    done = ([ev0.elapsed_time(e) for e in events] if cuda
            else [(e - t0) * 1e3 for e in events])
    lat = [d - s * 1e3 for d, s in zip(done, lat_sub)]
    window = max(window, done[-1] / 1e3)
    run.e2e["frames_per_s"] = n / (done[-1] / 1e3)
    q = statistics.quantiles(lat, n=20, method="inclusive")
    flush = [lat[k] for k in range(n) if (warm + k + 1) % sys_.kf_flag_lag == 0]
    run.counters["flush_frame_ms"] = statistics.median(flush) if flush else None
    run.note(f"stereo_drive: {n} frames in {window:.3f} s, latency samples {len(lat)}, "
             f"median {statistics.median(lat):.2f} ms, p95 {q[18]:.2f} ms, "
             f"max {max(lat):.2f} ms; flush frames {len(flush)}, median "
             f"{run.counters['flush_frame_ms']} ms")
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        _note_where_time_went(run, warm, n, sys_.kf_flag_lag, calls, done, lat)
    est_host = torch.stack(ests).cpu()
    run.failed = int((~torch.isfinite(est_host).all(dim=1)).sum())
    new_keys = {k: v - keys_before.get(k, 0) for k, v in _program_keys(sys_).items()
                if v != keys_before.get(k, 0)}
    run.note(f"stereo_drive: keyframes {len(sys_.keyframes)}, closures {len(sys_.loop_closures)}, "
             f"programs first used in the window {new_keys or 'none'}")
    if new_keys:
        run.note("stereo_drive: a program was captured inside the window")

    # the reference, after the program's state is freed
    del sys_
    if cuda:
        torch.cuda.empty_cache()
    got = [_check_frame(ref, start[0], start[1], start[2], None, 0, left, right, odom, noise,
                        u0, run, start_kf)]
    for k in checked:
        if k in snaps:
            pre, post, est, flag, snap = snaps[k]
            got.append(_check_frame(ref, post, [est, flag], snap, pre, k, left, right, odom,
                                    noise, u0, run, None))
        else:
            run.errors.append(f"checked frame {k} is past the window's end")
    run.hold([n for n, _ in got], [c for _, c in got])


def _note_where_time_went(run, warm, n, lag, calls, done, lat):
    """Whether a slow run lost its time on the host or on the device: the
    host's time inside a frame's call (a flush frame's holds the flush),
    the device's time between two consecutive completions of frames that
    do not flush, and the card's clocks after the window."""
    from slambench.harness import env

    flush = [(warm + k + 1) % lag == 0 for k in range(n)]
    host_f = [c * 1e3 for c, f in zip(calls, flush) if f]
    host_o = [c * 1e3 for c, f in zip(calls, flush) if not f]
    dev_o = [done[k] - done[k - 1] for k in range(1, n) if not flush[k] and not flush[k - 1]]
    slow = sum(1 for k in range(n) if flush[k] and lat[k] > 340.0)
    med = lambda xs: f"{statistics.median(xs):.2f}" if xs else "none"  # noqa: E731
    run.note(f"stereo_drive: host ms in a frame's call: flush frames median {med(host_f)}, "
             f"max {max(host_f, default=0.0):.2f}; other frames median {med(host_o)}, max "
             f"{max(host_o, default=0.0):.2f}; device ms between two non-flush frames' "
             f"completions: median {med(dev_o)}, max {max(dev_o, default=0.0):.2f}; flush "
             f"frames over 340 ms {slow} of {len(host_f)}; card after the window: "
             f"{env.card_clocks()}")


def _event(cuda):
    import torch

    if not cuda:
        return time.perf_counter()
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _program_keys(sys_) -> dict:
    """Counts of the system's captured programs by kind."""
    pg = sys_._pg_solver
    return {"frame": len(sys_._frame_steps), "verify": len(sys_._verify_steps),
            "match": len(sys_._match_steps), "solve": len(pg.steps) if pg is not None else 0}


def _check_frame(ref, post, est_flag, snap, pre, k, left, right, odom, noise, u0, run, start_kf):
    import torch

    dev = ref.device
    last_kf, has_kf = start_kf if pre is None else pre[1:]
    lt = torch.as_tensor(left[k], device=dev)
    rt = torch.as_tensor(right[k], device=dev)
    u = torch.as_tensor(odom[k], device=dev)
    post_t = SimpleNamespace(**post)

    def one(ctl):
        obs = ref.stereo_observation(lt, rt)
        src = (ref.init_state() if pre is None
               else SimpleNamespace(**{f: t.clone() for f, t in pre[0].items()}))
        return ref.step(src, u, obs, noise[k], u0[k], last_kf, has_kf, bf16_state=ctl)

    t0 = time.perf_counter()
    r = one(False)
    nums = fref.compare(post_t, est_flag[0], est_flag[1], snap, r)
    run.note(f"frame {k}: the reference took {time.perf_counter() - t0:.2f} s; "
             "program against the reference: "
             + " ".join(f"{a}={b!r}" for a, b in nums.items()))
    cn = None
    if run.with_control:
        c = one(True)
        cn = fref.compare(c[0], c[1], c[2], c[3], r)
        run.note(f"frame {k}: control (the reference, its state in bfloat16) against the "
                 "reference: " + " ".join(f"{a}={b!r}" for a, b in cn.items()))
    return nums, cn
