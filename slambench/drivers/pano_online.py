"""The online system of config 5 sharded over every rank, in a closed loop
(traffic kind `pano_online`).

Each rank makes the world, every frame's observations and odometry, and
the filter's draws (`motion_noise`, `resample_u0`) on its card from the
seed, the same on every rank (`worlds/pano_field.py`), and builds
`SLAMSystem(capture=True)`, which takes the particle axis of a mesh of all
ranks when the configuration's `dist` fits the world (`dist/
sharded_filter.py`: 1024 particles, 256 a rank on four cards). Set-up
captures the keyframe flush's programs at the shapes the window will meet
(closure verification at each batch of `verify_batches`, the keyframe
store's closure match at each capacity from 64 to the supply's keyframes,
the pose-graph solve at each view of up to the supply's keyframes), then
runs `warmup_frames` frames through `process_obs` (the frame graph's eager
first frame and its capture, NCCL's first connections, and the map's
fill). The window hands every rank its next frame as soon as its call
returns; every `sync_every` frames rank 0 tells all ranks whether the
window has closed (a one-element broadcast read on the host), so every
rank stops at the same frame, as `sharded_filter.py` does. The supply is
`max_rate_fps` over `--seconds` plus the warm-up: a window that reaches
its end closes there, correct, and notes it. `frames_per_s` is rank 0's
frames over its window.

Per frame on rank 0, the latency is the time from the frame's submission
to a CUDA event recorded after the call, as in `stereo_drive.py`;
`flush_frame_ms` is the median over the window's flush frames.

`--trace 1` profiles `trace_frames` frames on every rank at once from the
earlier of three quarters of `--seconds` and of the supply (never before
the checked stretch's search has ended; late, so that the map has
filled), with the program's tracer and the clock sampler on over the
window (`harness/spans.py`); rank 0's `dist.ring_bytes` and
`dist.gather_bytes` over the traced frames, its valid lanes a particle
and its matched share go into the counters, and so do its pose-graph
solves' time over the whole window (`flush.optimize`) and the window's
length.

Correct, on rank 0:
  - the first warm-up frame, from the reference's initial state, and its
    flush (the first keyframe);
  - the checked stretch (`_Stretch`): two flush windows of four frames
    from a window start drawn from the seed among the window's first
    frames on, the first window's flush making a keyframe and the
    second's accepting a closure for it (the search goes on window by
    window for `stretch_search_frames` frames). Every rank's state is
    gathered before each window, and the program's keyframe backend
    recorded; the reference works each window's frames out again on the
    whole state (`reference/filter.py`: the state, the estimate, the
    keyframe flag and the snapshot, which the program took from the rank
    that owns the best particle), then its flush from the backend as it
    stood before (`reference/flush.py`: the closures' match,
    verification and acceptance, the pose-graph solve and its correction
    of the state, the new keyframes' poses and snapshots). Compared: the
    state, estimate, flag and snapshot after each window's flush frame,
    and the flush's keyframes, closures, edges and solved poses, against
    the workload's `limits` (the poses a solve corrected apart, as
    `corrected_pose_gap`: `_compared`);
  - at the window's end, every rank holds the same keyframe frames,
    closures and last estimate (`ranks_disagree`: the ranks whose digest
    differs from rank 0's);
  - the world's landmarks observed up to the stretch's end are distinct,
    so that each takes a lane of its own (`world_duplicate_share`: the
    share of them whose descriptor lies within `DESC_MATCH_BITS` of
    another's);
each against the workload's `end_limits`. Printed beside them, not held:
the best particle's valid lanes as world landmarks (a lane's landmark is
the observed one whose descriptor lies nearest its own, within
`DESC_MATCH_BITS`), the distinct ones and the lanes whose landmark another
lane holds: the filter's own associations, which the reference makes
alike; and the world's landmarks observed over the warm-up and the
window."""

from __future__ import annotations

import gc
import hashlib
import math
import os
import random
import statistics
import time
from types import SimpleNamespace

from slambench.harness import spans, spec
from slambench.harness.trace import Stretch
from slambench.reference import filter as fref
from slambench.reference import flush as fflush
from slambench.worlds.pano_field import PanoField

# the window's helpers the other drivers have: the state's gather across the
# ranks (`sharded_filter`), a frame's completion event, the flush's warm-up
# and the count of captured programs (`stereo_drive`)
_sharded = spec.load_module(os.path.join(spec.HERE, "drivers", "sharded_filter.py"),
                            "slambench_driver_sharded_filter")
_stereo = spec.load_module(os.path.join(spec.HERE, "drivers", "stereo_drive.py"),
                           "slambench_driver_stereo_drive")
_gather, _event = _sharded._gather, _stereo._event
_program_keys = _stereo._program_keys

# a lane's descriptor is its latest observation's: desc_flips bits from its
# landmark's; a random descriptor lies ~128 of 256 bits from any other
DESC_MATCH_BITS = 32


def _pow2_from(lo: int, hi: int) -> list:
    out, c = [], lo
    while c <= hi:
        out.append(c)
        c *= 2
    return out


def _flush_shapes(p, cfg, n_frames):
    """The verify batches, store capacities and solve views the window may
    meet, as `stereo_drive`'s traffic lists them (`flush_shapes`):
    the store from 64 rows to the capacity of the supply's keyframes (one
    every keyframe_translation), the pose-graph views of those keyframes
    with an edge capacity of one to four times the node capacity (an
    odometry edge a keyframe, and the closures to the keyframes before)."""
    be = cfg.backend
    max_kf = min(int(math.ceil(n_frames * float(p["step_m"]) / be.keyframe_translation)) + 8,
                 be.max_keyframes)
    caps = _pow2_from(64, max(64, 1 << (max_kf - 1).bit_length()))
    views = []
    for kc in _pow2_from(32, min(max(32, 1 << (max_kf - 1).bit_length()), be.max_keyframes)):
        for ec in _pow2_from(kc, min(4 * kc, 4 * be.max_keyframes)):
            views.append((kc, ec))
    return {"verify_batches": list(p["verify_batches"]), "store_capacities": caps,
            "solve_views": views}


def _digest(sys_, est) -> int:
    """The ranks' agreement key: keyframe frames, closures and the last
    estimate, hashed to 63 bits."""
    import numpy as np

    h = hashlib.sha256()
    h.update(np.array([k.frame for k in sys_.keyframes], np.int64).tobytes())
    h.update(np.array(sys_.loop_closures, np.int64).reshape(-1).tobytes())
    h.update(est.detach().cpu().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def _backend(sys_) -> fflush.Backend:
    """The program's keyframe backend now: its keyframes' poses, snapshots
    and frames, its pose graph, its closures and its keyframe reference."""
    kfs, g = sys_.keyframes, sys_.graph
    return fflush.Backend(
        poses=[k.pose.copy() for k in kfs], points=[k.points_kf for k in kfs],
        desc=[k.desc for k in kfs], valid=[k.valid for k in kfs], frames=[k.frame for k in kfs],
        graph={f: getattr(g, f).clone() for f in fflush.fgraph._FIELDS}, n_nodes=g.n_nodes,
        n_edges=g.n_edges, closures=list(sys_.loop_closures),
        last_kf=sys_._last_kf_dev.clone())


def _program_counters():
    """The program tracer's counters now ({} on a program without them)."""
    return spans._tracer().counters()


def run(run):
    import torch
    import torch.distributed as tdist

    import parakeet_slam_tpu_torch  # noqa: F401
    from parakeet_slam_tpu_torch.core.state import Observation
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost
    from parakeet_slam_tpu_torch.system import SLAMSystem

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
    n_frames = warm + int(math.ceil(float(p["max_rate_fps"]) * run.seconds)) + every
    t_phase = time.perf_counter()
    field = PanoField(p, run.seed, dev, n_frames, Z, W, cfg.frontend.image_size, fc.max_range,
                      chunk=int(p.get("chunk_frames", 1024)))
    odom = field.odom.cpu().numpy()
    g = torch.Generator(device=dev).manual_seed(run.seed ^ 0x5EED)
    sys_ = SLAMSystem(cfg, device=str(dev), capture=True)
    noise = torch.randn(n_frames, P, sys_.slam.noise_dim, generator=g, device=dev)
    u0 = torch.rand(n_frames, generator=g, device=dev) / P
    if cuda:
        torch.cuda.synchronize()
    run.note(f"pano_online set-up: {n_frames} frames ({field.path_m:.1f} m) of a "
             f"{field.points.shape[0]}-landmark world made in "
             f"{time.perf_counter() - t_phase:.2f} s; sharded "
             f"{sys_._sharded is not None} over {world} ranks")
    if cuda:
        # before the first frame: the keyframe store is still empty, so the
        # warm-up may zero the match steps' stores
        t_phase = time.perf_counter()
        shapes = _flush_shapes(p, cfg, n_frames)
        _stereo._warm_flush_shapes(sys_, {"flush_shapes": shapes}, run)
        run.note(f"pano_online set-up: the flush's shapes {time.perf_counter() - t_phase:.2f} s: "
                 f"verify {shapes['verify_batches']}, closure match "
                 f"{shapes['store_capacities']}, pose-graph solve "
                 f"{len(shapes['solve_views'])} views up to {shapes['solve_views'][-1]}")
    sig = torch.zeros(Z, 0, device=dev)

    # what a frame hands to `_post_step`, for the checked frames
    seen = {}
    post_step = sys_._post_step

    def keep(*out):
        seen["out"] = out
        return post_step(*out)

    sys_._post_step = keep

    def obs_of(i):
        return Observation(z=field.z[i], sig=sig, desc=field.desc[i], valid=field.valid[i])

    def frame(i):
        return sys_.process_obs(obs_of(i), odom[i], motion_noise=noise[i], resample_u0=u0[i])

    def outputs():
        est, flag, snap, _ = seen["out"]
        return est.clone(), flag.clone(), [t.clone() for t in snap]

    ref = fref.Frame(run.cell.config["run"], dev) if rank == 0 else None
    start_kf = (sys_._last_kf_dev.clone(), sys_._has_kf_dev.clone())
    be_start = _backend(sys_)
    t_phase = time.perf_counter()
    frame(0)
    start = (_gather(sys_.state, world), outputs(), be_start, _backend(sys_))
    if rank != 0:
        start = None
    for i in range(1, warm):
        frame(i)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    run.note(f"pano_online set-up: {warm} warm-up frames {time.perf_counter() - t_phase:.2f} s, "
             f"{len(sys_.keyframes)} keyframes, {len(sys_.loop_closures)} closures, valid "
             f"lanes a particle {float(seen['out'][3].num_landmarks):.1f}")
    keys_before = _program_keys(sys_)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    if world > 1:
        tdist.barrier()
    if rank == 0:
        run.setup_done()

    rng = random.Random(run.seed)
    lo, hi = p["checked_window_frames"]
    lag = sys_.kf_flag_lag
    # the checked stretch: two flush windows from a window start drawn from
    # the seed on, the first window's flush making a keyframe and the
    # second's accepting a closure (`_Stretch`)
    stretch = _Stretch(lag, -(-rng.randrange(warm + lo, warm + hi) // lag) * lag,
                       int(p["stretch_search_frames"]), world, rank, outputs)
    lat_sub, events, ests = [], [], []
    ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
    i_trace = warm + 3 * (n_frames - warm) // 4
    w = spans.window_begin(run)
    sync()
    if cuda:
        ev0.record()
    t0 = time.perf_counter()
    i = warm
    trace_pending = False
    stretch_at = None
    while True:
        if i + every > n_frames:
            run.note(f"pano_online: the window ended on its frame supply after {i - warm} "
                     f"frames, {time.perf_counter() - t0:.3f} s")
            break
        if trace_pending:
            n_tr = int(p["trace_frames"])
            stretch_at = i
            lanes, matched = [float(seen["out"][3].num_landmarks)], []
            c0 = _program_counters()
            with Stretch() as st:
                for _ in range(n_tr):
                    lat_sub.append(time.perf_counter() - t0)
                    ests.append(frame(i))
                    events.append(_event(cuda))
                    lanes.append(seen["out"][3].num_landmarks)
                    matched.append(seen["out"][3].match_frac)
                    i += 1
            c1 = _program_counters()
            run.stretch = st.summary
            run.counters.update(
                frames_traced=n_tr, lanes_mean=[float(x) for x in lanes[:-1]],
                match_frac=[float(x) for x in matched], local_particles=P // world,
                flush_frames_traced=sum(1 for k in range(stretch_at, i) if (k + 1) % lag == 0))
            for name in ("dist.ring_bytes", "dist.gather_bytes"):
                if name in c1:
                    run.counters[name] = (c1[name] - c0.get(name, 0)) / n_tr
            run.note(f"pano_online trace: valid lanes a particle {run.counters['lanes_mean']}, "
                     f"matched share {run.counters['match_frac']}")
            trace_pending = False
        for _ in range(every):
            stretch.before(i, sys_)
            lat_sub.append(time.perf_counter() - t0)
            ests.append(frame(i))
            events.append(_event(cuda))
            stretch.after(i, sys_)
            i += 1
        # rank 0 decides: 0 go on, 1 the window has closed, 2 trace next
        if rank == 0:
            el = time.perf_counter() - t0
            flag.fill_(1 if el >= run.seconds else
                       2 if (run.trace and run.stretch is None and stretch.over(i)
                             and i + int(p["trace_frames"]) + every <= n_frames
                             and (el >= 0.75 * run.seconds or i >= i_trace)) else 0)
        if world > 1:
            tdist.broadcast(flag, 0)
        f = int(flag.item())
        if f == 1:
            break
        trace_pending = f == 2
    sync()
    window = time.perf_counter() - t0
    if w is not None:
        sys_.flush_metrics()
    spans.window_end(run, w)
    if w is not None:
        opt = [s.end_ns - s.start_ns for s in spans._tracer().spans() if s.name == "flush.optimize"]
        run.counters["flush_optimize_ms"] = sum(opt) / 1e6
        run.note(f"pano_online: {len(opt)} pose-graph solves (`flush.optimize`) over the window, "
                 f"{sum(opt) / 1e6:.1f} ms in all")
    n = i - warm
    run.attempted = n
    done = ([ev0.elapsed_time(e) for e in events] if cuda
            else [(e - t0) * 1e3 for e in events])
    lat = [d - s * 1e3 for d, s in zip(done, lat_sub)]
    window = max(window, done[-1] / 1e3)
    run.counters["window_ms"] = window * 1e3
    flush = [lat[k] for k in range(n) if (warm + k + 1) % lag == 0]
    run.counters["flush_frame_ms"] = statistics.median(flush) if flush else None
    if rank == 0:
        run.e2e["frames_per_s"] = n / window
        q = statistics.quantiles(lat, n=20, method="inclusive") if len(lat) > 1 else lat * 19
        run.note(f"pano_online: {world} ranks, {n} frames in {window:.3f} s, latency median "
                 f"{statistics.median(lat):.2f} ms, p95 {q[18]:.2f} ms, max {max(lat):.2f} ms; "
                 f"flush frames {len(flush)}, median {run.counters['flush_frame_ms']} ms")
    if cuda:
        peak = torch.tensor([torch.cuda.max_memory_allocated()], dtype=torch.int64, device=dev)
        if world > 1:
            tdist.all_reduce(peak, op=tdist.ReduceOp.MAX)
        run.memory_peak_bytes = int(peak.item())
    if run.trace and run.stretch is not None:
        nccl = sum(e - s for name, s, e in run.stretch.kernels("nccl")) / 1e3
        run.counters["nccl_ms_per_frame"] = nccl / run.counters["frames_traced"]
        ring = run.stretch.kernels("SendRecv")
        run.counters["ring_kernel_ms_per_frame"] = (
            sum(e - s for _, s, e in ring) / 1e3 / run.counters["frames_traced"])
        mine = torch.tensor([run.stretch.busy_s, run.stretch.wall_s], dtype=torch.float64,
                            device=dev)
        if world > 1:
            tdist.all_reduce(mine)
        run.busy_s, run.window_s = float(mine[0]) / world, float(mine[1]) / world
    est_host = torch.stack(ests).cpu()
    run.failed = int((~torch.isfinite(est_host).all(dim=1)).sum())

    # every rank's keyframes, closures and last estimate
    key = torch.tensor([_digest(sys_, ests[-1])], dtype=torch.int64, device=dev)
    keys = [key.clone() for _ in range(world)]
    if world > 1:
        tdist.all_gather(keys, key)
    disagree = sum(int(k.item() != keys[0].item()) for k in keys)
    run.note(f"pano_online: landmarks observed over the warm-up and the window "
             f"{int(_observed(field, i - 1).numel())} of {field.points.shape[0]}")
    new_keys = {k: v - keys_before.get(k, 0) for k, v in _program_keys(sys_).items()
                if v != keys_before.get(k, 0)}
    run.note(f"pano_online: keyframes {len(sys_.keyframes)}, closures "
             f"{len(sys_.loop_closures)}, ranks whose keyframes, closures or last estimate "
             f"differ from rank 0's {disagree}, programs first used in the window "
             f"{new_keys or 'none'}")
    if new_keys:
        run.note("pano_online: a program was captured inside the window")

    # free the program's graphs (they hold NCCL's communicators: a group
    # destroyed under a live graph hangs) before the reference and the group
    del sys_, seen, post_step, keep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank == 0:
        fl = fflush.Flush(ref.cfg, dev)
        inputs = (field, obs_of, odom, noise, u0)
        got = [_check_start(ref, fl, start, start_kf, inputs, run)]
        rec = stretch.done
        if rec is None:
            run.errors.append(f"no flush window from frame {stretch.start} on made a keyframe "
                              f"within {stretch.search} frames")
        else:
            run.note(f"checked stretch: frames {rec['k0']}..{rec['n'] + lag}, a keyframe made "
                     f"at flush frame {rec['n']}, closures accepted at flush frame "
                     f"{rec['n'] + lag}: {len(rec['be'][2].closures) - len(rec['be'][1].closures)}")
            got += _check_stretch(ref, fl, rec, lag, inputs, run)
        run.hold([a for a, _ in got], [c for _, c in got])
        upto = rec["n"] + lag if rec else 0
        _note_lanes(rec["state"][2] if rec else start[0], field, upto, run)
        ends = run.cell.workload["end_limits"]
        from slambench.harness.cli import Check

        run.checks.append(Check("ranks_disagree", float(disagree), ends["ranks_disagree"]))
        run.checks.append(Check("world_duplicate_share", _world_duplicate_share(field, upto),
                                ends["world_duplicate_share"]))
    if world > 1:
        tdist.barrier()
        tdist.destroy_process_group()


def _popcount(x):
    """Set bits of each int64 entry holding 32 bits."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _hamming_min(a, b, skip_self: bool = False):
    """For each row of a [n, W], the least bit distance to a row of b [m,
    W] and its index (int32 words; rows of b against themselves with
    `skip_self`, a = b)."""
    import torch

    a = a.to(torch.int64) & 0xFFFFFFFF
    b = b.to(torch.int64) & 0xFFFFFFFF
    dist = torch.empty(a.shape[0], dtype=torch.int64, device=a.device)
    idx = torch.empty_like(dist)
    for c0 in range(0, a.shape[0], 256):
        d = _popcount(a[c0:c0 + 256, None, :] ^ b[None]).sum(-1)           # [c, m]
        if skip_self:
            r = torch.arange(c0, c0 + d.shape[0], device=a.device)
            d[torch.arange(d.shape[0], device=a.device), r] = 1 << 20
        dist[c0:c0 + 256], idx[c0:c0 + 256] = torch.min(d, dim=1)
    return dist, idx


def _observed(field, upto):
    """The world's landmarks observed in frames 0..upto."""
    import torch

    seen = field.landmark[:upto + 1]
    return torch.unique(seen[seen >= 0])


def _world_duplicate_share(field, upto) -> float:
    """The share of the world's landmarks observed in frames 0..upto whose
    descriptor lies within DESC_MATCH_BITS of another observed one's."""
    ids = _observed(field, upto)
    if ids.numel() < 2:
        return 0.0
    table = field.table[ids]
    dist, _ = _hamming_min(table, table, skip_self=True)
    return float((dist <= DESC_MATCH_BITS).sum()) / ids.numel()


def _note_lanes(state, field, upto, run) -> None:
    """Note the best particle's valid lanes after frame `upto` as world
    landmarks: each lane's landmark is the one observed in frames 0..upto
    whose descriptor lies nearest its own, within DESC_MATCH_BITS."""
    import torch

    best = int(torch.argmax(state["log_w"]))
    valid = state["lm_valid"][best]
    ids = _observed(field, upto)
    dist, j = _hamming_min(state["lm_desc"][best][valid], field.table[ids])
    known = ids[j][dist <= DESC_MATCH_BITS]
    n_valid = int(valid.sum())
    distinct = int(torch.unique(known).numel())
    run.counters.update(lanes_best=n_valid, lanes_best_distinct=distinct)
    run.note(f"pano_online: the best particle after frame {upto} holds {n_valid} valid lanes: "
             f"{distinct} distinct world landmarks, {int(known.numel()) - distinct} lanes a "
             f"landmark another lane holds, {n_valid - int(known.numel())} unidentified, of "
             f"{int(ids.numel())} landmarks observed so far")


class _Stretch:
    """The checked stretch, recorded while the window runs: two flush
    windows of `lag` frames from a window start at or after `start`. Before
    the first window's first frame, after its flush and after the second
    window's flush: the whole state (gathered from every rank), the keyframe
    backend and the keyframe reference; after each frame, the program's
    estimate, flag and snapshot. A first window whose flush makes no keyframe is dropped and the
    search goes on from the next window; so is a stretch whose second flush
    accepts no closure, which is kept (the first such) only until one that
    does comes, up to `search` frames past `start`. Every rank gathers at the same frames (the
    keyframe and closure counts agree over the ranks); rank 0 keeps."""

    def __init__(self, lag, start, search, world, rank, outputs):
        self.lag, self.start, self.search = lag, start, search
        self.world, self.rank, self.outputs = world, rank, outputs
        self.cur = None      # the stretch being recorded
        self.done = None     # the stretch kept
        self.closed = False  # the search has ended

    def over(self, i) -> bool:
        return self.closed or i >= self.start + self.search

    def _take(self, sys_, c):
        st = _gather(sys_.state, self.world)
        if self.rank == 0:
            c["state"].append(st)
            c["be"].append(_backend(sys_))
            c["kf"].append((sys_._last_kf_dev.clone(), sys_._has_kf_dev.clone()))

    def before(self, i, sys_) -> None:
        if self.closed or self.cur is not None:
            return
        if i >= self.start + self.search:
            self.closed = True
        elif i >= self.start and i % self.lag == 0:
            self.cur = {"k0": i, "state": [], "be": [], "kf": [], "frames": [],
                        "kfs": len(sys_.keyframes)}
            self._take(sys_, self.cur)

    def after(self, i, sys_) -> None:
        c = self.cur
        if c is None:
            return
        if self.rank == 0:
            c["frames"].append(self.outputs())
        if (i + 1) % self.lag:
            return
        if "n" not in c:
            if len(sys_.keyframes) == c["kfs"]:
                self.cur = None
                return
            c["n"], c["closures"] = i, len(sys_.loop_closures)
            self._take(sys_, c)
            return
        self._take(sys_, c)
        self.cur = None
        self.closed = len(sys_.loop_closures) > c["closures"]
        if self.closed or self.done is None:
            self.done = c


def _frame_inputs(k, inputs, ref):
    import torch

    field, obs_of, odom, noise, u0 = inputs
    o = obs_of(k)
    return (ref.observation(o.z, o.desc, o.valid), torch.as_tensor(odom[k], device=ref.device),
            noise[k], u0[k])


def _window(ref, fl, state, kf, be, frames, inputs, ctl):
    """The reference (the control with `ctl`) over the frames of one flush
    window from `state` (the program's state before the first, or the
    reference's initial state) with the keyframe reference kf = (last_kf,
    has_kf), then the flush after the last frame on the program's backend
    `be` as it stood before the window. Returns ((state, est, flag,
    snapshot) of the last frame, after the flush; the backend after it)."""
    import torch

    last_kf, has_kf = kf
    st = state
    pending = []
    for k in frames:
        obs, u, nz, u_0 = _frame_inputs(k, inputs, ref)
        st, est, flag, snap = ref.step(st, u, obs, nz, u_0, last_kf, has_kf, bf16_state=ctl)
        pending.append((k + 1, est, flag, snap))
        last_kf = torch.where(flag, est, last_kf)
    st, be_ref = fl(be, pending, st, last_kf, frames[-1] + 1)
    return (st, est, flag, snap), be_ref, [p[1:] for p in pending]


def _frame_numbers(outs, ref_outs) -> dict:
    """The estimate's gap, the flag's difference and the snapshot's share
    of mismatched rows (as `reference/filter.compare` reads them), the
    largest over a window's frames: outs and ref_outs [(est, flag,
    snapshot)] a frame."""
    est_gap = flag_differs = snap_bad = 0.0
    for (est, flag, snap), (r_est, r_flag, r_snap) in zip(outs, ref_outs):
        est_gap = max(est_gap, float(fref._pose_gap(est, r_est)))
        flag_differs = max(flag_differs, float(bool(flag) != bool(r_flag)))
        bad = fref._lane_mismatch(snap[2], snap[0], snap[1], r_snap[2], r_snap[0], r_snap[1], 1e-3)
        snap_bad = max(snap_bad, float(bad.float().mean()))
    return {"est_gap": est_gap, "flag_differs": flag_differs, "snapshot_mismatch_share": snap_bad}


def _compared(run, what, post, outs, be_after, be_before, ctl, ref, solved=False):
    """The numbers of one checked flush window: the filter's
    (`reference/filter.compare` after the flush frame, and each frame's
    estimate, flag and snapshot) and the flush's (`reference/flush.compare`)
    of the program (post, outs, be_after) or, with `ctl`, the control
    (`_window`'s result) against the reference's `ref`. Where the
    reference's flush `solved` the pose graph and corrected the state, the
    particles' and the new keyframes' pose gaps after it are
    `corrected_pose_gap` (the two sides' solves part by their closures'
    rotations), and `pose_gap_max` and `kf_pose_gap` read the filter's
    steps alone elsewhere."""
    (r, r_be, r_outs) = ref
    if ctl is None:
        est, flag, snap = outs[-1]
        nums = fref.compare(SimpleNamespace(**post), est, flag, snap, r)
    else:
        (a, be_after, outs) = ctl
        nums = fref.compare(a[0], a[1], a[2], a[3], r)
    per = _frame_numbers(outs, r_outs)
    nums.update({k: max(nums[k], v) for k, v in per.items()})
    nums.update(fflush.compare(be_after, r_be, be_before))
    nums["corrected_pose_gap"] = 0.0
    if solved:
        nums["corrected_pose_gap"] = max(nums["pose_gap_max"], nums["kf_pose_gap"])
        nums["pose_gap_max"] = nums["kf_pose_gap"] = 0.0
    run.note(f"{what}: " + " ".join(f"{k}={v!r}" for k, v in nums.items()))
    return nums


def _check_start(ref, fl, start, start_kf, inputs, run):
    """The first warm-up frame from the reference's initial state, and its
    flush (the first keyframe)."""
    post, out, be0, be1 = start
    t0 = time.perf_counter()
    r = _window(ref, fl, ref.init_state(), start_kf, be0, [0], inputs, False)
    run.note(f"frame 0: the reference took {time.perf_counter() - t0:.2f} s")
    nums = _compared(run, "frame 0: program against the reference", post, [out], be1, be0,
                     None, r)
    cn = None
    if run.with_control:
        c = _window(ref, fl, ref.init_state(), start_kf, be0, [0], inputs, True)
        cn = _compared(run, "frame 0: control (the reference, its state in bfloat16) "
                       "against the reference", None, None, None, be0, c, r)
    return nums, cn


def _check_stretch(ref, fl, rec, lag, inputs, run):
    """The stretch's two flush windows, each from the program's state,
    backend and keyframe reference before it."""
    got = []
    k0 = rec["k0"]
    for w in range(2):
        frames = list(range(k0 + w * lag, k0 + (w + 1) * lag))
        pre = SimpleNamespace(**{f: v.clone() for f, v in rec["state"][w].items()})
        t0 = time.perf_counter()
        n_solves = len(fl.moves)
        r = _window(ref, fl, pre, rec["kf"][w], rec["be"][w], frames, inputs, False)
        what = f"frames {frames[0]}..{frames[-1]} and the flush"
        solved = len(fl.moves) > n_solves
        said = (f"; its solve moved a keyframe pose by up to {fl.moves[-1][0]!r}, its "
                f"correction {fl.moves[-1][1]!r} m" if solved else "; no solve")
        run.note(f"{what}: the reference took {time.perf_counter() - t0:.2f} s{said}")
        nums = _compared(run, f"{what}: program against the reference", rec["state"][w + 1],
                         rec["frames"][w * lag:(w + 1) * lag], rec["be"][w + 1], rec["be"][w],
                         None, r, solved)
        cn = None
        if run.with_control:
            pre = SimpleNamespace(**{f: v.clone() for f, v in rec["state"][w].items()})
            c = _window(ref, fl, pre, rec["kf"][w], rec["be"][w], frames, inputs, True)
            cn = _compared(run, f"{what}: control (the reference, its state in bfloat16) "
                           "against the reference", None, None, None, rec["be"][w], c, r,
                           solved)
        got.append((nums, cn))
    return got
