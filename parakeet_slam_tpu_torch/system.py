"""Online visual SLAM: frontend -> particle filter -> keyframe backend
(port of `parakeet_slam_tpu.system`).

Per frame (`process_frame`, or `process_stereo_frame` for a stereo pair):
  1. detect + describe on the grayscale (left) image (frontend; on an image
     pyramid when `frontend.pyramid_levels > 1`),
  2. assemble a fixed-capacity Observation (pixel measurement + packed
     BRIEF descriptor per keypoint; for a stereo pair [u, v, d] with the
     SAD disparity against the right image, `frontend/stereo.py`),
  3. one FastSLAM step (motion or proposal + fused measurement update),
  4. the keyframe-motion test against a device-side reference, and the
     flagged frame's own best-particle map snapshot;
every `kf_flag_lag` frames the host reads the window's flags once,
materializes the flagged keyframes (pose-graph node + odometry edge) and
dispatches each keyframe's loop-closure match against the whole stacked
keyframe store: one batched `kernels.match.hamming_top2` launch forward and
one in reverse. The match tables are read one window later, mutually
cross-checked, verified by a batched Horn consensus and a reprojection
refine, and accepted closures become pose-graph edges; the pose graph is
then optimized and its correction applied to every particle.

The state lives on one device (`device=`). The kernel wrappers pick the
route by the tensors' device alone: CUDA tensors launch the hand-written
kernels, CPU tensors run their twins. On the card the reference's compiled
programs run as captured CUDA graphs (`filter/captured.py`), all on one
graph pool:
  - a frame, one graph: steps 1-4 for `process_frame` and
    `process_stereo_frame` (the reference's `_fused_frame_impl` and
    `_fused_stereo_impl`: the images and the odometry arrive in one copy
    from a pinned host slot, the draws are written into the graph's inputs),
    steps 3-4 for `process_obs` (`_fused_obs_impl`); one step per entry and
    image shape, all over the same state buffers;
  - closure verification, one graph per batch shape [Nc, F]: Horn's three
    consensus rounds (their rotation fits in `kernels/horn.py`'s kernel)
    and the reprojection refine, the reference's jitted
    `_verify_candidates`;
  - the pose-graph solve, one graph per view shape
    (`backend/posegraph.CapturedSolver`);
  - the closure match of a keyframe dispatch, one graph per store shape:
    the store is that step's static input (`_store_buffers`), so a doubling
    or a rebuild writes into what the graph reads; the query and the count
    of eligible keyframes are written in before each replay;
  - offline, the point dedup, one graph per (F, W, cap) replayed once per
    keyframe (`_dedup_step`, the reference's scan body), and bundle
    adjustment, one graph of the LM iteration per problem shape
    (`backend/ba.CapturedBA`).
`self.state` and the keyframe reference are the frames' static buffers,
written in place by everything that replaces them (the pose-graph
correction, `load_checkpoint`), and what a frame keeps past itself is
copied out in one copy (`CapturedStep.take`). `capture=False` asks for the
eager twin; `capture=True` on the CPU runs the captured path's buffer rules
eagerly. The sharded system captures the same programs: its frame graph
holds the sharded step's all-gathers, all-reduces and ring transfers
(NCCL on the card; gloo on the CPU, where `capture=True` runs the buffer
rules eagerly), and `run_ba(distributed=True)` replays the distributed BA's
graph an LM iteration. Random draws come from a
`torch.Generator` seeded by
`cfg.filter.seed`, or are injected per frame (`motion_noise`,
`resample_u0`) so that a test can replay the reference's draws. Keyframe descriptors are int32 words carrying the reference's
uint32 bits.

Sharded (benchmark config 5): when a `torch.distributed` process group is up
and its world size equals `dist.particle_axis * dist.map_axis`, the filter
runs on a (dcn, ici) mesh of the ranks (`dist/sharded_filter.py`): each
rank holds its P / particle_axis particles and draws the global noise of
the one shared generator, so a sharded run equals the one-device run bit
for bit. The reads across particles are collectives: the estimate gathers
the poses and weights, the keyframe snapshot takes the best particle's
lanes from the rank that holds it, a checkpoint gathers the state to rank 0,
which alone writes files. The keyframe backend is replicated: every rank
runs the same host logic on the same data. Otherwise the system runs on
one device, as the reference does when its mesh does not fit.

Offline, `run_ba` refines the keyframe poses and a deduplicated point table
by bundle adjustment (`backend/ba.py`): `build_ba_problem` merges the
keyframes' landmark snapshots by descriptor (`_assign_point_ids`, one
`hamming_top2` launch per keyframe against the growing point store), each
keyframe's own measured local points are the observations, and the pose
graph's edges are fused into the solve when `backend.ba_fuse_pose_graph` is
set.

`run_ba(distributed=True)` (or None with `dist.map_axis > 1` on a mesh
that fits) solves it with the points sharded over the mesh's `dcn` ranks
(`dist/dist_ba.py`).

`save_checkpoint` / `load_checkpoint` snapshot and restore the whole run
(filter state, pose graph, generator, keyframes, the un-flushed flag window
and the dispatched closure matches) in the reference's two files, so that a
resumed run equals an uninterrupted one bit for bit; `checkpoint_every`
snapshots automatically every that many keyframes. A snapshot holds the
global state, so it resumes under any world size.
"""

from __future__ import annotations

import sys as _sys
from dataclasses import dataclass, field

import numpy as np
import torch

from parakeet_slam_tpu_torch.backend import ba as ba_mod
from parakeet_slam_tpu_torch.backend import graph as graph_mod
from parakeet_slam_tpu_torch.backend import posegraph as pg_mod
from parakeet_slam_tpu_torch.core import geometry
from parakeet_slam_tpu_torch.core.config import SLAMConfig
from parakeet_slam_tpu_torch.core.state import Observation
from parakeet_slam_tpu_torch.dist import dist_ba
from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.multihost import process_index
from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
from parakeet_slam_tpu_torch.filter import captured, make_filter
from parakeet_slam_tpu_torch.filter.runner import draw_noise
from parakeet_slam_tpu_torch.frontend import camera as camera_mod
from parakeet_slam_tpu_torch.frontend.describe import describe, make_pattern
from parakeet_slam_tpu_torch.frontend.detect import detect, top_k_stable
from parakeet_slam_tpu_torch.frontend.pyramid import detect_pyramid
from parakeet_slam_tpu_torch.frontend.stereo import keypoint_disparity
from parakeet_slam_tpu_torch.kernels import match as match_mod
from parakeet_slam_tpu_torch.utils import checkpoint as ckpt
from parakeet_slam_tpu_torch.utils.metrics_log import MetricsLogger

# hamming_top2 launches per closure dispatch: the forward and the reverse
# table are one batched launch each.
MATCH_LAUNCHES_PER_DISPATCH = 2
# pinned host slots an image entry's frames are copied from, in turn
STAGING_SLOTS = 8


def _batched_kf_match(qd, qv, db, dbv, ratio: float):
    """Forward + reverse Lowe-ratio matches of one query descriptor set
    against a stacked keyframe store.

    qd [F, W] int32, qv [F] bool, db [K, F, W], dbv [K, F]. Returns (fwd
    [K, F], rev [K, F]) int32 match indices (-1 = none), per keyframe equal
    to matching each keyframe on its own: forward shares the queries across
    the batch, reverse shares the database."""
    fwd, _ = match_mod.match(qd, qv, db, dbv, ratio=ratio)
    rev, _ = match_mod.match(db, dbv, qd, qv, ratio=ratio)
    return fwd, rev


def _kf_match_step(ratio: float):
    """One closure dispatch's match as a step function (the program the
    reference jits): fn(state, x) -> (state, (fwd, rev)) with x = {"qd"
    [F, W], "qv" [F], "db" [cap, F, W], "dbv" [cap, F], "n_old" 0-d int64}:
    `_batched_kf_match` of the query against the store's first n_old
    keyframes, the eligibility mask made on the device from the count."""

    def step(state, x):
        db = x["db"]
        eligible = torch.arange(db.shape[0], device=db.device) < x["n_old"]
        return state, _batched_kf_match(x["qd"], x["qv"], db, x["dbv"] & eligible[:, None],
                                        ratio)

    return step


def _dedup_step(cap: int, max_ham: int):
    """One keyframe of the point dedup, the body of the reference's
    `lax.scan`: fn(state, x) -> (new state, pid [F]) with state =
    (store_desc [cap + 1, W], store_valid [cap + 1], store_pos [cap + 1, 3],
    count, dropped) and x = {"desc" [F, W], "valid" [F], "world" [F, 3]} of
    the keyframe. The keyframe's rows match the store built from the
    keyframes before it (one `hamming_top2` call), and its unmatched valid
    rows take new slots in row order; the spare row at `cap` takes the
    writes of the rows a full store drops. The store is written in place."""

    def step(state, x):
        sd, sv, sp, cnt, drop = state
        valid = x["valid"]
        bi, b1, _ = match_mod.hamming_top2(x["desc"], sd[:cap], sv[:cap])
        matched = valid & (b1 < max_ham)
        is_new = valid & ~matched
        slot = cnt + torch.cumsum(is_new.to(torch.int32), dim=0, dtype=torch.int32) - 1
        ok_new = is_new & (slot < cap)
        pid = torch.where(matched, bi, torch.where(ok_new, slot, torch.full_like(slot, -1)))
        widx = torch.where(ok_new, slot, torch.full_like(slot, cap)).long()
        sd[widx] = x["desc"]
        # index_fill_: `sv[widx] = True` would copy the True from the host
        sv.index_fill_(0, widx, True)
        sp[widx] = x["world"]
        n_new = torch.sum(is_new.to(torch.int32), dtype=torch.int32)
        return (sd, sv, sp, torch.clamp(cnt + n_new, max=cap),
                drop + torch.sum((is_new & ~ok_new).to(torch.int32), dtype=torch.int32)), pid

    return step


def _assign_point_ids(desc, valid, world, *, cap: int, max_ham: int, steps: dict | None = None,
                      pool=None):
    """Deduplicate keyframe landmark snapshots into a global point table.

    Walks the keyframes in order through `_dedup_step`: each keyframe's F
    descriptors match against the point store built so far (one
    `hamming_top2` call), and its unmatched valid rows get new store slots.

    desc [K, F, W] int32 words, valid [K, F] bool, world [K, F, 3]
    first-seen world positions, all on one device. Returns ((store_desc
    [cap, W], store_valid [cap], store_pos [cap, 3], count, dropped), pid
    [K, F] int32): pid is the point id per observation (-1 = invalid row, or
    dropped because the store is full); count and dropped are 0-d tensors.

    With `steps`, a dict, each keyframe runs through the `CapturedStep` of
    (F, W, cap, max_ham) kept there (on the card a CUDA graph, captured at
    the second keyframe of its first walk; on the CPU its buffer rules
    eagerly), drawing on `pool`; without, the loop runs eagerly.

    A keyframe's rows match only against the store built from earlier
    keyframes (the store update commits after the whole keyframe's match),
    so duplicate descriptors within one keyframe are not merged: two
    same-looking detections in one frame are distinct points (the
    detector's NMS separates them), and cross-keyframe matching is what
    establishes identity."""
    K, F, W = desc.shape
    dev = desc.device
    world = world.to(torch.float32)
    fn = _dedup_step(cap, max_ham)
    # one spare row past the capacity takes the writes of full-store rows
    store = (torch.zeros(cap + 1, W, dtype=torch.int32, device=dev),
             torch.zeros(cap + 1, dtype=torch.bool, device=dev),
             torch.zeros(cap + 1, 3, dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    pids = []
    if steps is None:
        for k in range(K):
            store, pid = fn(store, {"desc": desc[k], "valid": valid[k], "world": world[k]})
            pids.append(pid)
    else:
        key = (F, W, cap, max_ham)
        if key not in steps:
            steps[key] = captured.CapturedStep(
                fn, store, {"desc": torch.zeros(F, W, dtype=torch.int32, device=dev),
                            "valid": torch.zeros(F, dtype=torch.bool, device=dev),
                            "world": torch.zeros(F, 3, device=dev)},
                graph=dev.type == "cuda", pool=pool)
        cs = steps[key]
        captured.copy_into(cs.state, store)
        for k in range(K):
            captured.copy_into(cs.inputs, {"desc": desc[k], "valid": valid[k], "world": world[k]})
            cs()
            pids.append(cs.take())
        store = captured.clone(cs.state)
    sd, sv, sp, cnt, drop = store
    return (sd[:cap], sv[:cap], sp[:cap], cnt, drop), torch.stack(pids)


def _global_descriptor(desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Bit-frequency signature of a packed-descriptor set: the fraction of
    valid descriptors with each of the W*32 bits set, centred at 0.5 and
    L2-normalized."""
    F, W = desc.shape
    if valid.sum() == 0:
        return np.zeros((W * 32,), np.float32)
    bits = np.unpackbits(desc[valid].view(np.uint8), bitorder="little").reshape(-1, W * 32)
    f = bits.mean(axis=0).astype(np.float32) - 0.5
    n = float(np.linalg.norm(f))
    return f / n if n > 1e-9 else f


@dataclass
class Keyframe:
    index: int
    pose: np.ndarray          # [7] current best pose (updated by the optimizer)
    points_kf: np.ndarray     # [F, 3] landmark positions in the keyframe frame
    desc: np.ndarray          # [F, W] packed descriptors (int32 words)
    valid: np.ndarray         # [F]
    frame: int = 0            # source frame index (loop-closure recency gate)
    # Emission-frame anchor segments: (start_frame, pose [7]). Online
    # estimates emitted at frame >= start_frame (until the next entry) are
    # relative to that emission pose; corrected_trajectory() maps row t as
    # pose . anchor(t)^-1 . est_t.
    anchors: list = field(default_factory=list)
    # place-recognition signature (_global_descriptor)
    gdesc: np.ndarray | None = None

    @property
    def anchor(self) -> np.ndarray:
        """Latest emission anchor (the current filter-estimate frame)."""
        return self.anchors[-1][1]


# rows of the stacked keyframe store before its first doubling
KF_STORE_ROWS = 64


def _store_capacity(n: int) -> int:
    """Rows of the stacked keyframe store holding n keyframes:
    KF_STORE_ROWS, doubled as needed."""
    cap = KF_STORE_ROWS
    while cap < n:
        cap *= 2
    return cap


def _identity_pose(device) -> torch.Tensor:
    p = torch.zeros(7, device=device)
    p[6] = 1.0
    return p


def _huber(n, valid, delta):
    """(cost, IRLS weights) of residual norms n [..., R] under a Huber
    kernel of width delta, masked by valid."""
    w = torch.where(valid, torch.clamp(delta / torch.clamp(n, min=1e-6), max=1.0),
                    torch.zeros_like(n))
    c = torch.where(n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta))
    return torch.sum(c * valid, dim=-1), w


class SLAMSystem:
    """The online system, on one device or sharded over the ranks of a
    process group (see the module docstring). `cfg` is a `SLAMConfig`."""

    def __init__(self, cfg: SLAMConfig, device="cuda", capture: bool | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        fe = cfg.frontend
        be = cfg.backend
        self.slam = make_filter(cfg.filter, fe)
        self.mesh, self._sharded = self._make_mesh(cfg.dist)
        # the compiled programs as CUDA graphs (None: on the card, on one
        # device or on a mesh)
        self.capture = self.device.type == "cuda" if capture is None else bool(capture)
        # The CapturedSteps, built at first use: the frames by entry ("obs",
        # or "mono" / "stereo" with the image and odometry shapes), closure
        # verification by batch shape; the pose-graph solver; their pool;
        self._frame_steps: dict = {}
        self._verify_steps: dict = {}
        self._pg_solver = None
        # the offline refinement's: the closure match by store shape (whose
        # static inputs hold the keyframe store), the dedup scan step by
        # (F, W, cap, max_ham), the bundle adjustment (`ba.CapturedBA`)
        self._match_steps: dict = {}
        self._dedup_steps: dict = {}
        self._ba_solver = None
        self._pool = None
        # an image step's u0 input: a drawn uniform (divided in the graph) or
        # an injected offset, by step key (what the device flag holds)
        self._u0_drawn: dict = {}
        # pinned host slots by size, and the uploads since the host last
        # read the device (`_upload`)
        self._staging: dict = {}
        self._uploads = 0
        self._uploads_unread = 0
        # rank 0 alone prints and writes files
        self.is_writer = process_index() == 0
        self.camera = camera_mod.from_config(fe)
        self.wrap_x = fe.camera == "equirect"
        # BRIEF's pattern on the device once: a copy from the host inside a
        # captured frame would be recorded with the capture's host buffer
        self._pattern = torch.as_tensor(make_pattern(), device=self.device)
        self.keyframes: list[Keyframe] = []
        self.graph = graph_mod.make_pose_graph(be.max_keyframes, 4 * be.max_keyframes,
                                               device=self.device)
        if self._sharded is not None:
            self.state = self._sharded.init_state(device=self.device)
        else:
            self.state = self.slam.init_state(device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.filter.seed)
        self.frame_idx = 0
        self.metrics = MetricsLogger((cfg.metrics_path if self.is_writer else "") or None)
        self.loop_closures: list[tuple[int, int]] = []
        # the latest keyframe's pose when it was made (kept by snapshots)
        self.last_kf_pose: np.ndarray | None = None
        # Device-side keyframe-motion reference: a flagged frame's estimate
        # becomes the reference for the next frame's test inside the step,
        # so the keyframe cadence is a function of the frame sequence alone.
        self._last_kf_dev = _identity_pose(self.device)
        self._has_kf = False
        self._has_kf_dev = torch.zeros((), dtype=torch.bool, device=self.device)
        self._metrics_pending: list[tuple] = []
        # Keyframe flags are read in windows of kf_flag_lag frames, at
        # absolute frame-index boundaries (every frame until the first
        # keyframe exists); each flagged frame carries its own snapshot.
        self.kf_flag_lag = 4
        self._flag_pending: list[tuple] = []
        # Device-resident stacked keyframe descriptor store [capK, F, W] /
        # [capK, F], grown by doubling.
        self._kf_desc_dev: torch.Tensor | None = None
        self._kf_valid_dev: torch.Tensor | None = None
        # Dispatched-but-unresolved closure matches (kf_index, n_old,
        # fwd [K, F], rev [K, F] device tensors), drained at the next flush.
        self._closure_pending: list[tuple] = []

    def _make_mesh(self, d):
        """(mesh, ShardedFastSLAM) when a process group is up whose world
        size is dist.particle_axis * dist.map_axis, else (None, None): one
        device. Says which on stderr (rank 0) when the config asks for a
        mesh or a group is up."""
        n_mesh = d.particle_axis * d.map_axis
        world = torch.distributed.get_world_size() if mesh_mod.is_distributed() else 1
        sharded = mesh_mod.is_distributed() and world == n_mesh
        if n_mesh > 1 or mesh_mod.is_distributed():
            what = (f"particle axis sharded over {d.particle_axis} of {world} ranks "
                    f"(dcn={d.map_axis}, ici={d.particle_axis})" if sharded else
                    f"one device (dist {d.map_axis} x {d.particle_axis} does not fit a world "
                    f"of {world})")
            if process_index() == 0:
                print(f"SLAMSystem: {what}", file=_sys.stderr)
        if not sharded:
            return None, None
        mesh = mesh_mod.make_mesh(map_axis=d.map_axis)
        return mesh, ShardedFastSLAM(self.slam, mesh)

    # -- frontend ---------------------------------------------------------

    def _frontend(self, img: torch.Tensor):
        fe = self.cfg.frontend
        kw = dict(max_features=fe.max_features, detector=fe.detector,
                  threshold=fe.fast_threshold, nms_radius=fe.nms_radius, wrap_x=self.wrap_x)
        if fe.pyramid_levels > 1:
            xy, _, _, valid = detect_pyramid(img, levels=fe.pyramid_levels, **kw)
        else:
            xy, _, valid = detect(img, **kw)
        return xy, describe(img, xy, valid, pattern=self._pattern, wrap_x=self.wrap_x), valid

    def _mono_observation(self, img):
        """Steps 1-2 of a camera frame [H, W] on the device."""
        return self._to_observation(*self._frontend(img))

    def _stereo_observation(self, left, right):
        """Steps 1-2 of a rectified stereo pair: detect and describe on the
        left image, the SAD disparity of the first Z = max_observations
        keypoints against the right one, [u, v, d] valid where the keypoint
        and its disparity are."""
        xy, desc, valid = self._frontend(left)
        Z = self.cfg.filter.max_observations
        xy, desc, valid = xy[:Z], desc[:Z], valid[:Z]
        disp, dvalid = keypoint_disparity(left, right, xy, valid)
        uvd = torch.cat([xy, disp[:, None]], dim=1)
        return self._to_observation(uvd, desc, valid & dvalid)

    def _to_observation(self, z, desc, valid) -> Observation:
        """Keypoint measurements -> fixed-capacity filter Observation."""
        Z = self.cfg.filter.max_observations
        z, desc, valid = z[:Z], desc[:Z], valid[:Z]
        pad = Z - z.shape[0]
        if pad > 0:
            z = torch.nn.functional.pad(z, (0, 0, 0, pad))
            desc = torch.nn.functional.pad(desc, (0, 0, 0, pad))
            valid = torch.nn.functional.pad(valid, (0, pad))
        return Observation(z=z, sig=torch.zeros(Z, 0, device=z.device), desc=desc, valid=valid)

    # -- keyframe / loop closure -----------------------------------------

    def _best_particle_lanes(self, state):
        """(lm_mean, lm_valid, lm_desc, lm_count) of the highest-weight
        particle (from the rank that holds it when sharded)."""
        if self._sharded is not None:
            return self._sharded.best_particle_lanes(state)
        best = torch.argmax(state.log_w).reshape(1)
        # index_select: indexing with a 0-dim tensor reads it on the host
        return tuple(t.index_select(0, best)[0] for t in (state.lm_mean, state.lm_valid,
                                                          state.lm_desc, state.lm_count))

    def _kf_snapshot_impl(self, state, est_pose):
        """Best-particle map snapshot in the keyframe frame: F lanes ranked
        valid in-FOV first (most-observed first), then valid out-of-view,
        with non-finite or far-away lanes excluded. The ranking keeps the
        reference's tie order (lower lane first)."""
        means, valid, desc, count = self._best_particle_lanes(state)
        F = min(self.cfg.frontend.max_features, means.shape[0])
        in_fov = self.slam.model.in_fov(est_pose, means)
        dist = torch.linalg.vector_norm(means - est_pose[:3], dim=-1)
        sane = torch.isfinite(dist) & (dist < 8.0 * self.cfg.filter.max_range)
        score = torch.where(
            valid & sane,
            torch.where(in_fov, 1e6, 0.0) + count.to(torch.float32),
            torch.full_like(dist, -1.0),
        )
        _, sel = top_k_stable(score, F)
        pts_kf = geometry.se3_apply_inverse(est_pose, means[sel])
        return pts_kf, desc[sel], valid[sel] & sane[sel]

    def _make_keyframe(self, est_pose, snap=None, frame=None, anchor_pose=None):
        """Materialize a keyframe from a map snapshot (the flagged frame's
        in-step snapshot when given, else the current state's). `anchor_pose`,
        when given, is the raw emission-frame estimate (it differs from
        est_pose only when a correction was applied earlier in the same
        flush window)."""
        est_pose = torch.as_tensor(est_pose, dtype=torch.float32, device=self.device)
        if snap is None:
            snap = self._kf_snapshot_impl(self.state, est_pose)
        pose_np, pts_np, desc_np, valid_np = (t.cpu().numpy() for t in (est_pose, *snap))
        fr = self.frame_idx if frame is None else frame
        anchor_np = (pose_np.copy() if anchor_pose is None
                     else torch.as_tensor(anchor_pose).cpu().numpy().astype(np.float32))
        kf = Keyframe(
            index=len(self.keyframes), pose=pose_np, points_kf=pts_np, desc=desc_np,
            valid=valid_np, frame=fr, anchors=[(fr, anchor_np)],
            gdesc=_global_descriptor(desc_np, valid_np),
        )
        self.keyframes.append(kf)
        self._kf_store_append(kf)
        self.graph = graph_mod.add_node(self.graph, est_pose)
        if kf.index > 0:
            prev = self.keyframes[kf.index - 1]
            rel = geometry.se3_between(torch.as_tensor(prev.pose, device=self.device), est_pose)
            # Odometry-edge information from the odometry noise accumulated
            # over the edge's frame span plus an estimate-jitter floor.
            df = max(kf.frame - prev.frame, 1)
            it0, ir0 = self.cfg.backend.odom_edge_info
            st, sr = self.cfg.data.odom_noise
            it = 1.0 / (df * float(st) ** 2 + 1.0 / it0)
            ir = 1.0 / (df * float(sr) ** 2 + 1.0 / ir0)
            self.graph = graph_mod.add_edge(self.graph, kf.index - 1, kf.index, rel,
                                            info=[it, it, it, ir, ir, ir])
        return kf

    def _store_buffers(self, cap: int, F: int, W: int):
        """Zeroed keyframe-store tensors ([cap, F, W] descriptors, [cap, F]
        validity). Captured, they are the static inputs of that store
        shape's match step, so that its graph reads the store the system
        writes, after a doubling or a rebuild as before it."""
        if not self.capture:
            return (torch.zeros(cap, F, W, dtype=torch.int32, device=self.device),
                    torch.zeros(cap, F, dtype=torch.bool, device=self.device))
        cs = self._match_steps.get((cap, F, W))
        if cs is None:
            z = lambda *shape, dtype: torch.zeros(shape, dtype=dtype, device=self.device)  # noqa: E731
            cs = self._match_steps[(cap, F, W)] = captured.CapturedStep(
                _kf_match_step(self.cfg.frontend.match_ratio), (),
                {"qd": z(F, W, dtype=torch.int32), "qv": z(F, dtype=torch.bool),
                 "db": z(cap, F, W, dtype=torch.int32), "dbv": z(cap, F, dtype=torch.bool),
                 "n_old": z(dtype=torch.int64)},
                graph=self.device.type == "cuda", pool=self._graph_pool())
        else:
            cs.inputs["db"].zero_()
            cs.inputs["dbv"].zero_()
        return cs.inputs["db"], cs.inputs["dbv"]

    def _kf_store_append(self, kf: Keyframe):
        """Write a keyframe's descriptors into the stacked device store,
        doubling its capacity as needed (`_store_capacity`)."""
        F, W = kf.desc.shape
        cap = 0 if self._kf_desc_dev is None else self._kf_desc_dev.shape[0]
        if kf.index + 1 > cap:
            desc, val = self._store_buffers(_store_capacity(kf.index + 1), F, W)
            if cap:
                desc[:cap] = self._kf_desc_dev
                val[:cap] = self._kf_valid_dev
            self._kf_desc_dev, self._kf_valid_dev = desc, val
        self._kf_desc_dev[kf.index] = torch.as_tensor(kf.desc.view(np.int32), device=self.device)
        self._kf_valid_dev[kf.index] = torch.as_tensor(kf.valid, device=self.device)

    def _rebuild_kf_store(self):
        """Upload the whole keyframe list into a fresh store at once."""
        self._kf_desc_dev = self._kf_valid_dev = None
        if not self.keyframes:
            return
        cap = _store_capacity(len(self.keyframes))
        F, W = self.keyframes[0].desc.shape
        desc = np.zeros((cap, F, W), np.int32)
        val = np.zeros((cap, F), bool)
        for kf in self.keyframes:
            desc[kf.index] = kf.desc.view(np.int32)
            val[kf.index] = kf.valid
        self._kf_desc_dev, self._kf_valid_dev = self._store_buffers(cap, F, W)
        self._kf_desc_dev.copy_(torch.from_numpy(desc))
        self._kf_valid_dev.copy_(torch.from_numpy(val))

    def _try_loop_closure(self, kf: Keyframe, min_matches: int = 12):
        """Dispatch this keyframe's closure match and resolve it at once.
        Returns True when an accepted closure wants an inline optimize."""
        self._dispatch_loop_closure(kf)
        return self._resolve_closures(min_matches)

    def _dispatch_loop_closure(self, kf: Keyframe):
        """Launch the batched match of this keyframe against every eligible
        older keyframe without reading the result: the [K, F] tables stay
        on the device until the next flush drains them. Captured, the query
        and the count go into the static inputs of the store shape's step
        and its graph replays; the tables are copied out."""
        gap = self.cfg.backend.loop_min_frame_gap
        n_old = sum(1 for k in self.keyframes[: kf.index] if k.frame <= kf.frame - gap)
        if n_old == 0:
            return
        x = {"qd": torch.as_tensor(kf.desc.view(np.int32), device=self.device),
             "qv": torch.as_tensor(kf.valid, device=self.device),
             "db": self._kf_desc_dev, "dbv": self._kf_valid_dev,
             "n_old": torch.full((), n_old, dtype=torch.int64, device=self.device)}
        if not self.capture:
            _, (fwd, rev) = _kf_match_step(self.cfg.frontend.match_ratio)((), x)
        else:
            cs = self._match_steps[tuple(self._kf_desc_dev.shape)]
            captured.copy_into(cs.inputs, x)
            cs()
            fwd, rev = cs.take()
        self._closure_pending.append((kf.index, n_old, fwd, rev))

    def _resolve_closures(self, min_matches: int = 12) -> bool:
        """Drain the dispatched closure matches (one device-to-host copy),
        cross-check the correspondences, verify the candidates in one
        batched Horn consensus + refine, and add the accepted edges.
        Returns True when an accepted closure passes the innovation gate."""
        pend, self._closure_pending = self._closure_pending, []
        if not pend:
            return False
        tables = [t for _, _, f, r in pend for t in (f, r)]
        host = torch.cat([t.flatten() for t in tables]).cpu().numpy()
        ends = np.cumsum([t.numel() for t in tables])
        host = [h.reshape(t.shape) for h, t in zip(np.split(host, ends[:-1]), tables)]
        fetched = list(zip(host[0::2], host[1::2]))
        # -- phase 1 (host): candidate selection + correspondence tables --
        cand_rows = []  # (kf_index, old_index, pa, pb, valid)
        for (kidx, n_old, _, _), (fwd, rev) in zip(pend, fetched):
            kf = self.keyframes[kidx]
            F = fwd.shape[1]
            rows = np.arange(F)[None, :]
            mutual = (fwd >= 0) & (np.take_along_axis(rev, np.clip(fwd, 0, F - 1), axis=1) == rows)
            counts = mutual.sum(axis=1)
            counts[n_old:] = 0
            # up to 2 distinct closure targets per keyframe
            cands = [(int(k), min_matches) for k in np.argsort(counts)[::-1][:2]]
            # global place-recognition tier: high-similarity places at a
            # relaxed mutual-count threshold (verification stays strict)
            if kf.gdesc is not None:
                sims = np.asarray([
                    float(kf.gdesc @ self.keyframes[i].gdesc)
                    if self.keyframes[i].gdesc is not None else -1.0
                    for i in range(n_old)
                ])
                seen = {c[0] for c in cands}
                for i in np.argsort(sims)[::-1][:2]:
                    i = int(i)
                    if sims[i] > 0.5 and i not in seen and counts[i] >= max(6, min_matches // 2):
                        cands.append((i, max(6, min_matches // 2)))
            for k_best, thr in cands:
                if counts[k_best] < thr:
                    continue
                old = self.keyframes[k_best]
                pa = np.zeros((F, 3), np.float32)
                pb = np.zeros((F, 3), np.float32)
                sel = np.where(mutual[k_best])[0]
                pa[: len(sel)] = kf.points_kf[sel]                # kf frame
                pb[: len(sel)] = old.points_kf[fwd[k_best, sel]]  # old frame
                cand_rows.append((kidx, k_best, pa, pb, np.arange(F) < len(sel)))
        if not cand_rows:
            return False
        # -- phase 2 (device, one batch): Horn consensus + reprojection
        # refine of every candidate; T: p_old ~ T(p_kf) => Z_{old,kf}.
        Nc = 1
        while Nc < len(cand_rows):
            Nc *= 2
        F = cand_rows[0][2].shape[0]
        pa_b = np.zeros((Nc, F, 3), np.float32)
        pb_b = np.zeros((Nc, F, 3), np.float32)
        v_b = np.zeros((Nc, F), bool)
        for i, (_, _, pa, pb, v) in enumerate(cand_rows):
            pa_b[i], pb_b[i], v_b[i] = pa, pb, v
        rels, n_ins = self._verify_batch(pa_b, pb_b, v_b)
        # -- phase 3 (host): accept edges, innovation-gate the optimize --
        need_opt = False
        for (kidx, oldidx, _, _, _), rel, n_in in zip(cand_rows, rels, n_ins):
            if int(n_in) < max(min_matches, 4):
                continue
            kf = self.keyframes[kidx]
            old = self.keyframes[oldidx]
            it, ir = self.cfg.backend.loop_edge_info
            self.graph = graph_mod.add_edge(self.graph, old.index, kf.index, rel,
                                            info=[it, it, it, ir, ir, ir])
            self.loop_closures.append((old.index, kf.index))
            # Innovation gate: the edge is kept either way; the inline
            # optimize + correct runs only when it disagrees with the graph.
            gate = self.cfg.backend.loop_min_innovation
            if gate > 0.0:
                pred = geometry.se3_between(torch.as_tensor(old.pose), torch.as_tensor(kf.pose))
                xi = geometry.se3_log(geometry.se3_between(rel, pred)).numpy()
                if float(np.linalg.norm(xi[:3]) + 3.0 * np.linalg.norm(xi[3:])) < gate:
                    continue
            need_opt = True
        return need_opt

    def _refine(self):
        return (self._refine_rel_depth_impl if self.cfg.backend.loop_refine_depth_sigma > 0.0
                else self._refine_rel_impl)

    def _verify_candidates(self, pa, pb, valid):
        """Batched closure verification [Nc, F, ...]: Horn consensus, then the
        reprojection refine. Returns (rel [Nc, 7], inliers [Nc])."""
        rel, n_in = self._horn_consensus_impl(pa, pb, valid)
        return self._refine()(rel, pa, pb, valid), n_in

    def _verify_batch(self, pa, pb, valid):
        """`_verify_candidates` of host arrays pa, pb [Nc, F, 3], valid [Nc,
        F]; the results come back in one device-to-host copy: (rel [Nc, 7]
        and inliers [Nc] on the host). Captured, the arrays go into the
        static inputs of the batch shape's step and the whole verification
        replays."""
        Nc = pa.shape[0]
        if not self.capture:
            rels, n_in = self._verify_candidates(
                *(torch.as_tensor(a, device=self.device) for a in (pa, pb, valid)))
        else:
            cs = self._verify_steps.get(pa.shape)
            if cs is None:
                inputs = {"pa": torch.zeros(pa.shape, device=self.device),
                          "pb": torch.zeros(pb.shape, device=self.device),
                          "valid": torch.zeros(valid.shape, dtype=torch.bool, device=self.device)}
                cs = self._verify_steps[pa.shape] = captured.CapturedStep(
                    lambda state, x: (state, self._verify_candidates(x["pa"], x["pb"],
                                                                     x["valid"])),
                    (), inputs, graph=self.device.type == "cuda", pool=self._graph_pool())
            x = cs.inputs
            for k, a in (("pa", pa), ("pb", pb), ("valid", valid)):
                x[k].copy_(torch.from_numpy(a))
            cs()
            rels, n_in = cs.take()
        host = torch.cat([rels.reshape(-1), n_in.to(rels.dtype)]).cpu()
        return host[:Nc * 7].reshape(Nc, 7), host[Nc * 7:].numpy().astype(np.int32)

    def _refine_rel_impl(self, rel0, pa, pb, valid):
        """Reprojection-refine closure edges rel0 [..., 7] (Z_{old,kf}: maps
        kf-frame points pa [..., F, 3] into the old keyframe's frame, where
        their matches are pb): 8 Gauss-Newton steps on the SE(3) tangent of
        rel minimizing the symmetric pixel reprojection error under a 3 px
        Huber kernel, each step kept only where it lowers the cost; falls
        back to rel0 where the refined cost is not better. Batched over the
        leading dims; the Jacobian is `torch.func.jacfwd` of the residuals
        with respect to one perturbation shared by every batch entry (each
        entry's residuals depend on its own rel only)."""
        cam = self.camera
        delta = 3.0
        vm = torch.cat([valid, valid], dim=-1)
        uv_a, uv_b = cam.project(pa), cam.project(pb)

        def residual(rel):
            pao = geometry.se3_apply(rel[..., None, :], pa)
            pbk = geometry.se3_apply_inverse(rel[..., None, :], pb)
            return torch.cat([cam.project(pao) - uv_b, cam.project(pbk) - uv_a], dim=-2)

        def cost_w(rel):
            return _huber(torch.linalg.vector_norm(residual(rel), dim=-1), vm, delta)

        def perturbed(xi, rel):  # see backend/posegraph.py on the leading axis
            return geometry.se3_compose(rel, geometry.se3_exp(xi[None])[0])

        eye = torch.eye(6, device=pa.device)
        zero = torch.zeros(6, device=pa.device)
        rel = rel0
        for _ in range(8):
            r0 = residual(rel)                                   # [..., 2F, Dz]
            _, w = cost_w(rel)
            J = torch.func.jacfwd(lambda x: residual(perturbed(x, rel)))(zero)
            J = J.flatten(-3, -2)                                # [..., 2F*Dz, 6]
            wf = w.repeat_interleave(r0.shape[-1], dim=-1)
            A = J.transpose(-1, -2) @ (wf[..., None] * J) + 1e-4 * eye
            b = (J.transpose(-1, -2) @ (wf * r0.flatten(-2))[..., None])[..., 0]
            # solve_ex: linalg.solve's error check reads the device
            xi = -torch.linalg.solve_ex(A, b, check_errors=False)[0]
            xi = torch.where(torch.isfinite(xi), xi, torch.zeros_like(xi))
            cand = geometry.se3_compose(rel, geometry.se3_exp(xi))
            c_old, _ = cost_w(rel)
            c_new, _ = cost_w(cand)
            rel = torch.where((torch.isfinite(c_new) & (c_new < c_old))[..., None], cand, rel)
        c0, _ = cost_w(rel0)
        c1, _ = cost_w(rel)
        return torch.where((torch.isfinite(c1) & (c1 <= c0))[..., None], rel, rel0)

    def _refine_rel_depth_impl(self, rel0, pa, pb, valid):
        """Depth-relaxed closure refinement (backend.loop_refine_depth_sigma
        > 0): like `_refine_rel_impl`, with the kf-side point depths free
        under a relative Gaussian prior (sigma = that fraction of the Horn
        depth). Depths are 1x1 Schur blocks, so each of the 10 Gauss-Newton
        steps is one 6x6 solve per batch entry."""
        cam = self.camera
        delta = 3.0
        eps = 1e-6
        rs = float(self.cfg.backend.loop_refine_depth_sigma)
        d0 = torch.linalg.vector_norm(pa, dim=-1)
        ray = pa / torch.clamp(d0, min=eps)[..., None]
        uv_b, uv_a = cam.project(pb), cam.project(pa)
        vm = valid & (d0 > eps)
        wp = 1.0 / torch.clamp((rs * d0) ** 2, min=eps)          # prior information

        def res12(rel, d):
            pao = geometry.se3_apply(rel[..., None, :], d[..., None] * ray)
            pbk = geometry.se3_apply_inverse(rel[..., None, :], pb)
            return cam.project(pao) - uv_b, cam.project(pbk) - uv_a

        def hw(r):
            return _huber(torch.linalg.vector_norm(r, dim=-1), vm, delta)

        def cost(rel, d):
            r1, r2 = res12(rel, d)
            prior = torch.sum(torch.where(vm, wp * (d - d0) ** 2, torch.zeros_like(d)), dim=-1)
            return hw(r1)[0] + hw(r2)[0] + 0.5 * prior

        def perturbed(xi, rel):  # see backend/posegraph.py on the leading axis
            return geometry.se3_compose(rel, geometry.se3_exp(xi[None])[0])

        eye = torch.eye(6, device=pa.device)
        zero = torch.zeros(6, device=pa.device)
        rel, d = rel0, d0
        for _ in range(10):
            r1, r2 = res12(rel, d)
            _, w1 = hw(r1)
            _, w2 = hw(r2)
            A1, A2 = torch.func.jacfwd(lambda x: res12(perturbed(x, rel), d))(zero)  # [.., F, Dz, 6]
            # r1 of point f depends on d_f alone: the diagonal of dr1/dd is
            # one forward-mode product with a tangent of ones
            _, (B1, _) = torch.func.jvp(lambda dd: res12(rel, dd), (d,), (torch.ones_like(d),))
            wA1 = A1 * w1[..., None, None]
            wA2 = A2 * w2[..., None, None]
            Hxx = (torch.einsum("...fdi,...fdj->...ij", A1, wA1)
                   + torch.einsum("...fdi,...fdj->...ij", A2, wA2))
            Hdd = torch.sum(B1 * B1 * w1[..., None], dim=-1) + wp + 1e-8
            Hxd = torch.einsum("...fdi,...fd->...fi", wA1, B1)
            gx = (torch.einsum("...fdi,...fd->...i", wA1, r1)
                  + torch.einsum("...fdi,...fd->...i", wA2, r2))
            gd = torch.sum(B1 * r1 * w1[..., None], dim=-1) + wp * (d - d0)
            S = (Hxx - torch.einsum("...fi,...fj->...ij", Hxd / Hdd[..., None], Hxd)
                 + 1e-4 * eye)
            rhs = gx - torch.sum(Hxd * (gd / Hdd)[..., None], dim=-2)
            dxi = -torch.linalg.solve_ex(S, rhs, check_errors=False)[0]
            dxi = torch.where(torch.isfinite(dxi), dxi, torch.zeros_like(dxi))
            dd = -(gd + (Hxd @ dxi[..., None])[..., 0]) / Hdd
            dd = torch.where(torch.isfinite(dd) & vm, dd, torch.zeros_like(dd))
            cand_rel = geometry.se3_compose(rel, geometry.se3_exp(dxi))
            cand_d = torch.clamp(d + dd, 0.05, 1e4)
            c_new = cost(cand_rel, cand_d)
            good = torch.isfinite(c_new) & (c_new < cost(rel, d))
            rel = torch.where(good[..., None], cand_rel, rel)
            d = torch.where(good[..., None], cand_d, d)
        c1 = cost(rel, d)
        better = torch.isfinite(c1) & (c1 <= cost(rel0, d0))
        return torch.where(better[..., None], rel, rel0)

    def _horn_consensus_impl(self, pa, pb, valid):
        """Three rounds of Horn 3D-3D fit + inlier re-selection, batched over
        the leading dims. The re-selection is ANDed with the padding mask
        (zero rows would otherwise fit inside the radius). Returns (rel,
        number of inliers of the last round)."""
        radius = self.cfg.backend.loop_inlier_radius
        cur, rel = valid, None
        for _ in range(3):
            rel = graph_mod.estimate_relative_pose_3d3d(pb, pa, cur)
            fit = geometry.se3_apply(rel[..., None, :], pa)
            cur = (torch.linalg.vector_norm(fit - pb, dim=-1) < radius) & valid
        return rel, torch.sum(cur.to(torch.int32), dim=-1)

    def _optimize_graph(self):
        """Optimize the pose graph at its live size (a power-of-two view)."""
        view, _, _ = graph_mod.shrink_to_active(self.graph)
        if not self.capture:
            view, _ = pg_mod.optimize_pose_graph(view, iters=self.cfg.backend.gn_iters)
        else:
            if self._pg_solver is None:
                self._pg_solver = pg_mod.CapturedSolver(
                    iters=self.cfg.backend.gn_iters, graph=self.device.type == "cuda",
                    pool=self._graph_pool())
            view, _ = self._pg_solver(view)
        poses = self.graph.poses.clone()
        poses[: view.poses.shape[0]] = view.poses
        return self.graph.replace(poses=poses)

    def _optimize_and_correct(self):
        """Optimize the pose graph and left-apply the resulting correction of
        the latest keyframe to the filter state. Returns the correction [7]
        (numpy) for the pending frames of the flush window."""
        self.graph = self._optimize_graph()
        k = len(self.keyframes) - 1
        opt_pose = self.graph.poses[k]
        est_pose = torch.as_tensor(self.keyframes[k].pose, device=self.device)
        corr = geometry.se3_compose(opt_pose, geometry.se3_inverse(est_pose))
        self._set_state(self.state.replace(
            pose=geometry.se3_compose(corr, self.state.pose),
            lm_mean=geometry.se3_apply(corr, self.state.lm_mean),
        ))
        # the keyframe-motion reference lives in the filter-estimate frame
        self._set_kf_ref(geometry.se3_compose(corr, self._last_kf_dev))
        poses_np = self.graph.poses[: len(self.keyframes)].cpu().numpy()
        corr_np = corr.cpu().numpy()
        for i, kf in enumerate(self.keyframes):
            kf.pose = poses_np[i]
        # Estimates emitted after this correction are relative to the
        # shifted filter frame: a new anchor segment on the latest keyframe
        # from the next frame on.
        last = self.keyframes[-1]
        shifted = geometry.se3_compose(torch.as_tensor(corr_np),
                                       torch.as_tensor(last.anchor)).numpy()
        start = self.frame_idx + 1
        if last.anchors[-1][0] >= start:
            last.anchors[-1] = (last.anchors[-1][0], shifted)
        else:
            last.anchors.append((start, shifted))
        return corr_np

    # -- per-frame step ---------------------------------------------------

    def _kf_test(self, est, last_kf, has_kf):
        """The keyframe flag (0-dim bool): moved past a threshold since the
        reference `last_kf`, or no keyframe yet (`has_kf`, 0-dim bool)."""
        xi = geometry.se3_log(geometry.se3_between(last_kf, est))
        be = self.cfg.backend
        moved = ((torch.linalg.vector_norm(xi[:3]) > be.keyframe_translation)
                 | (torch.linalg.vector_norm(xi[3:]) > be.keyframe_rotation))
        return moved | ~has_kf

    def _set_state(self, state):
        """Replace the filter state: written into the captured step's static
        buffers, or rebound on the eager path."""
        if self.capture:
            captured.copy_into(self.state, state)
        else:
            self.state = state

    def _set_kf_ref(self, pose):
        """Replace the device keyframe reference, as `_set_state`."""
        if self.capture:
            self._last_kf_dev.copy_(pose)
        else:
            self._last_kf_dev = pose

    def _set_has_kf(self, has_kf: bool):
        self._has_kf = has_kf
        self._has_kf_dev.fill_(has_kf)

    def _draws(self, motion_noise, resample_u0):
        """This frame's (noise [P, noise_dim], u0): injected, or drawn."""
        if motion_noise is None or resample_u0 is None:
            noise, u0 = draw_noise(1, self.slam.cfg.num_particles, self.slam.noise_dim,
                                   self.generator, self.device)
            motion_noise = noise[0] if motion_noise is None else motion_noise
            resample_u0 = u0[0] if resample_u0 is None else resample_u0
        return (torch.as_tensor(motion_noise, dtype=torch.float32, device=self.device),
                torch.as_tensor(resample_u0, dtype=torch.float32, device=self.device))

    def _frame(self, carry, x):
        """The frame from (state, keyframe reference) and the inputs x (u,
        obs, noise, u0, has_kf): filter step, estimate, keyframe flag with
        the reference latch, and the frame's own map snapshot. Returns
        ((state, reference), (est, flag, snap, metrics)): the function
        `CapturedStep` captures, on one device or with the sharded step's
        collectives inside, and the eager step."""
        state, last_kf = carry
        if self._sharded is not None:
            state, metrics = self._sharded.step(state, x["u"], x["obs"],
                                                self._sharded.local_draws(x["noise"]), x["u0"])
            est = self._sharded.estimate_pose(state)
        else:
            state, metrics = self.slam.step(state, x["u"], x["obs"], x["noise"], x["u0"])
            est = self.slam.estimate_pose(state)
        flag = self._kf_test(est, last_kf, x["has_kf"])
        snap = self._kf_snapshot_impl(state, est)
        return (state, torch.where(flag, est, last_kf)), (est, flag, snap, metrics)

    def _graph_pool(self):
        """The graph pool that every captured step of this system draws on
        (None off the card)."""
        if self._pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _frame_step(self, key, fn, inputs):
        """Build the CapturedStep of a frame entry over the system's state
        and keyframe reference (the same buffers for every entry), with the
        static inputs `inputs`."""
        self._frame_steps[key] = captured.CapturedStep(
            fn, (self.state, self._last_kf_dev), inputs, graph=self.device.type == "cuda",
            pool=self._graph_pool())

    def _step(self, obs, odom_u, motion_noise, resample_u0):
        """One frame of steps 3-4: eager (sharded or not), or the captured graph."""
        noise, u0 = self._draws(motion_noise, resample_u0)
        u = torch.as_tensor(np.asarray(odom_u, np.float32), device=self.device)
        x = {"u": u, "obs": obs, "noise": noise, "u0": u0, "has_kf": self._has_kf_dev}
        if not self.capture:
            (self.state, self._last_kf_dev), out = self._frame((self.state, self._last_kf_dev), x)
            return self._post_step(*out)
        if "obs" not in self._frame_steps:
            self._frame_step("obs", self._frame, {
                k: (v if k == "has_kf" else captured.clone(v)) for k, v in x.items()})
        cs = self._frame_steps["obs"]
        captured.copy_into(cs.inputs, x)
        cs()
        return self._post_step(*cs.take())

    def _image_frame(self, n_images: int, shape):
        """The captured function of an image entry: x["frame"] holds the
        n_images images [H, W] (left, right) and the odometry increment,
        flat (`_upload`); x["u0"] is the resample offset, or where
        x["u0_drawn"] the uniform it is drawn from, divided here by P as
        `draw_noise` divides it. Steps 1-2, then `_frame`."""
        H, W = shape
        n = H * W
        P = self.slam.cfg.num_particles

        def frame(carry, x):
            f = x["frame"]
            images = [f[i * n:(i + 1) * n].view(H, W) for i in range(n_images)]
            obs = (self._mono_observation(*images) if n_images == 1
                   else self._stereo_observation(*images))
            u0 = torch.where(x["u0_drawn"], x["u0"] / P, x["u0"])
            return self._frame(carry, {"u": f[n_images * n:], "obs": obs, "noise": x["noise"],
                                       "u0": u0, "has_kf": x["has_kf"]})

        return frame

    def _upload(self, dst, arrays):
        """Write a frame's host arrays, flat and in order, into the static
        input `dst`. On the card the copy leaves from a pinned slot and does
        not wait: the slots are used in turn, and a slot is written again
        only after the host has read the device since its last copy (the
        flag flush reads it every kf_flag_lag frames; past STAGING_SLOTS
        uploads without a read the host waits here)."""
        if dst.device.type != "cuda":
            dst.copy_(torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays])))
            return
        if self._uploads_unread >= STAGING_SLOTS:
            torch.cuda.current_stream(self.device).synchronize()
            self._uploads_unread = 0
        ring = self._staging.setdefault(dst.numel(), [None] * STAGING_SLOTS)
        i = self._uploads % STAGING_SLOTS
        if ring[i] is None:
            ring[i] = torch.empty(dst.numel(), dtype=torch.float32, pin_memory=True)
        host, off = ring[i].numpy(), 0
        for a in arrays:
            host[off:off + a.size] = a.reshape(-1)
            off += a.size
        dst.copy_(ring[i], non_blocking=True)
        self._uploads += 1
        self._uploads_unread += 1

    def _draw_into(self, key, x, motion_noise, resample_u0):
        """This frame's draws in an image step's inputs, as `_draws` makes
        them: drawn into the buffers (`normal_` as `randn` draws, `uniform_`
        as `rand`, the division by P in the graph), or injected."""
        if motion_noise is None or resample_u0 is None:
            x["noise"].normal_(generator=self.generator)
            x["u0"].uniform_(generator=self.generator)
        if motion_noise is not None:
            x["noise"].copy_(torch.as_tensor(motion_noise, dtype=torch.float32,
                                             device=self.device).reshape(x["noise"].shape))
        if resample_u0 is not None:
            x["u0"].copy_(torch.as_tensor(resample_u0, dtype=torch.float32,
                                          device=self.device).reshape(()))
        drawn = resample_u0 is None
        if self._u0_drawn.get(key) != drawn:
            x["u0_drawn"].fill_(drawn)
            self._u0_drawn[key] = drawn

    def _captured_frame(self, kind, images, odom_u, motion_noise, resample_u0):
        """One frame of an image entry through its captured step."""
        arrays = [np.asarray(a, np.float32) for a in images]
        u = np.asarray(odom_u, np.float32).reshape(-1)
        key = (kind, arrays[0].shape, u.size)
        if key not in self._frame_steps:
            dev = self.device
            self._frame_step(key, self._image_frame(len(arrays), arrays[0].shape), {
                "frame": torch.zeros(sum(a.size for a in arrays) + u.size, device=dev),
                "noise": torch.zeros(self.slam.cfg.num_particles, self.slam.noise_dim,
                                     device=dev),
                "u0": torch.zeros((), device=dev),
                "u0_drawn": torch.ones((), dtype=torch.bool, device=dev),
                "has_kf": self._has_kf_dev})
            self._u0_drawn[key] = True
        cs = self._frame_steps[key]
        self._upload(cs.inputs["frame"], arrays + [u])
        self._draw_into(key, cs.inputs, motion_noise, resample_u0)
        cs()
        return self._post_step(*cs.take())

    # -- main entry -------------------------------------------------------

    def process_frame(self, img, odom_u, motion_noise=None, resample_u0=None):
        """One camera frame [H, W] in [0, 1] + odometry increment [6].
        Returns the pose estimate [7] as a device tensor. `motion_noise`
        [P, noise_dim] and `resample_u0` replace this frame's draws."""
        if self.capture:
            return self._captured_frame("mono", (img,), odom_u, motion_noise, resample_u0)
        img = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        return self._step(self._mono_observation(img), odom_u, motion_noise, resample_u0)

    def process_obs(self, obs: Observation, odom_u, motion_noise=None, resample_u0=None):
        """Bypass the image frontend with a ready Observation."""
        return self._step(obs, odom_u, motion_noise, resample_u0)

    def process_stereo_frame(self, img_left, img_right, odom_u, motion_noise=None,
                             resample_u0=None):
        """One rectified stereo pair [H, W] in [0, 1] + odometry increment
        (KITTI, benchmark config 3): detect and describe on the left image,
        the SAD disparity of the first Z = max_observations keypoints against
        the right one, and [u, v, d] observations (valid where the keypoint
        and its disparity are) for the stereo_3d model. Returns the pose
        estimate [7] as a device tensor; the draws as in `process_frame`."""
        if self.cfg.filter.obs_dim != 3:
            raise ValueError("stereo frames need obs_dim=3 (stereo_3d model)")
        if self.capture:
            if np.shape(img_left) != np.shape(img_right):
                raise ValueError(f"stereo pair of {np.shape(img_left)} and {np.shape(img_right)}")
            return self._captured_frame("stereo", (img_left, img_right), odom_u, motion_noise,
                                        resample_u0)
        left, right = (torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                       for a in (img_left, img_right))
        return self._step(self._stereo_observation(left, right), odom_u, motion_noise,
                          resample_u0)

    def _post_step(self, est, kf_flag, snap, metrics):
        self.frame_idx += 1
        self._metrics_pending.append((
            self.frame_idx,
            (metrics.ess, metrics.num_landmarks, metrics.match_frac, metrics.resampled),
            len(self.keyframes),
        ))
        if len(self._metrics_pending) >= 256:
            self.flush_metrics()
        self._flag_pending.append((self.frame_idx, est, kf_flag, snap))
        # absolute-phase flushes: a function of the frame index alone
        if not self._has_kf or self.frame_idx % self.kf_flag_lag == 0:
            self.flush_flags()
        return est

    def flush_flags(self):
        """Read the pending keyframe flags (one device-to-host copy) and
        materialize a keyframe for every flagged frame from its own
        snapshot. The closure matches dispatched in the previous window are
        resolved first; a resulting correction is composed into this
        window's pending estimates."""
        pend, self._flag_pending = self._flag_pending, []
        flags = torch.stack([f for _, _, f, _ in pend]).tolist() if pend else []
        if pend:  # the read waited for every copy of `_upload` so far
            self._uploads_unread = 0
        pend_corr = None
        if self._resolve_closures():
            pend_corr = self._optimize_and_correct()
        if not any(flags):
            return
        for (fi, est, _, snap), f in zip(pend, flags):
            if not f:
                continue
            est_raw = est
            if pend_corr is not None:
                est = geometry.se3_compose(torch.as_tensor(pend_corr, device=est.device), est)
            kf = self._make_keyframe(est, snap, frame=fi, anchor_pose=est_raw)
            if pend_corr is not None:
                # rows already emitted are relative to the raw estimate; rows
                # after the flush live in the corrected frame
                kf.anchors.append((self.frame_idx + 1, est.cpu().numpy().astype(np.float32)))
            self.last_kf_pose = kf.pose
            self._set_has_kf(True)
            self._dispatch_loop_closure(kf)
        ce = self.cfg.checkpoint_every
        if ce > 0 and self.cfg.checkpoint_dir and len(self.keyframes) % ce == 0:
            self.save_checkpoint(f"{self.cfg.checkpoint_dir}/ckpt_{self.frame_idx:08d}")

    def flush_metrics(self):
        """Drain the device-side metrics buffer into the JSONL logger (one
        batched copy)."""
        pend, self._metrics_pending = self._metrics_pending, []
        if not pend:
            return
        vals = torch.stack([torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                                         device=self.device) for v in p[1]])
                            for p in pend]).cpu().numpy()
        for (fi, _, nkf), (ess, lms, mf, rs) in zip(pend, vals):
            self.metrics.log(fi, ess=float(ess), landmarks=float(lms), match_frac=float(mf),
                             resampled=bool(rs), keyframes=nkf)

    # -- checkpoint / resume ----------------------------------------------

    def _ckpt_tree(self):
        return {"state": self.state, "graph": self.graph, "key": self.generator.get_state()}

    def save_checkpoint(self, path_prefix: str):
        """Snapshot the run so that a fresh system resumes it bit for bit.

        `<path_prefix>.state.npz` holds the filter state, the pose graph and
        the generator under the reference's keys (`utils/checkpoint.py`); the
        `['key']` leaf is `generator.get_state()`, a uint8 array, where the
        reference keeps a threefry key. `<path_prefix>.kf.npz` holds, under
        the reference's keys: the frame counter, the latest keyframe's pose,
        the device keyframe reference and its latch, the closures, the
        keyframes with their anchor segments, the un-flushed flag window
        (`p_*`) and the dispatched but unresolved closure matches (`cp_*`,
        padded to the largest store with -1 rows, which never match).
        Descriptor words are stored as uint32. The flag window is persisted,
        not flushed: a flush here would make keyframes at this frame instead
        of at the next window boundary, and the resumed run would part from
        the uninterrupted one. Sharded, the state is gathered and rank 0
        writes the reference's global layout; every rank returns once the
        files are there."""
        self.flush_metrics()
        tree = self._ckpt_tree()
        if self._sharded is not None:
            tree["state"] = self._sharded.gather_state(self.state)
        if self.is_writer:
            self._write_checkpoint(path_prefix, tree)
        if self._sharded is not None:
            mesh_mod.barrier(self.mesh)

    def _write_checkpoint(self, path_prefix: str, tree):
        ckpt.save_checkpoint(path_prefix + ".state.npz", tree, step=self.frame_idx)
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        kfs = self.keyframes
        pend = [(fi, host(est), host(flag), [host(a) for a in snap])
                for fi, est, flag, snap in self._flag_pending]
        cp = [(kidx, n_old, host(f), host(r)) for kidx, n_old, f, r in self._closure_pending]
        if cp:
            kmax = max(f.shape[0] for _, _, f, _ in cp)

            def padk(a):
                return np.pad(a, ((0, kmax - a.shape[0]), (0, 0)), constant_values=-1)

            cp_fwd = np.stack([padk(c[2]) for c in cp])
            cp_rev = np.stack([padk(c[3]) for c in cp])
        else:
            cp_fwd = cp_rev = np.zeros((0, 0, 0), np.int32)
        F = self.cfg.frontend.max_features
        W = self.cfg.filter.desc_words
        words = lambda arrays, empty: (np.stack(arrays).view(np.uint32)  # noqa: E731
                                       if arrays else np.zeros(empty, np.uint32))
        np.savez(
            path_prefix + ".kf.npz",
            n=np.int32(len(kfs)),
            frame_idx=np.int32(self.frame_idx),
            last_kf_pose=(self.last_kf_pose if self.last_kf_pose is not None
                          else np.full((7,), np.nan, np.float32)),
            kf_ref=host(self._last_kf_dev).astype(np.float32),
            has_kf=np.bool_(self._has_kf),
            loop_closures=np.asarray(self.loop_closures, np.int32).reshape(-1, 2),
            pose=np.stack([k.pose for k in kfs]) if kfs else np.zeros((0, 7), np.float32),
            points=(np.stack([k.points_kf for k in kfs]) if kfs
                    else np.zeros((0, 0, 3), np.float32)),
            desc=words([k.desc for k in kfs], (0, 0, 1)),
            valid=np.stack([k.valid for k in kfs]) if kfs else np.zeros((0, 0), bool),
            kf_frame=np.asarray([k.frame for k in kfs], np.int32),
            anchor_kf=np.asarray([k.index for k in kfs for _ in k.anchors], np.int32),
            anchor_start=np.asarray([st for k in kfs for st, _ in k.anchors], np.int64),
            anchor_val=(np.stack([a for k in kfs for _, a in k.anchors]) if kfs
                        else np.zeros((0, 7), np.float32)),
            p_frame=np.asarray([p[0] for p in pend], np.int32),
            p_est=np.stack([p[1] for p in pend]) if pend else np.zeros((0, 7), np.float32),
            p_flag=np.asarray([p[2] for p in pend], bool),
            p_pts=np.stack([p[3][0] for p in pend]) if pend else np.zeros((0, F, 3), np.float32),
            p_desc=words([p[3][1] for p in pend], (0, F, max(W, 1))),
            p_valid=np.stack([p[3][2] for p in pend]) if pend else np.zeros((0, F), bool),
            cp_kidx=np.asarray([c[0] for c in cp], np.int32),
            cp_nold=np.asarray([c[1] for c in cp], np.int32),
            cp_fwd=cp_fwd, cp_rev=cp_rev,
        )

    def load_checkpoint(self, path_prefix: str):
        """Restore a `save_checkpoint` snapshot into this system, replacing
        any pending work of its own; the reference's older layouts (no
        `has_kf`, `anchor_kf`, `kf_frame` or `cp_kidx`) are read as the
        reference reads them. Raises ValueError when the state layout or the
        generator does not fit this system. Sharded, every rank reads the
        global state and keeps its own rows, so a snapshot resumes under any
        world size."""
        tmpl = self._ckpt_tree()
        if self._sharded is not None:
            tmpl["state"] = self._sharded.global_template(self.state)
        tree, _ = ckpt.load_checkpoint(path_prefix + ".state.npz", tmpl)
        self.graph = tree["graph"]
        if self._sharded is not None:
            self._set_state(self._sharded.shard_state(tree["state"], device=self.device))
        else:
            self._set_state(tree["state"])
        self.generator.set_state(tree["key"])
        T = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        data = np.load(path_prefix + ".kf.npz")
        self.frame_idx = int(data["frame_idx"])
        lkp = data["last_kf_pose"]
        self.last_kf_pose = None if np.isnan(lkp).any() else lkp
        self._metrics_pending = []
        if "has_kf" in data:
            self._set_has_kf(bool(data["has_kf"]))
            self._set_kf_ref(T(data["kf_ref"]))
        else:  # the reference's round-3 layout
            self._set_has_kf(self.last_kf_pose is not None)
            self._set_kf_ref(T(self.last_kf_pose) if self._has_kf
                             else _identity_pose(self.device))
        self._flag_pending = []
        if "p_est" in data:
            for i in range(len(data["p_est"])):
                snap = (T(data["p_pts"][i]), T(data["p_desc"][i].view(np.int32)),
                        T(data["p_valid"][i]))
                self._flag_pending.append((int(data["p_frame"][i]), T(data["p_est"][i]),
                                           T(data["p_flag"][i]), snap))
        self.loop_closures = [tuple(int(x) for x in r) for r in data["loop_closures"]]
        # Each match table goes back to the store capacity it was launched
        # against (the padding past it is -1 rows), so the resolution sees
        # the tables of the uninterrupted run.
        self._closure_pending = []
        if "cp_kidx" in data:
            for i, (kidx, n_old) in enumerate(zip(data["cp_kidx"], data["cp_nold"])):
                k = min(data["cp_fwd"].shape[1], _store_capacity(int(kidx) + 1))
                self._closure_pending.append((int(kidx), int(n_old), T(data["cp_fwd"][i, :k]),
                                              T(data["cp_rev"][i, :k])))
        n_kf = int(data["n"])
        kf_frame = (data["kf_frame"] if "kf_frame" in data
                    else np.arange(n_kf, dtype=np.int32))
        if "anchor_kf" in data:
            segs: list[list] = [[] for _ in range(n_kf)]
            for ki, st, av in zip(data["anchor_kf"], data["anchor_start"], data["anchor_val"]):
                segs[int(ki)].append((int(st), av.copy()))
        else:  # the reference's single mutable anchor per keyframe
            legacy = data["anchor"] if "anchor" in data else data["pose"]
            segs = [[(int(kf_frame[i]), legacy[i].copy())] for i in range(n_kf)]
        desc = data["desc"].view(np.int32)
        self.keyframes = [
            Keyframe(index=i, pose=data["pose"][i], points_kf=data["points"][i], desc=desc[i],
                     valid=data["valid"][i], frame=int(kf_frame[i]), anchors=segs[i],
                     gdesc=_global_descriptor(desc[i], data["valid"][i]))
            for i in range(n_kf)
        ]
        self._rebuild_kf_store()

    # -- offline refinement ----------------------------------------------

    def build_ba_problem(self, dedup_max_hamming: int = 40) -> graph_mod.BAProblem | None:
        """Assemble a BA problem from the keyframe stores: cameras = keyframe
        poses; points = the union of the keyframes' landmark snapshots,
        deduplicated by descriptor matching (the first-seen world position
        is the point); observations = each keyframe's own measured local
        points projected through the camera. None with fewer than two
        keyframes."""
        self.flush_flags()
        if len(self.keyframes) < 2:
            return None
        K = len(self.keyframes)
        T = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        poses = T(np.stack([kf.pose for kf in self.keyframes]).astype(np.float32))
        pts_kf = T(np.stack([kf.points_kf for kf in self.keyframes]))
        desc = T(np.stack([kf.desc for kf in self.keyframes]).view(np.int32))
        valid = T(np.stack([kf.valid for kf in self.keyframes]))
        F = desc.shape[1]
        cap = int(min(K * F, self.cfg.backend.max_landmarks))
        world = geometry.se3_apply(poses[:, None, :], pts_kf)
        (_, sv, sp, _, n_drop), pid = _assign_point_ids(
            desc, valid, world, cap=cap, max_ham=dedup_max_hamming,
            steps=self._dedup_steps if self.capture else None, pool=self._graph_pool())
        n_drop = int(n_drop)
        if n_drop:
            # recorded in the metrics stream (not just stderr), so that an
            # exhausted capacity shows in a run's artifacts
            self.metrics.log(self.frame_idx, ba_points_dropped=n_drop, ba_point_capacity=cap)
            print(f"build_ba_problem: point capacity {cap} (backend.max_landmarks) exhausted; "
                  f"dropped {n_drop} new points (their observations are excluded)",
                  file=_sys.stderr)
        pid_c = torch.clamp(pid, 0, cap - 1)
        # Observations are each keyframe's own measured landmark position
        # (the snapshot-time local coordinates) projected through the
        # camera, not the deduped store position projected into every
        # camera: that would make the problem exactly self-consistent at its
        # initial values (cost 0, BA a no-op). Independent per-keyframe
        # measurements of one point are what BA reconciles.
        uv = self.camera.project(pts_kf)                     # [K, F, Dz]
        # Observation gating: a diverged lane can carry a local point whose
        # projection overflows float32 in the Huber cost.
        uv_bound = 10.0 * float(max(self.cfg.frontend.image_size))
        uv_ok = torch.all(torch.isfinite(uv) & (uv.abs() < uv_bound), dim=-1)
        pt_ok = torch.all(torch.isfinite(sp) & (sp.abs() < 1e6), dim=-1)
        cam_fixed = torch.zeros(K, dtype=torch.bool, device=self.device)
        cam_fixed[0] = True
        if not self.cfg.backend.ba_fuse_pose_graph:
            # pin the monocular scale gauge; with fused pose-graph edges the
            # odometry chain carries metric scale, so only camera 0 is pinned
            cam_fixed[1] = True
        return graph_mod.make_ba_problem(
            poses, sp,
            torch.arange(K, dtype=torch.int32, device=self.device).repeat_interleave(F),
            pid_c.reshape(-1), uv.reshape(K * F, -1),
            pt_valid=sv & pt_ok,
            obs_valid=((pid >= 0) & uv_ok & pt_ok[pid_c.long()]).reshape(-1),
            cam_fixed=cam_fixed, device=self.device,
        )

    def graph_pose_edges(self, weight: float = 1.0):
        """The pose graph's live edges as BA fusion terms (edge_ij, edge_rel,
        edge_info * weight, edge_valid); None when there is no edge."""
        ne = self.graph.n_edges
        if ne == 0:
            return None
        g = self.graph
        return g.edge_ij[:ne], g.edge_rel[:ne], g.edge_info[:ne] * weight, g.edge_valid[:ne]

    def ba_problem(self) -> graph_mod.BAProblem | None:
        """`build_ba_problem` with the backend's observation gates applied
        (reprojection outliers, observations per point): the problem
        `run_ba` and the multi-session joint BA solve."""
        prob = self.build_ba_problem()
        if prob is None:
            return None
        be = self.cfg.backend
        if be.ba_outlier_px > 0:
            prob = graph_mod.gate_outlier_obs(self.camera, prob, be.ba_outlier_px)
        if be.ba_max_obs_per_point > 0:
            prob = graph_mod.cap_obs_per_point(prob, be.ba_max_obs_per_point)
        return prob

    def solve_ba(self, prob, iters: int | None = None):
        """One single-device LM solve of `prob` with the backend's settings
        (the pose graph's edges fused when `backend.ba_fuse_pose_graph`);
        the keyframes are left as they are. Captured, the LM iteration
        replays the system's `ba.CapturedBA` graph of the problem's shapes."""
        be = self.cfg.backend
        if self.capture and self._ba_solver is None:
            self._ba_solver = ba_mod.CapturedBA(graph=self.device.type == "cuda",
                                                pool=self._graph_pool())
        return ba_mod.optimize_ba(
            self.camera, prob,
            iters=iters or be.gn_iters,
            lam=be.lm_damping_init,
            pcg_iters=be.pcg_iters,
            huber_delta=be.huber_delta,
            solver=be.solver if be.solver in ("pcg", "dense") else "pcg",
            step_clamp=(be.ba_step_clamp_cam, be.ba_step_clamp_pt),
            pose_edges=(self.graph_pose_edges(be.ba_pose_edge_weight)
                        if be.ba_fuse_pose_graph else None),
            capture=self._ba_solver if self.capture else False,
        )

    def solve_ba_distributed(self, prob, iters: int | None = None):
        """`dist_ba.optimize_ba_distributed` of `prob` with the points
        sharded over the `dcn` ranks of the system's mesh (one of map_axis
        ranks made for it when the system's does not fit: 1 x 1 on one
        process with map_axis = 1, as the reference's
        `make_mesh(n_devices=map_axis)` on one device). The pose graph's
        edges are not fused, as in the reference. Captured (`self.capture`),
        an LM iteration replays the mesh's graph of the problem's shapes
        (`dist_ba.CapturedDistBA`). Returns a `BAResult`."""
        be, d = self.cfg.backend, self.cfg.dist
        mesh = self.mesh
        if mesh is None or mesh.shape[mesh_mod.MAP_AXIS] != d.map_axis:
            mesh = mesh_mod.make_mesh(n_devices=d.map_axis, map_axis=d.map_axis)
            if not mesh.is_member:
                raise ValueError(f"rank {process_index()} is not in the {d.map_axis}-rank BA mesh")
        sp = dist_ba.shard_problem(prob, d.map_axis)
        res_prob, costs = dist_ba.optimize_ba_distributed(
            self.camera, sp, mesh, iters=iters or be.gn_iters, lam=be.lm_damping_init,
            pcg_iters=be.pcg_iters, huber_delta=be.huber_delta, capture=self.capture)
        return ba_mod.BAResult(problem=res_prob, costs=costs,
                               pcg_residuals=torch.zeros_like(costs))

    def run_ba(self, iters: int | None = None, distributed: bool | None = None):
        """Refine the keyframe poses and the deduped points by bundle
        adjustment; returns the `BAResult`, or None with fewer than two
        keyframes. distributed=None picks the distributed solver
        (`solve_ba_distributed`) when dist.map_axis > 1 and the system runs
        on a mesh, else the single-device bucketed solver (`solve_ba`)."""
        d = self.cfg.dist
        if distributed is None:
            distributed = d.map_axis > 1 and self.mesh is not None
        prob = self.ba_problem()
        if prob is None:
            return None
        res = self.solve_ba_distributed(prob, iters) if distributed else self.solve_ba(prob, iters)
        poses_np = res.problem.cam_pose.cpu().numpy()
        for i, kf in enumerate(self.keyframes):
            kf.pose = poses_np[i]
        return res

    def corrected_trajectory(self, est, final_optimize: bool = True):
        """Map the online per-frame estimates [T, 7] (frame t = row t-1) onto
        the optimized keyframe graph: each frame t in keyframe i's segment
        becomes pose_i . anchor_i^-1 . est_t, with pose_i the keyframe's
        optimized pose and anchor_i the emission pose its segment is
        relative to. Rows before the first keyframe keep their estimate."""
        if isinstance(est, (list, tuple)):
            est = torch.stack([torch.as_tensor(e) for e in est])
        est = torch.as_tensor(est).cpu().numpy() if torch.is_tensor(est) else np.asarray(est)
        if not self.keyframes:
            return est
        self.flush_flags()
        # drain closure matches dispatched by the final window
        if self._resolve_closures() and not final_optimize:
            self._optimize_and_correct()
        if final_optimize and self.loop_closures:
            self.graph = self._optimize_graph()
            poses_np = self.graph.poses[: len(self.keyframes)].cpu().numpy()
            for i, kf in enumerate(self.keyframes):
                kf.pose = poses_np[i]
        kf_frames = np.asarray([kf.frame for kf in self.keyframes])
        T = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        poses = T(np.stack([kf.pose for kf in self.keyframes]))
        a_kf = np.asarray([kf.index for kf in self.keyframes for _ in kf.anchors], np.int64)
        a_start = np.asarray([s for kf in self.keyframes for s, _ in kf.anchors], np.int64)
        a_val = T(np.stack([a for kf in self.keyframes for _, a in kf.anchors]))
        corr = geometry.se3_compose(poses[T(a_kf)], geometry.se3_inverse(a_val))
        frames = np.arange(1, len(est) + 1, dtype=np.int64)
        seg = np.searchsorted(kf_frames, frames, "right") - 1
        keys = a_kf * (np.int64(1) << 32) + a_start
        rowkey = seg.astype(np.int64) * (np.int64(1) << 32) + frames
        j = np.searchsorted(keys, rowkey, "right") - 1
        # composed on the system's device, copied to the host once
        out = geometry.se3_compose(corr[T(np.clip(j, 0, None))],
                                   T(np.asarray(est, np.float32))).cpu().numpy()
        return np.where((seg >= 0)[:, None], out, est)
