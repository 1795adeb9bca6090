"""Multi-process FastSLAM: the particle axis sharded over the mesh's `ici`
ranks (port of `parakeet_slam_tpu.dist.sharded_filter`).

Every stage of the step but the resample is per particle (motion or
proposal, association, EKF updates, map management), so each rank runs the
one-device code on its P / S rows, through the same kernels. The
collectives are:

1. **weights**: an all-gather of the [P] log-weights. The ESS, the resample
   decision and the systematic indices are computed from the gathered
   weights, so every rank decides alike;
2. **payload**: the survivors' whole states move between ranks round a
   ring (`ring_gather_rows`): S - 1 transfers of one block each, every
   leaf packed into one byte buffer, with each rank taking the rows whose
   source block is resident through the source-window launch of the
   `gather_rows` kernel before each rotation.

The resample is decided on the device, as in `FastSLAM._resample_and_metrics`
(the reference's `lax.cond`): the ring gather runs every frame, at the
identity indices where the ESS asks for no resample, and log_w is reset
only where it does; so a frame without a resample leaves the state bit for
bit as the cond's untouched branch does. Nothing in `step`,
`ring_gather_rows` or `best_particle_lanes` reads the device on the host,
so the step captures as one CUDA graph with NCCL's collectives and
transfers inside (`filter/captured.py`; `filter/runner.run_sequence` takes
a `ShardedFastSLAM` as it takes a `FastSLAM`).

Estimates, the best particle's map and checkpoints read across particles,
so they are collectives too (`estimate_pose`, `best_particle_lanes`,
`gather_state`).

With the program's tracer on, the counter `dist.ring_bytes` adds the bytes
this rank's ring gather sends (S - 1 blocks a gather; inside the captured
step once a replay, `utils/trace.py`), and `dist.gather_bytes` the
all-gathers' (`dist/mesh.py`).

**Draws depart from the reference.** It folds the motion key with the
shard index (a stream per shard), and its threefry streams cannot be
reproduced in torch in any case. Here every rank draws the *global*
[P, noise_dim] noise and u0 from one shared generator and keeps its own
rows, so a run over S ranks consumes exactly the draws of the one-device
run and equals it bit for bit; that costs P * noise_dim normals a frame on
every rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist

from parakeet_slam_tpu_torch.core.state import Observation, ParticleState, make_particle_state
from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.mesh import PARTICLE_AXIS, Mesh
from parakeet_slam_tpu_torch.filter.fastslam import FastSLAM, StepMetrics
from parakeet_slam_tpu_torch.filter.fastslam2 import FastSLAM2
from parakeet_slam_tpu_torch.kernels import resample as resample_kernel
from parakeet_slam_tpu_torch.kernels import resample_cuda
from parakeet_slam_tpu_torch.utils import trace

_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(ParticleState))


def _payload_leaves(payload) -> tuple[list[str], list[torch.Tensor]]:
    """(names, tensors) that travel: a state's gathered leaves (log_w is
    reset by the gather, not moved), or every entry of a dict."""
    if isinstance(payload, ParticleState):
        names = list(resample_cuda._LEAVES)
    else:
        names = sorted(payload)
    return names, [getattr(payload, n) if isinstance(payload, ParticleState) else payload[n]
                   for n in names]


def _rebuild(payload, names, tensors):
    if isinstance(payload, ParticleState):
        return ParticleState(log_w=tensors[0].new_zeros((tensors[0].shape[0],), dtype=torch.float32),
                             **dict(zip(names, tensors)))
    return dict(zip(names, tensors))


def _take(block, rows: torch.Tensor):
    """block's rows `rows`: a state through the `gather_rows` kernel (its
    twin on the CPU), a dict of tensors through index_select."""
    if isinstance(block, ParticleState):
        return resample_cuda.gather_state(block, rows)
    return {k: v.index_select(0, rows) for k, v in block.items()}


def _take_window(block, idx: torch.Tensor, lo: int, out):
    """`out` with the rows whose index lies in the block's window [lo, lo +
    Pl) taken from it (row idx - lo) and the others left as they are: a
    state through the source-window launch of `gather_rows` (its twin on
    the CPU), a dict of tensors in the reference's form (a take of clamped
    rows merged with `where`). `out` None: a new payload of len(idx) rows
    (a dict's zeros, as the reference's)."""
    if isinstance(block, ParticleState):
        return resample_cuda.gather_state(block, idx, window=lo, out=out)
    Pl = next(iter(block.values())).shape[0]
    sel = (idx >= lo) & (idx < lo + Pl)
    rows = torch.clamp(idx - lo, 0, Pl - 1)
    merged = {}
    for k, v in block.items():
        o = out[k] if out is not None else v.new_zeros((idx.shape[0],) + tuple(v.shape[1:]))
        merged[k] = torch.where(sel.reshape((-1,) + (1,) * (v.dim() - 1)),
                                v.index_select(0, rows), o)
    return merged


def ring_gather_rows(payload, global_idx: torch.Tensor, mesh: Mesh, axis: str = PARTICLE_AXIS):
    """out[i] = global_payload[global_idx[i]], where `payload` (a
    ParticleState or a dict of tensors, every leaf [Pl, ...]) is this rank's
    block of a [S * Pl, ...] payload sharded along `axis`. Returns the
    payload's type with len(global_idx) rows (a state's log_w set to 0).

    The reference's form (`parakeet_slam_tpu/dist/sharded_filter.py:20-52`)
    with fixed shapes and no read of the device on the host: step s holds
    the block of rank me - s, and the rows whose index lies in that block's
    window take their row from it while the others are left as they were
    (`_take_window`), so every output row is written once over the S steps;
    meanwhile the block moves on to rank me + 1 (a batched send and receive
    of one byte buffer). S - 1 transfers; the reference's last one, which
    only brings the block home, is skipped, and at S = 1 the gather is the
    one-device gather."""
    S = mesh.axis_size(axis)
    idx = global_idx.long()
    if S == 1:
        return _take(payload, idx)
    me = mesh.axis_index(axis)
    ring = mesh.axis_ranks(axis)
    group = mesh.axis_group(axis)
    names, leaves = _payload_leaves(payload)
    Pl = leaves[0].shape[0]
    buf, layout = mesh_mod.pack_bytes(leaves)
    trace.count("dist.ring_bytes", (S - 1) * buf.numel())
    out = None
    for s in range(S):
        reqs = None
        if s < S - 1:
            nxt = torch.empty_like(buf)
            reqs = tdist.batch_isend_irecv([
                tdist.P2POp(tdist.isend, buf, ring[(me + 1) % S], group=group),
                tdist.P2POp(tdist.irecv, nxt, ring[(me - 1) % S], group=group),
            ])
        src = (me - s) % S  # whose block is resident after s rotations
        block = _rebuild(payload, names, mesh_mod.unpack_bytes(buf, layout))
        out = _take_window(block, idx, src * Pl, out)
        if reqs is not None:
            for r in reqs:
                r.wait()
            buf = nxt
    return out


class ShardedFastSLAM:
    """Drives a FastSLAM (1.0 or 2.0) instance with the particle axis
    sharded over `mesh`'s `ici` ranks: cfg.num_particles in all, P / S on
    each rank, replicated along `dcn`."""

    def __init__(self, slam: FastSLAM, mesh: Mesh):
        self.slam = slam
        self.mesh = mesh
        self.axis = PARTICLE_AXIS
        S = mesh.axis_size(self.axis)
        P = slam.cfg.num_particles
        if P % S != 0:
            raise ValueError(f"num_particles={P} not divisible by particle-axis size {S}")
        self.rows = mesh_mod.particle_sharding(mesh).rows(P)
        self.local_particles = P // S

    def init_state(self, init_pose=None, *, device) -> ParticleState:
        """This rank's rows of the initial state (every particle at
        init_pose with an empty map)."""
        c = self.slam.cfg
        return make_particle_state(self.local_particles, c.max_landmarks, c.lm_dim, c.sig_dim,
                                   c.desc_words, c.pose_dim, init_pose, device=device)

    def local_draws(self, noise: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the frame's global [P, noise_dim] draws."""
        return noise[self.rows]

    @property
    def cfg(self):
        return self.slam.cfg

    @property
    def noise_dim(self) -> int:
        return self.slam.noise_dim

    def step(self, state: ParticleState, u, obs: Observation, noise, u0):
        """One frame on this rank's rows: `noise` this rank's rows of the
        global draws [P / S, noise_dim] (`local_draws`), or the global
        draws [P, noise_dim] themselves, of which it takes its rows; u0 the
        common comb offset. Returns (state, StepMetrics) with the global
        ESS, landmark mean and the resample decision (a 0-dim bool
        tensor)."""
        slam = self.slam
        cfg = slam.cfg
        if noise.shape[0] != self.local_particles:
            noise = self.local_draws(noise)
        log_w0 = state.log_w.clone() if cfg.likelihood_temper != 1.0 else None
        if isinstance(slam, FastSLAM2):
            # the proposal is per particle; it weights the frame itself and
            # the map pass reuses its association scores
            state, scores = slam._propose(state, u, obs, noise)
            state, mean_match = slam.measurement_core(state, obs, weight_matched=False,
                                                      scores=scores)
        else:
            state = slam.motion_update(state, u, noise)
            state, mean_match = slam.measurement_core(state, obs)
        state = slam._temper(state, log_w0)

        lw_all = mesh_mod.all_gather_rows(state.log_w, self.mesh, self.axis)
        P = lw_all.shape[0]
        ess = resample_kernel.effective_sample_size(lw_all)
        need = ess < cfg.resample_frac * P  # a 0-dim bool, equal on every rank
        keep = torch.arange(P, device=lw_all.device)
        idx = torch.where(need, resample_kernel.systematic_resample_indices(lw_all, u0), keep)
        log_w = state.log_w
        state = ring_gather_rows(state, idx[self.rows], self.mesh, self.axis)
        state = state.replace(log_w=torch.where(need, state.log_w, log_w))
        S = self.mesh.axis_size(self.axis)
        counts = mesh_mod.all_gather_rows(state.num_landmarks(), self.mesh, self.axis)
        n_obs = torch.clamp(obs.valid.to(torch.float32).sum(), min=1.0)
        metrics = StepMetrics(
            ess=ess,
            num_landmarks=counts.to(torch.float32).mean(),
            match_frac=mesh_mod.all_reduce_sum(mean_match, self.mesh, self.axis) / S / n_obs,
            resampled=need,
        )
        return state, metrics

    def estimate_pose(self, state: ParticleState) -> torch.Tensor:
        """The one-device estimate over the gathered poses and weights."""
        pose, log_w = mesh_mod.all_gather_packed([state.pose, state.log_w], self.mesh, self.axis)
        return self.slam.estimate_pose(state.replace(pose=pose, log_w=log_w))

    def best_particle_lanes(self, state: ParticleState):
        """(lm_mean [L, Dl], lm_valid [L], lm_desc [L, W], lm_count [L]) of
        the highest-weight particle (the first on a tie, as argmax over all
        P), on every rank and with no read of the device on the host: every
        rank finds the global argmax in the gathered weights, offers its own
        row at the argmax's local index, and keeps the owner's among the
        gathered offers (a copy: a sum of masked lanes would turn -0.0 into
        0.0)."""
        lw_all = mesh_mod.all_gather_rows(state.log_w, self.mesh, self.axis)
        best = torch.argmax(lw_all).reshape(1)
        Pl = self.local_particles
        fields = (state.lm_mean, state.lm_valid, state.lm_desc, state.lm_count)
        # index_select: indexing with a 0-dim tensor reads it on the host
        mine = [t.index_select(0, best % Pl) for t in fields]
        if self.mesh.axis_group(self.axis) is None:
            return tuple(t[0] for t in mine)
        offers = mesh_mod.all_gather_packed(mine, self.mesh, self.axis)
        return tuple(t.index_select(0, best // Pl)[0] for t in offers)

    def gather_state(self, state: ParticleState) -> ParticleState:
        """The global state (all P rows) on every rank of the `ici` line."""
        leaves = mesh_mod.all_gather_packed([getattr(state, f) for f in _STATE_FIELDS],
                                            self.mesh, self.axis)
        return ParticleState(**dict(zip(_STATE_FIELDS, leaves)))

    def global_template(self, state: ParticleState) -> ParticleState:
        """Host tensors of the global state's shapes and dtypes (a checkpoint
        template), from this rank's rows."""
        P = self.slam.cfg.num_particles
        return ParticleState(**{
            f: torch.empty((P,) + tuple(getattr(state, f).shape[1:]),
                           dtype=getattr(state, f).dtype) for f in _STATE_FIELDS})

    def shard_state(self, state: ParticleState, device=None) -> ParticleState:
        """This rank's rows of a global state, on `device` (the state's own
        by default)."""
        local = mesh_mod.shard_particle_state(state, self.mesh)
        if device is None:
            return local
        return local.replace(**{f: getattr(local, f).to(device) for f in _STATE_FIELDS})
