"""Sequence runner: the SLAM step over a whole prerecorded sequence
(port of `parakeet_slam_tpu.filter.runner`).

The reference scans one jitted step over the sequence, one device program.
Here, on CUDA tensors, the step is captured once as a CUDA graph
(`filter/captured.py`) that reads frame t of the sequence at a device-side
counter, writes its estimate and metrics into row t of preallocated
tensors and advances the counter: the host launches one graph a frame and
reads nothing until the end. `capture=False` asks for the eager twin, a
Python loop of `slam.step` calls, which the tests and `chip_smoke.py` hold
the graph against; on CPU tensors the eager loop is the default, and
`capture=True` runs the captured path's buffer discipline eagerly. The
per-frame random draws (the motion or proposal noise [P, noise_dim] and the
resampling comb offset u0) come from an explicit `torch.Generator`, or are
injected, so that a test can replay the reference's exact draws.

`slam` may also be a `dist.sharded_filter.ShardedFastSLAM`: the state is
then this rank's rows, the draws are the global [T, P, noise_dim] of which
each rank takes its own, and the captured frame holds the sharded step's
collectives and ring transfers (config 5's compiled step).
"""

from __future__ import annotations

import torch

from parakeet_slam_tpu_torch.core.state import Observation, ParticleState
from parakeet_slam_tpu_torch.filter import captured
from parakeet_slam_tpu_torch.filter.fastslam import FastSLAM, StepMetrics

METRICS = ("ess", "num_landmarks", "match_frac", "resampled")


def draw_noise(num_steps: int, num_particles: int, dim: int, generator: torch.Generator,
               device):
    """(noise [T, P, dim] standard normals, resample_u0 [T] in [0, 1/P))."""
    noise = torch.randn(num_steps, num_particles, dim, generator=generator, device=device)
    u0 = torch.rand(num_steps, generator=generator, device=device) / num_particles
    return noise, u0


def _frame(slam: FastSLAM):
    """The captured function: frame t of the sequence buffers, t read at
    the device counter `x["t"]`, its estimate and metrics written at row t."""

    def frame(state, x):
        t = x["t"]
        at = lambda name: x[name].index_select(0, t)[0]  # noqa: E731
        obs = Observation(z=at("obs_z"), sig=at("obs_sig"), desc=at("obs_desc"),
                          valid=at("obs_valid"))
        state, m = slam.step(state, at("odom"), obs, at("noise"), at("u0"))
        x["est"].index_copy_(0, t, slam.estimate_pose(state)[None])
        for name in METRICS:
            x[name].index_copy_(0, t, getattr(m, name).reshape(1))
        t.add_(1)
        return state, ()

    return frame


def _sequence_step(slam: FastSLAM, state: ParticleState, seq: dict, graph: bool):
    """The filter's CapturedStep for sequences of this shape: the one built
    for the last call when the shapes agree (its graph is replayed as it
    is), else a new one. The filter keeps one, with its buffers."""
    key = (graph, tuple((tuple(t.shape), t.dtype, t.device)
                        for t in captured.leaves(state) + captured.leaves(seq)))
    held = getattr(slam, "_sequence_step", None)
    if held is not None and held[0] == key:
        return held[1]
    slam._sequence_step = None  # free the old buffers and graph first
    T, dev = seq["odom"].shape[0], seq["odom"].device
    x = {k: torch.empty_like(v) for k, v in seq.items()}
    x["t"] = torch.zeros(1, dtype=torch.int64, device=dev)
    x["est"] = torch.empty(T, slam.cfg.pose_dim, dtype=torch.float32, device=dev)
    for name in METRICS:
        x[name] = torch.empty(T, dtype=torch.bool if name == "resampled" else torch.float32,
                              device=dev)
    cs = captured.CapturedStep(_frame(slam), captured.clone(state), x, graph=graph)
    slam._sequence_step = (key, cs)
    return cs


def run_sequence(
    slam: FastSLAM,
    state: ParticleState,
    odom: torch.Tensor,       # [T, u_dim]
    obs_z: torch.Tensor,      # [T, Z, Dz]
    obs_sig: torch.Tensor,    # [T, Z, S]
    obs_valid: torch.Tensor,  # [T, Z]
    generator: torch.Generator | None = None,
    motion_noise: torch.Tensor | None = None,  # [T, P, slam.noise_dim]
    resample_u0: torch.Tensor | None = None,   # [T]
    obs_desc: torch.Tensor | None = None,      # [T, Z, W] int32 packed descriptors
    capture: bool | None = None,
):
    """Run the filter over a sequence; returns (final_state, est [T, pose_dim],
    metrics: list of per-frame StepMetrics). `state` is not modified.
    `capture`: None for the CUDA graph on CUDA tensors and the eager loop
    on CPU tensors, False for the eager loop, True for the captured path
    (eager under its buffer rules on the CPU)."""
    T, Z = obs_valid.shape
    P = slam.cfg.num_particles  # the global count: a sharded state holds P / S rows
    dev = state.pose.device
    if motion_noise is None or resample_u0 is None:
        if generator is None:
            raise ValueError("run_sequence needs a generator or injected draws")
        noise, u0 = draw_noise(T, P, slam.noise_dim, generator, dev)
        motion_noise = noise if motion_noise is None else motion_noise
        resample_u0 = u0 if resample_u0 is None else resample_u0
    if obs_desc is None:
        obs_desc = torch.zeros(T, Z, 0, dtype=torch.int32, device=dev)
    if capture is None:
        capture = dev.type == "cuda"
    if not capture:
        state = state.clone()
        est, metrics = [], []
        for t in range(T):
            obs = Observation(z=obs_z[t], sig=obs_sig[t], desc=obs_desc[t], valid=obs_valid[t])
            state, m = slam.step(state, odom[t], obs, motion_noise[t], resample_u0[t])
            est.append(slam.estimate_pose(state))
            metrics.append(m)
        return state, torch.stack(est), metrics
    seq = {"odom": odom, "obs_z": obs_z, "obs_sig": obs_sig, "obs_desc": obs_desc,
           "obs_valid": obs_valid, "noise": motion_noise,
           "u0": torch.as_tensor(resample_u0, dtype=torch.float32, device=dev)}
    cs = _sequence_step(slam, state, seq, graph=dev.type == "cuda")
    captured.copy_into(cs.state, state)
    captured.copy_into({k: cs.inputs[k] for k in seq}, seq)
    cs.inputs["t"].zero_()
    for _ in range(T):
        cs()
    out = captured.clone({k: cs.inputs[k] for k in ("est", *METRICS)})
    metrics = [StepMetrics(**{k: out[k][t] for k in METRICS}) for t in range(T)]
    return captured.clone(cs.state), out["est"], metrics
