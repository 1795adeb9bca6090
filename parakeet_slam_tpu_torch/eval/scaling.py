"""Scaling-efficiency harness (port of `parakeet_slam_tpu.eval.scaling`).

Measures the sharded filter's frames/s on meshes of growing size carved
from the ranks of the process group (1, 2, 4, 8 up to the world size, as
the reference carves its meshes from the available devices) and reports
the efficiency. Weak scaling (the default): particles per rank fixed, so
eff(N) = frames/s(N) / frames/s(1); strong: eff(N) = frames/s(N) /
(N * frames/s(1)).

The step runs as it runs by default: on CUDA one captured graph a frame
(`filter/captured.CapturedStep` over `ShardedFastSLAM.step`, NCCL's
collectives and the ring's transfers inside), on the CPU eagerly; each row
also holds the eager step's frames/s from the same process
(`steps_per_s_eager`), for the A/B. Beside each mesh's frames/s it times
the two latencies under the sharded step: an all-reduce of one float and
one ring shift of 1 MiB. Every rank of
the group runs `measure_scaling` (the meshes are made with collective
calls); ranks outside a mesh sit its run out, and rank 0 prints one JSON
row per mesh:

    python -m parakeet_slam_tpu_torch.eval.scaling [--device cpu]

under N processes with COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID
set (`dist/multihost.py`); one process alone measures the 1-rank mesh.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from parakeet_slam_tpu_torch.core.config import FilterConfig
from parakeet_slam_tpu_torch.core.state import Observation
from parakeet_slam_tpu_torch.dist import mesh as mesh_mod
from parakeet_slam_tpu_torch.dist.mesh import PARTICLE_AXIS
from parakeet_slam_tpu_torch.dist.multihost import process_index
from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
from parakeet_slam_tpu_torch.filter import FastSLAM, captured
from parakeet_slam_tpu_torch.filter.runner import draw_noise


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _filter_throughput(n_devices: int, particles_per_device: int = 256, max_landmarks: int = 512,
                       steps: int = 20, device="cuda", capture=None):
    """(frames/s, the warm-up frames' ms) of the corridor-model filter
    sharded over the first `n_devices` ranks (None on a rank outside them):
    the reference's fixed frame of 16 range-bearing observations, every draw
    from one generator, timed after `steps` frames of warm-up, each of those
    timed alone (NCCL sets a connection up at its first use; the captured
    step's first frame runs eagerly and its second captures). `capture`:
    None for the captured step on CUDA and the eager step on the CPU, False
    for the eager step, True for the captured one (its buffer rules, eager,
    on the CPU). Every frame's draws are copied into the captured step's
    inputs before its replay."""
    cfg = FilterConfig(
        num_particles=particles_per_device * n_devices, max_landmarks=max_landmarks,
        max_observations=16, sig_dim=3, motion_noise=(0.3, 0.1, 0.3, 0.1),
        meas_noise=(0.1, 0.03), max_range=6.5, fov_half_angle=2.5,
    )
    mesh = mesh_mod.make_mesh(n_devices=n_devices)
    if not mesh.is_member:
        return None
    slam = FastSLAM(cfg)
    sharded = ShardedFastSLAM(slam, mesh)
    state = sharded.init_state(device=device)
    z = torch.stack([torch.linspace(1.0, 6.0, 16), torch.linspace(-2.0, 2.0, 16)], dim=1)
    obs = Observation(z=z.to(device), sig=torch.zeros(16, 3, device=device),
                      desc=torch.zeros(16, 0, dtype=torch.int32, device=device),
                      valid=torch.ones(16, dtype=torch.bool, device=device))
    u = torch.tensor([0.1, 0.0, 0.02], device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    noise, u0 = draw_noise(2 * steps, cfg.num_particles, slam.noise_dim, gen, device)
    if capture is None:
        capture = torch.device(device).type == "cuda"
    if capture:
        cs = captured.CapturedStep(
            lambda st, x: (sharded.step(st, x["u"], x["obs"], x["noise"], x["u0"])[0], ()),
            state, {"u": u, "obs": obs, "noise": sharded.local_draws(noise[0]).clone(),
                    "u0": u0[0].clone()},
            graph=torch.device(device).type == "cuda")

        def frame(t):
            cs.inputs["noise"].copy_(sharded.local_draws(noise[t]))
            cs.inputs["u0"].copy_(u0[t])
            cs()
    else:
        box = [state]

        def frame(t):
            box[0], _ = sharded.step(box[0], u, obs, sharded.local_draws(noise[t]), u0[t])
    warm = []
    for t in range(steps):
        t0 = time.perf_counter()
        frame(t)
        _sync(device)
        warm.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for t in range(steps, 2 * steps):
        frame(t)
    _sync(device)
    return steps / (time.perf_counter() - t0), warm


def _collective_ms(n_devices: int, device="cuda", reps: int = 20, nbytes: int = 1 << 20):
    """(all-reduce ms, ring-shift ms) over the first `n_devices` ranks (None
    on a rank outside them): the median host time of an all-reduce of one
    float, and of one step of a ring (a batched send to the next rank and
    receive from the previous) of `nbytes`, each ended by a device sync;
    the latencies under the sharded step's collectives and ring gather."""
    mesh = mesh_mod.make_mesh(n_devices=n_devices)
    if not mesh.is_member:
        return None
    group = mesh.axis_group(PARTICLE_AXIS)
    if group is None:
        return 0.0, 0.0
    S, me, ring = mesh.axis_size(PARTICLE_AXIS), mesh.axis_index(PARTICLE_AXIS), \
        mesh.axis_ranks(PARTICLE_AXIS)
    x = torch.zeros(1, device=device)
    buf = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    nxt = torch.empty_like(buf)

    def all_reduce():
        torch.distributed.all_reduce(x, group=group)

    def shift():
        for r in torch.distributed.batch_isend_irecv([
                torch.distributed.P2POp(torch.distributed.isend, buf, ring[(me + 1) % S], group),
                torch.distributed.P2POp(torch.distributed.irecv, nxt, ring[(me - 1) % S],
                                        group)]):
            r.wait()

    out = []
    for fn in (all_reduce, shift if S > 1 else None):
        if fn is None:
            out.append(0.0)
            continue
        times = []
        for _ in range(reps + 1):  # the first call sets the connections up
            t0 = time.perf_counter()
            fn()
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out.append(statistics.median(times[1:]))
    return tuple(out)


def measure_scaling(device_counts=None, weak: bool = True, device="cuda", **kw):
    """One row per mesh size ({"devices", "steps_per_s", "efficiency",
    "steps_per_s_eager", "efficiency_eager", "all_reduce_ms",
    "ring_shift_ms", "warmup_frame_ms"}) on rank 0 (printed as JSON), [] on
    the other ranks: the default step (captured on CUDA) and the eager
    step, one after the other. `kw` goes to `_filter_throughput`."""
    world = torch.distributed.get_world_size() if mesh_mod.is_distributed() else 1
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8) if c <= world]
    rows, base, base_eager = [], None, None
    for c in device_counts:
        out = _filter_throughput(c, device=device, **kw)
        eager = _filter_throughput(c, device=device, capture=False, **kw)
        lat = _collective_ms(c, device=device)
        if process_index() != 0:
            continue
        (fps, warm), fps_e = out, eager[0]
        base = fps if base is None else base
        base_eager = fps_e if base_eager is None else base_eager
        eff = fps / base if weak else fps / (c * base)
        eff_e = fps_e / base_eager if weak else fps_e / (c * base_eager)
        rows.append({"devices": c, "steps_per_s": round(fps, 2), "efficiency": round(eff, 3),
                     "steps_per_s_eager": round(fps_e, 2), "efficiency_eager": round(eff_e, 3),
                     "all_reduce_ms": round(lat[0], 4), "ring_shift_ms": round(lat[1], 4),
                     "warmup_frame_ms": [round(x, 2) for x in warm]})
        print(json.dumps(rows[-1]))
    return rows


def main(argv=None):
    from parakeet_slam_tpu_torch.dist.multihost import initialize_multihost

    ap = argparse.ArgumentParser(prog="parakeet_slam_tpu_torch.eval.scaling")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device available (use --device cpu)")
    initialize_multihost()
    measure_scaling(device=args.device)


if __name__ == "__main__":
    main()
