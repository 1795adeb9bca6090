"""Multi-process initialization and restart-based failure recovery (port of
`parakeet_slam_tpu.dist.multihost`).

A running process group cannot be resized, so recovery is by restart:
snapshot the state every K steps (`utils/checkpoint.py`); after losing a
process, relaunch with fewer and resume from the latest snapshot.
`initialize_multihost` sets up `torch.distributed` (gloo on the CPU, NCCL on
the card) from its arguments or the environment; nothing on a machine tells
a program of its cluster, so the coordinator's address, the world size and
the rank are given:

    initialize_multihost("localhost:1234", num_processes=2, process_id=rank)
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as tdist

from parakeet_slam_tpu_torch.utils import checkpoint as ckpt


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None) -> bool:
    """Initialize the default process group from the arguments or the
    environment (COORDINATOR_ADDRESS "host:port", NUM_PROCESSES,
    PROCESS_ID): NCCL when a card is present, gloo otherwise. Returns
    False, and does nothing, when single-process."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        # one card per rank: NCCL puts no two ranks on one device
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    tdist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id)
    return True


def free_local_port() -> int:
    """A TCP port on 127.0.0.1 that is free now: the coordinator address of
    a process group whose ranks all run on this machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_index() -> int:
    """This process's rank (0 when no process group is initialized)."""
    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def resume_or_init(ckpt_dir: str, template, init_fn):
    """Restart-based recovery: load the latest snapshot in ckpt_dir if there
    is one (checked against `template`), else build fresh state with
    `init_fn()`. Returns (state, start_step)."""
    latest = ckpt.latest_checkpoint(ckpt_dir)
    if latest is not None:
        try:
            return ckpt.load_checkpoint(latest, template)
        except ValueError:
            # the layout changed (a smaller group after losing a process,
            # with other per-process capacities): start over and keep going
            pass
    return init_fn(), 0


def snapshot_every(ckpt_dir: str, every: int):
    """A callback(state, step) that snapshots every `every` steps, on rank 0
    only."""

    def cb(state, step: int):
        if every <= 0 or step % every or process_index() != 0:
            return
        ckpt.save_checkpoint(os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz"), state, step)

    return cb
