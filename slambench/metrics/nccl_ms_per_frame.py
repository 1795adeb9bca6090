"""Rank 0's device ms a frame in NCCL's kernels (names holding "nccl") over
the traced frames."""


def read(run):
    return run.counters.get("nccl_ms_per_frame")
