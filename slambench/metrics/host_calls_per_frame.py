"""Host CUDA API calls a frame (runtime and driver calls: graph launches,
copies, stream queries, kernel launches), averaged over the traced frames,
flush frames included; on rank 0 where the cell has several."""


def read(run):
    if run.stretch is None:
        return None
    return run.stretch.host_calls / run.counters["frames_traced"]
