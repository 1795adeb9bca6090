"""The share of the window that the keyframe flush's pose-graph solves
take, in %: the program's `flush.optimize` spans on rank 0, summed over
the whole traced window (`flush_optimize_ms`), over the window's wall time
(`window_ms`). None where the program recorded no such span."""


def read(run):
    ms, window = run.counters.get("flush_optimize_ms"), run.counters.get("window_ms")
    if not ms or not window:
        return None
    return 100.0 * ms / window
