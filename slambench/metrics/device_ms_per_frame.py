"""Device busy ms a frame over the traced frames: the union of the device
activities' intervals, averaged over the ranks where the cell has several."""


def read(run):
    if run.stretch is None:
        return None
    busy = run.busy_s if run.busy_s is not None else run.stretch.busy_s
    return busy * 1e3 / run.counters["frames_traced"]
