"""Device activities (kernels, copies, memsets) a frame over the traced
frames."""


def read(run):
    if run.stretch is None:
        return None
    return len(run.stretch.ops) / run.counters["frames_traced"]
