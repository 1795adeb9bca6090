"""The device's idle share over the traced solve, in %: 1 - busy / wall."""


def read(run):
    if run.stretch is None:
        return None
    return 100.0 * (1.0 - run.stretch.busy_s / run.stretch.wall_s)
