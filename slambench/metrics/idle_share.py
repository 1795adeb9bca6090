"""The device's idle share over the traced frames, in %: 1 - busy / wall,
busy and wall averaged over the ranks where the cell has several."""


def read(run):
    if run.stretch is None:
        return None
    busy = run.busy_s if run.busy_s is not None else run.stretch.busy_s
    wall = run.window_s if run.window_s is not None else run.stretch.wall_s
    return 100.0 * (1.0 - busy / wall)
