"""The joint BA's problem making and packing on the host, in ms a solve:
the median, over the window's solves, of the program's `ba.problem` and
`ba.pack` spans summed for each solve. None where the program recorded no
span."""

import statistics


def read(run):
    ms = run.counters.get("ba_pack_ms")
    return statistics.median(ms) if ms else None
