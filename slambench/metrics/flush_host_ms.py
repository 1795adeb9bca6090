"""The keyframe flush's own host time, in ms: the median, over the traced
run's window flush frames, of the program's `flush` span's self time (its
duration less the device waits under it: the flags' read, the closure
tables' fetch, the verify's and the solve's reads, the keyframes'
snapshots). None where the program recorded no span."""

import statistics


def read(run):
    ms = run.counters.get("flush_self_ms")
    return statistics.median(ms) if ms else None
