"""The device's idle time while the host makes and packs the BA problem,
in ms: the idle time of the traced solve (no device activity) that falls
inside the program's `ba.problem` or `ba.pack` spans, on the profiler's
clock. None where the stretch holds no program span."""

from slambench.harness.spans import PACK, idle_inside_us


def read(run):
    spans = getattr(run.stretch, "spans", None)
    if not spans:
        return None
    st = run.stretch
    return idle_inside_us(st.ops, spans, PACK, 0.0, st.wall_s * 1e6) / 1e3
