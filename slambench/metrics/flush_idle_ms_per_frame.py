"""The device's idle time inside the keyframe flush, in ms a frame: the
idle time of the profiled stretch (no device activity) that falls inside
the program's `flush` spans, brought onto the profiler's clock, over the
frames traced. None where the stretch holds no program span."""

from slambench.harness.spans import FLUSH, idle_inside_us


def read(run):
    spans = getattr(run.stretch, "spans", None)
    frames = run.counters.get("frames_traced")
    if not spans or not frames:
        return None
    st = run.stretch
    return idle_inside_us(st.ops, spans, FLUSH, 0.0, st.wall_s * 1e6) / 1e3 / frames
