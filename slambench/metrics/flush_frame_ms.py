"""The median latency of the window's flush frames (every kf_flag_lag-th
frame, where the host reads the keyframe flags and runs the keyframe
backend), from the frame's submission to its completion on the device, on
the host's clock. Taken from the traced run's window."""


def read(run):
    return run.counters.get("flush_frame_ms")
