"""`host_calls_per_frame` of the sharded cells, which report `frames_per_s.sharded`: the
same reading (`metrics/host_calls_per_frame.py`), split by the end-to-end metric it moves."""

from slambench.harness.spec import metric_reader

read = metric_reader("host_calls_per_frame")
