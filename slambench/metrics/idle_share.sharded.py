"""`idle_share` of the sharded cells, which report `frames_per_s.sharded`: the
same reading (`metrics/idle_share.py`), split by the end-to-end metric it moves."""

from slambench.harness.spec import metric_reader

read = metric_reader("idle_share")
