"""`clock_low_share` of the bundle-adjustment cell, which reports `ba_solve_s`: the same
reading (`metrics/clock_low_share.py`), split by the end-to-end metric it moves."""

from slambench.harness.spec import metric_reader

read = metric_reader("clock_low_share")
