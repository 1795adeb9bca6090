"""The share of the window's card clock samples (`harness/clocks.py`, one
every 200 ms) whose SM clock is below 97% of the card's maximum SM clock,
in %. None where nothing was sampled (no nvidia-smi)."""

from slambench.harness.clocks import low_share


def read(run):
    return low_share(run.counters.get("clock_samples"))
