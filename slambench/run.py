#!/usr/bin/env python3
"""The benchmark's one command:

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It runs the cell named in BENCHMARK.json
on the cards of this machine and prints one JSON line as the last line of
its standard output (see slambench/README.md)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # the checkout's own packages (the port and this benchmark), whatever
    # the working directory
    sys.path.insert(0, ROOT)
    from slambench.harness import cli

    sys.exit(cli.main(sys.argv[1:], ROOT))
