"""slambench: the benchmark of `parakeet_slam_tpu_torch` on NVIDIA H100 cards.

`python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` and prints one JSON line (see README.md)."""
