"""The benchmark's general machinery: finding a cell's files by name, the
run's environment, timing and tracing, the roofline arithmetic, and the
result line."""
