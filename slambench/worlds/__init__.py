"""Traffic made from the seed, on the card: the worlds, frames and problems
the drivers serve (copies of the port's generators, rewritten in PyTorch)."""
