"""Device activities (kernels, copies, memsets) an LM iteration in the
traced solve."""


def read(run):
    if run.stretch is None:
        return None
    return len(run.stretch.ops) / run.counters["lm_iters_traced"]
