"""Device busy ms an LM iteration: the traced solve's busy time (the union
of its device activities) over its LM iterations."""


def read(run):
    if run.stretch is None:
        return None
    return run.stretch.busy_s * 1e3 / run.counters["lm_iters_traced"]
