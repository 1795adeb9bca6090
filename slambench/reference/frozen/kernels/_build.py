"""The frozen reference launches no kernel: every wrapper above takes its
plain twin, so the port's kernel library is never built or loaded here."""


def library():
    raise RuntimeError("the frozen reference runs no CUDA kernel")


def check(err, what):
    raise RuntimeError(f"the frozen reference runs no CUDA kernel ({what})")


def float_array(values):
    return list(values)


def stream_ptr(t):
    return 0
