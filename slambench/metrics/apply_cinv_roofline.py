"""apply_cinv's share of its roofline in the traced solve, in %: the sum of
each launch's bound (a bucket's N blocks: bytes N * CINV_BYTES over the
memory bandwidth against N * CINV_OPS over the float32 peak; the bytes
bind) over the sum of the launches' device times. Every bucket gets the
same launches in a solve, so the bound of a launch is the mean of the
buckets' bounds."""

from slambench.harness import roofline


def read(run):
    if run.stretch is None or "cinv_sizes" not in run.counters:
        return None
    launches = run.stretch.kernels("apply_cinv_kernel")
    if not launches:
        return None
    sizes = run.counters["cinv_sizes"]
    per = sum(roofline.bound(n * roofline.CINV_BYTES, n * roofline.CINV_OPS)[0]
              for n in sizes) / len(sizes)
    measured = sum(e - s for _, s, e in launches) / 1e6
    return roofline.share_pct(per * len(launches), measured)
