from slambench.reference.frozen.filter.fastslam2 import make_filter  # noqa: F401
