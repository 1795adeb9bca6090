from parakeet_slam_tpu_torch.filter import models
from parakeet_slam_tpu_torch.filter.fastslam import FastSLAM, StepMetrics
from parakeet_slam_tpu_torch.filter.runner import run_sequence


def make_filter(cfg) -> FastSLAM:
    """Algorithm-selecting factory: cfg.algorithm in {fastslam1, fastslam2}."""
    algo = getattr(cfg, "algorithm", "fastslam1")
    if algo == "fastslam1":
        return FastSLAM(cfg)
    if algo == "fastslam2":
        raise NotImplementedError(
            "fastslam2 is not ported yet (ROADMAP Queue 1, slice 2)"
        )
    raise ValueError(f"unknown algorithm {algo!r}")
