from parakeet_slam_tpu_torch.filter import models
from parakeet_slam_tpu_torch.filter.fastslam import FastSLAM, StepMetrics
from parakeet_slam_tpu_torch.filter.fastslam2 import FastSLAM2, make_filter
from parakeet_slam_tpu_torch.filter.runner import run_sequence
