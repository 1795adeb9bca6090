from parakeet_slam_tpu_torch.frontend import camera, describe, detect
from parakeet_slam_tpu_torch.frontend.detect import detect as detect_features
from parakeet_slam_tpu_torch.frontend.describe import describe as describe_features
