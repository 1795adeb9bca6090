from parakeet_slam_tpu_torch.eval import metrics
from parakeet_slam_tpu_torch.eval.metrics import ate_rmse, rpe_rmse
