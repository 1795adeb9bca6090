from parakeet_slam_tpu_torch.data import corridor
from parakeet_slam_tpu_torch.data.corridor import CorridorSim, make_corridor
