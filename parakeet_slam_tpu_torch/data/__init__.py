from parakeet_slam_tpu_torch.data import corridor, synth_vision
from parakeet_slam_tpu_torch.data.corridor import CorridorSim, make_corridor
from parakeet_slam_tpu_torch.data.synth_vision import VisionWorld, make_drive_world
