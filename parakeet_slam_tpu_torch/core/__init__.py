from parakeet_slam_tpu_torch.core import config, geometry, linalg, state
from parakeet_slam_tpu_torch.core.config import FilterConfig, SLAMConfig, load_config
from parakeet_slam_tpu_torch.core.state import (
    Observation,
    ParticleState,
    make_observation,
    make_particle_state,
    state_from_numpy,
    state_to_numpy,
)
