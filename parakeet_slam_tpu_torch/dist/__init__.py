"""The distributed layer of the port (`parakeet_slam_tpu.dist` on
`torch.distributed`): the process mesh and its collectives (`mesh.py`), the
particle-sharded filter with its ring gather (`sharded_filter.py`), ring
matching over a sharded descriptor database (`ring_match.py`), the
all-to-all observation reshard (`reshard.py`), the distributed bundle
adjustment (`dist_ba.py`), and process-group set-up with restart-based
recovery from the checkpoint store (`multihost.py`). gloo on the CPU, NCCL
with one card per rank."""

from parakeet_slam_tpu_torch.dist import dist_ba, mesh, multihost, sharded_filter
from parakeet_slam_tpu_torch.dist.mesh import (
    make_mesh,
    particle_sharding,
    replicated,
    shard_particle_state,
)
from parakeet_slam_tpu_torch.dist.multihost import (
    initialize_multihost,
    resume_or_init,
    snapshot_every,
)
from parakeet_slam_tpu_torch.dist.sharded_filter import ShardedFastSLAM
