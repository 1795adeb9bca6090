"""Multi-process helpers of the port (`parakeet_slam_tpu.dist`). Only
`multihost.py` is ported: process-group set-up and restart-based recovery
from the checkpoint store. The sharded filter, the ring matcher, the
reshard and the distributed BA are not ported (ROADMAP Queue 1 item 3)."""

from parakeet_slam_tpu_torch.dist import multihost
from parakeet_slam_tpu_torch.dist.multihost import (
    initialize_multihost,
    resume_or_init,
    snapshot_every,
)
