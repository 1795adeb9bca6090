"""The FastSLAM 2.0 proposal kernel (`csrc/propose_3d.cu`) against its twin,
the refinement loop, bit for bit on the card: each product, reduction and
cross product of the loop against the kernel's order on the loop's own
operands at kitti00's and config 2's shapes and on the crafted frame at five
batch counts; `_propose` through both from filter states (refined and
sampled poses, P_cov, log_w); every frame of the eager online system on
rendered kitti00 and config 2 frames; the crafted edge frame at three batch
counts; one launch a frame graph replay. The parts are
`parakeet_slam_tpu_torch/eval/propose_check.py`'s."""

import pytest

from parakeet_slam_tpu_torch.eval import propose_check


@pytest.mark.card
@pytest.mark.parametrize("part", ["rules", "edges", "filter", "system", "capture"])
def test_propose_3d_equals_the_loop_on_the_card(card, part):
    propose_check.PARTS[part](card)
