"""A frozen copy of the plain-PyTorch paths of `parakeet_slam_tpu_torch`
(core, filter, frontend, backend and the kernels' plain twins), taken at
commit b9f5f19 with the imports pointed here, every kernel wrapper sent to
its plain twin on every device, and `kernels/_build.py` replaced by a stub
that builds nothing. It is the benchmark's reference: later changes to the
port do not reach it, and it imports nothing of the port.

Precision: the reference runs in float32 with TF32 off; `set_tf32(True)`
turns the control (the same reference in TF32) on."""

import torch


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    torch.backends.cudnn.allow_tf32 = bool(on)


set_tf32(False)
