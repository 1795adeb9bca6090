"""parakeet_slam_tpu_torch — the PyTorch + CUDA port of `parakeet_slam_tpu`.

Ported: the 2-D corridor FastSLAM 1.0 main path, the 3-D vision filter
(FastSLAM 1.0/2.0), the online monocular system (`system.SLAMSystem`:
frontend, keyframes, loop closure, pose graph) and bundle adjustment
(`backend.ba`: Schur/PCG Levenberg-Marquardt, `SLAMSystem.run_ba`), with the
fused measurement updates, the resampling gather, the descriptor matchers
and the landmark-block inverse-apply as hand-written CUDA kernels for Hopper
(`csrc/`). The layout mirrors the JAX package
(`core/ data/ filter/ frontend/ backend/ kernels/ eval/ utils/ system.py
cli.py`); this package never imports jax or `parakeet_slam_tpu`.
"""

import torch

# Full float32 everywhere: TF32 keeps ~3 decimal digits, and the reference
# pins float32 because reduced-precision small matmuls (~1% on covariances)
# break filter parity (parakeet_slam_tpu/filter/fastslam.py, measurement_core).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from parakeet_slam_tpu_torch import core, data, eval, filter, kernels  # noqa: E402,A004
