"""slam1_tpu_torch — the PyTorch/CUDA port of the stereo SLAM framework.

A second package beside `slam1_tpu/` (the JAX reference, unchanged),
mirroring its layout and names: `ops/` (SE(3), camera, FAST/BRIEF
detection, Hamming matching, RANSAC-PnP, two-view geometry, least
squares, k-means, CG, LK, disparity, the hand-written CUDA kernels in
`csrc/`), `models/` (stereo and flow VO, map, BoW, loop closure, pose
graph, bundle adjustment, the reference backend, the SLAM system),
`parallel/` (the distributed layer on torch.distributed), `utils/`
(synthetic data, KITTI, exports, ATE/RPE, interop with the JAX
package's exports) and `cli.py` (`slam-torch`). It imports torch and
numpy, never jax. Everything of the JAX package is ported but its bench.
"""

__version__ = "0.1.0"

from slam1_tpu_torch import runtime  # noqa: F401  (precision side effects)
from slam1_tpu_torch.config import SlamConfig  # noqa: F401
