"""slam1_tpu_torch — the PyTorch/CUDA port of the stereo SLAM framework.

A second package beside `slam1_tpu/` (the JAX reference, unchanged),
mirroring its layout and names: `ops/` (SE(3), camera, FAST/BRIEF
detection, Hamming matching, RANSAC-PnP, k-means, CG, the hand-written
CUDA kernels in `csrc/`), `models/` (stereo frontend, tracker, VO, map,
BoW, loop closure, pose graph, the SLAM system) and `utils/` (synthetic
data, ATE/RPE, interop with the JAX package's exports).
It imports torch and numpy, never jax.

Ported so far: stereo VO (`models/vo.py`) and the SLAM system without
bundle adjustment (`models/pipeline.py`).
"""

__version__ = "0.1.0"

from slam1_tpu_torch import runtime  # noqa: F401  (precision side effects)
from slam1_tpu_torch.config import SlamConfig  # noqa: F401
