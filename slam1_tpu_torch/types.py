"""Fixed-capacity containers of tensors (counterpart of
`slam1_tpu/types.py`): every stage exchanges fixed-capacity tensors
with validity masks."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Features(NamedTuple):
    """Keypoints + descriptors for one image. Capacity N = cfg.detector.max_kp."""
    xy: torch.Tensor      # (N,2) float32 pixel coords (x, y)
    score: torch.Tensor   # (N,)  float32 FAST corner score
    angle: torch.Tensor   # (N,)  float32 orientation, radians
    desc: torch.Tensor    # (N,32) uint8 packed 256-bit rBRIEF
    mask: torch.Tensor    # (N,)  bool validity

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


class Matches(NamedTuple):
    """Row i of A matched to `idx[i]` of B where `mask[i]`."""
    idx: torch.Tensor       # (N,) int64 index into B
    distance: torch.Tensor  # (N,) int32 Hamming distance
    mask: torch.Tensor      # (N,) bool


class StereoObservations(NamedTuple):
    """Per-frame output of the stereo frontend: matched L/R keypoints
    with triangulated camera-frame 3D points."""
    uv_l: torch.Tensor    # (N,2)
    uv_r: torch.Tensor    # (N,2)
    xyz: torch.Tensor     # (N,3) left-camera frame
    desc: torch.Tensor    # (N,32) uint8 (left descriptors)
    mask: torch.Tensor    # (N,)
    score: torch.Tensor   # (N,) FAST corner score of the left keypoint
