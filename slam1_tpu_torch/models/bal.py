"""BAL-style full bundle adjustment with 9-parameter cameras
(counterpart of `slam1_tpu/models/bal.py`).

The problem type of the public BAL datasets and its projection. Its
solver is the port's one bundle adjustment, `models/ba.bundle_adjust`
with the camera model `ba.BAL`: the same landmark-elimination Schur LM,
block-Jacobi PCG and CUDA graphs as the stereo rig's CG path, with
9-dof camera blocks [rvec(3), tvec(3), f, k1, k2], so focal length and
radial distortion are refined jointly with geometry. The live backend
holds the intrinsics of its calibrated, rectified rig fixed; this model
is for BAL-format datasets (`utils/export.load_bal`), where they are
per-camera unknowns.

Camera model, the public BAL convention (Agarwal et al., "Bundle
Adjustment in the Large"; `ops/bal_obs.py`):

    P  = R(rvec) @ X + t          world -> camera, axis-angle rotation
    p  = -(P.x, P.y) / P.z        the camera looks down -z
    uv = f * (1 + k1 |p|^2 + k2 |p|^4) * p
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from slam1_tpu_torch.config import BAConfig
from slam1_tpu_torch.models import ba
from slam1_tpu_torch.ops import bal_obs
from slam1_tpu_torch.runtime import default_device

project = bal_obs.project


class BalProblem(NamedTuple):
    cams: torch.Tensor     # (C,9) [rvec(3), tvec(3), f, k1, k2]
    points: torch.Tensor   # (L,3) world landmarks
    cam_idx: torch.Tensor  # (O,) int64
    lm_idx: torch.Tensor   # (O,) int64
    uv: torch.Tensor       # (O,2) principal-point-centred observations
    w: torch.Tensor        # (O,) observation weight; 0 = padding


def from_bal_dict(d, device=None) -> BalProblem:
    """Build a problem from a loaded BAL file's dict (cameras, points,
    cam_idx, lm_idx, uv)."""
    device = default_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BalProblem(
        cams=t(d["cameras"], torch.float32),
        points=t(d["points"], torch.float32),
        cam_idx=t(d["cam_idx"], torch.int64),
        lm_idx=t(d["lm_idx"], torch.int64),
        uv=t(d["uv"], torch.float32),
        w=torch.ones(len(d["cam_idx"]), dtype=torch.float32, device=device))


def _cost(problem: BalProblem, huber_delta: float):
    """(Huber cost (), residuals (O,2), Huber weights (O,))."""
    return bal_obs.huber_cost(problem, huber_delta)


def bal_adjust(problem: BalProblem, cfg: BAConfig,
               graphs: bool = True) -> Tuple[BalProblem, torch.Tensor]:
    """Full 9-parameter LM bundle adjustment (cameras with f, k1, k2 and
    points all free): `ba.bundle_adjust` with the camera model `ba.BAL`.
    Returns (optimised problem, final cost ()).

    Parameter scales differ wildly (rvec ~1, f ~500): handled by the
    multiplicative damping lam * diag(H) and the block-Jacobi CG
    preconditioner, not by column normalisation."""
    return ba.bundle_adjust(problem, (), cfg, graphs=graphs, model=ba.BAL)
