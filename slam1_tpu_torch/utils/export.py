"""Interchange exports: KITTI trajectory format and BAL problem files
(counterpart of `slam1_tpu/utils/export.py`), so external tools (the
KITTI devkit, Ceres/BAL consumers) read what the port writes.
`models/bal.py` reads the problems `load_bal` returns.
"""

from __future__ import annotations

import numpy as np
import torch

from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.utils.metrics import traced


def save_kitti_poses(path: str, poses: np.ndarray) -> str:
    """(N,4,4) -> KITTI odometry 12-number rows."""
    rows = np.asarray(poses)[:, :3, :4].reshape(len(poses), 12)
    np.savetxt(path, rows, fmt="%.9e")
    return path


def load_kitti_poses(path: str) -> np.ndarray:
    from slam1_tpu_torch.utils.kitti import load_poses
    return load_poses(path)


def save_bal(path: str, poses, points, cam_idx, lm_idx, uv, w,
             fx: float, cx: float, cy: float) -> str:
    """Write a BAL-format problem (http://grail.cs.washington.edu/projects/bal/):

        n_cams n_points n_obs
        cam_idx point_idx u v        (principal-point-centred)
        ... 9 params per camera (rvec, tvec, f, k1, k2) ...
        ... 3 coords per point ...
    """
    poses = np.asarray(poses)
    points = np.asarray(points)
    keep = np.asarray(w) > 0
    cam_idx = np.asarray(cam_idx)[keep]
    lm_idx = np.asarray(lm_idx)[keep]
    uv = np.asarray(uv)[keep]

    # BAL cameras are world-to-camera with P = R X + t.
    T_cw = np.linalg.inv(poses)
    rvecs = se3.log_so3(torch.as_tensor(T_cw[:, :3, :3],
                                        dtype=torch.float32)).numpy()
    tvecs = T_cw[:, :3, 3]

    with open(path, "w") as f:
        f.write(f"{len(poses)} {len(points)} {len(uv)}\n")
        for c, l, (u, v) in zip(cam_idx, lm_idx, uv):
            f.write(f"{int(c)} {int(l)} {u - cx:.6f} {v - cy:.6f}\n")
        for rv, tv in zip(rvecs, tvecs):
            for val in (*rv, *tv, fx, 0.0, 0.0):
                f.write(f"{val:.12e}\n")
        for p in points:
            for val in p:
                f.write(f"{val:.12e}\n")
    return path


def write_bal(path: str, cams, points, cam_idx, lm_idx, uv) -> str:
    """Write a BAL problem in BAL's own cameras (C,9) [rvec, t, f, k1, k2],
    points (L,3) and principal-point-centred observations (O,2) of
    cameras cam_idx and points lm_idx, as `load_bal` reads it."""
    obs = np.column_stack([np.asarray(cam_idx), np.asarray(lm_idx),
                           np.asarray(uv, np.float64)])
    with open(path, "w") as f:
        f.write(f"{len(cams)} {len(points)} {len(obs)}\n")
        np.savetxt(f, obs, fmt=["%d", "%d", "%.17g", "%.17g"])
        np.savetxt(f, np.asarray(cams, np.float64).reshape(-1, 1),
                   fmt="%.17g")
        np.savetxt(f, np.asarray(points, np.float64).reshape(-1, 1),
                   fmt="%.17g")
    return path


@traced("host:bal.load")
def load_bal(path: str):
    """Read a BAL file -> dict of arrays (cam_idx, lm_idx int32; uv,
    cameras (C,9), points (L,3) float64), numpy in bulk: the header, the
    observation lines, then one value a line (any whitespace). Each call
    is the span `host:bal.load` (`utils/metrics.py`)."""
    with open(path) as f:
        n_cams, n_pts, n_obs = map(int, f.readline().split())
        vals = np.fromstring(f.read(), dtype=np.float64, sep=" ")
    need = 4 * n_obs + 9 * n_cams + 3 * n_pts
    if vals.size < need:
        raise ValueError(f"{path}: {vals.size} values after the header, "
                         f"{need} expected")
    obs = vals[:4 * n_obs].reshape(n_obs, 4)
    cams = vals[4 * n_obs:4 * n_obs + 9 * n_cams]
    pts = vals[4 * n_obs + 9 * n_cams:need]
    return {
        "cam_idx": obs[:, 0].astype(np.int32),
        "lm_idx": obs[:, 1].astype(np.int32),
        "uv": np.ascontiguousarray(obs[:, 2:]),
        "cameras": cams.reshape(n_cams, 9),
        "points": pts.reshape(n_pts, 3),
    }
