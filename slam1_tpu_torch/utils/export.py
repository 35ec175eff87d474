"""Interchange exports: KITTI trajectory format and BAL problem files
(counterpart of `slam1_tpu/utils/export.py`), so external tools (the
KITTI devkit, Ceres/BAL consumers) read what the port writes.
`models/bal.py` reads the problems `load_bal` returns.
"""

from __future__ import annotations

import numpy as np
import torch

from slam1_tpu_torch.ops import se3


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


def load_bal(path: str):
    """Read a BAL file -> dict of arrays."""
    with open(path) as f:
        n_cams, n_pts, n_obs = map(int, f.readline().split())
        cam_idx = np.empty(n_obs, np.int32)
        lm_idx = np.empty(n_obs, np.int32)
        uv = np.empty((n_obs, 2), np.float64)
        for i in range(n_obs):
            c, l, u, v = f.readline().split()
            cam_idx[i], lm_idx[i] = int(c), int(l)
            uv[i] = (float(u), float(v))
        cams = np.array([float(f.readline()) for _ in range(9 * n_cams)])
        pts = np.array([float(f.readline()) for _ in range(3 * n_pts)])
    return {
        "cam_idx": cam_idx, "lm_idx": lm_idx, "uv": uv,
        "cameras": cams.reshape(n_cams, 9),
        "points": pts.reshape(n_pts, 3),
    }
