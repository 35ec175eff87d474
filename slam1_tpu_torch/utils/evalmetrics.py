"""Trajectory evaluation: ATE / RPE — a numpy copy of
`slam1_tpu/utils/evalmetrics.py` (that module is numpy-only, but
importing it runs the JAX package's `__init__`); tests pin the copies
equal."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est_xyz: np.ndarray, gt_xyz: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity transform aligning est -> gt.

    Returns (s, R, t) with gt ~= s * R @ est + t.
    """
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    cov = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE (metres) over (N,4,4) pose arrays."""
    est = np.asarray(est_poses)[:, :3, 3]
    gt = np.asarray(gt_poses)[:, :3, 3]
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align and n >= 3:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over frame gap `delta`.

    Returns (trans_rmse_m, rot_rmse_deg).
    """
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    n = min(len(est), len(gt))
    if n <= delta:
        return 0.0, 0.0
    t_errs, r_errs = [], []
    for i in range(n - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        r_errs.append(np.degrees(np.arccos(c)))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))


def final_pose_diff(est_poses: np.ndarray, gt_poses: np.ndarray):
    """The reference's own end-of-run check (main.py:143-146):
    absolute difference of the final pose translation vs GT."""
    return np.abs(np.asarray(est_poses)[-1][:3, 3]
                  - np.asarray(gt_poses)[len(est_poses) - 1][:3, 3])
