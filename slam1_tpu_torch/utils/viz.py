"""Offline trajectory / map visualization (counterpart of
`slam1_tpu/utils/viz.py`): GT-vs-estimate trajectory overlay, per-frame
metric curves and a top-down map scatter, written to files with
matplotlib, which is imported only when a plot is made.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_trajectories(est: np.ndarray, gt: Optional[np.ndarray],
                      out_path: str, title: str = "trajectory",
                      corrected: Optional[np.ndarray] = None) -> str:
    """Top-down (x,z) overlay, the GTvsPOSE/sl.m view."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    if gt is not None:
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "k-", lw=1.5, label="ground truth")
    ax.plot(est[:, 0, 3], est[:, 2, 3], "r-", lw=1.0, label="estimate")
    if corrected is not None:
        ax.plot(corrected[:, 0, 3], corrected[:, 2, 3], "b--", lw=1.0,
                label="optimized")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_metrics(metrics: list, out_path: str) -> str:
    """Per-frame inlier counts / reprojection error curves."""
    plt = _plt()
    inl = [int(m.num_inliers) for m in metrics]
    err = [float(m.mean_reproj_err) for m in metrics]
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    a1.plot(inl)
    a1.set_ylabel("PnP inliers")
    a2.plot(err)
    a2.set_ylabel("mean reproj err [px]")
    a2.set_xlabel("frame")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_map(points: np.ndarray, valid: np.ndarray, poses: np.ndarray,
             out_path: str, max_points: int = 20000) -> str:
    """Top-down landmark scatter with the trajectory (points3d.m view),
    with simple percentile outlier trimming (its rmoutliers)."""
    plt = _plt()
    pts = points[valid]
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(len(pts), max_points,
                                                  replace=False)]
    if len(pts):
        lo, hi = np.percentile(pts, [1, 99], axis=0)
        keep = ((pts >= lo) & (pts <= hi)).all(axis=1)
        pts = pts[keep]
    fig, ax = plt.subplots(figsize=(9, 9))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=0.5, c=pts[:, 1], cmap="viridis")
    ax.plot(poses[:, 0, 3], poses[:, 2, 3], "r-", lw=1.2)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
