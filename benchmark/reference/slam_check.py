"""What a SLAM run is held to: the camera's ground-truth motion.

The frames are rendered from the drive's poses, which the generator
makes in closed form in float64, so the reference answer of "where was
the camera" is known exactly. A SLAM system estimates it with an error,
and the numbers here say how large, in float64 on the CPU:

- `rpe_max_m`: the widest gap, over every frame of the session, between
  the estimated motion from frame f - 1 to frame f (inv(T_{f-1}) T_f of
  the trajectory as it stands after the window, local BA's and the pose
  graph's write-backs included) and the true one, in translation;
- `loop_gap_max_m`: the widest gap between an accepted loop edge's
  measured relative pose and the true one between its two frames, in
  translation (0 where no edge was accepted; on a drive that never
  revisits, an accepted edge is a false closure and reads the distance
  between the two places);
- `ate_m`: the trajectory's RMS translation error against the truth,
  with no alignment (both start at the identity).
"""

from __future__ import annotations

import numpy as np


def _inv(T):
    R = np.swapaxes(T[..., :3, :3], -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = R
    out[..., :3, 3] = -(R @ T[..., :3, 3:])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def rpe(traj, truth):
    """(F-1,) per-frame motion gaps (m) of traj (F,4,4) against truth:
    entry f - 1 is frame f's."""
    est = _inv(traj[:-1]) @ traj[1:]
    ref = _inv(truth[:-1]) @ truth[1:]
    return np.linalg.norm(est[:, :3, 3] - ref[:, :3, 3], axis=-1)


def worst_frames(traj, truth, k: int = 3):
    """The k frames of the widest motion gaps, [(frame, gap m)]."""
    gaps = rpe(np.asarray(traj, np.float64), np.asarray(truth, np.float64))
    idx = np.argsort(gaps)[::-1][:k]
    return [(int(i) + 1, float(gaps[i])) for i in idx]


def loop_gap_max(edges, truth):
    """Widest translation gap (m) of edges [(i, j, Z (4,4))] against the
    true T_i^-1 T_j; 0 without an edge."""
    if not edges:
        return 0.0
    gaps = [np.linalg.norm(np.asarray(Z, np.float64)[:3, 3]
                           - (_inv(truth[i]) @ truth[j])[:3, 3])
            for i, j, Z in edges]
    return float(np.max(gaps))


def ate(traj, truth):
    return float(np.sqrt(np.mean(np.sum(
        (traj[:, :3, 3] - truth[:, :3, 3]) ** 2, axis=-1))))


def check(sessions):
    """sessions: [(traj (F,4,4), truth (F,4,4), edges)] -> the numbers,
    each the worst over the sessions."""
    out = {"rpe_max_m": 0.0, "loop_gap_max_m": 0.0, "ate_m": 0.0}
    for traj, truth, edges in sessions:
        traj = np.asarray(traj, np.float64)
        truth = np.asarray(truth, np.float64)[:traj.shape[0]]
        out["rpe_max_m"] = max(out["rpe_max_m"],
                               float(np.max(rpe(traj, truth))))
        out["loop_gap_max_m"] = max(out["loop_gap_max_m"],
                                    loop_gap_max(edges, truth))
        out["ate_m"] = max(out["ate_m"], ate(traj, truth))
    return out
