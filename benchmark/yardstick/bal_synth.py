"""A BAL problem at a published problem's sizes, made from a seed on the
card (no BAL file is in the repository): the cameras, points and
observations of `configs/bal-venice.json`, with BAL's camera model
(Agarwal et al., "Bundle Adjustment in the Large", ECCV 2010):

    P = R(w) X + t,  p = -(P_x, P_y) / P_z,  uv = f (1 + k1 |p|^2 + k2 |p|^4) p

The scene (`scene` in the configuration; every value is listed under its
`assumed`): a landmark building, a cylinder of facades, ringed by the
photographers of an Internet photo collection. Camera c stands at angle
2 pi (c + u_c) / C around the building's axis (u_c uniform in [0, 1),
so the cameras are in angle order), at a distance log-uniform over
`camera_distance_m`, a height uniform over `camera_height_m`, and looks
at a point of the axis at a height uniform over `aim_height_m`, turned
by a yaw and a roll uniform within `aim_jitter_rad`; f is log-uniform
over `focal_px`, k1 and k2 uniform over `k1`, `k2`. A point lies on the
facades: at an angle uniform around the axis, a radius uniform over
`facade_radius_m` and a height uniform over `facade_height_m`.

Track lengths: one histogram, the same for every seed (`track_counts`):
at least 2, a power law k^-a up to `track_max`, a set to give the mean
O / L, the counts rounded and then moved between lengths 2 and 3 so that
they hold exactly L points and O observations. Only which cameras see
which point varies with the seed: the point's k cameras are drawn
without repetition from the `track_window` cameras nearest it in angle,
all of which face its side of the building.

Observations are ordered by point and, within a point, by camera, as
BAL's files are. Each coordinate gets Gaussian noise of `noise_px`; a
share `outlier_share` of the observations, drawn from all of them, is
moved `outlier_px` pixels in a random direction. The start: each
camera's rotation, translation, f, k1 and k2 and each point moved by the
`start` perturbations (Gaussian; f's relative).

Everything is drawn in float64 on `device` from a generator seeded with
the run's seed, so the same seed gives the same problem on one kind of
device; the problem is handed over in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

CHUNK = 1 << 17            # points whose tracks are drawn at once


class Problem(NamedTuple):
    cams: torch.Tensor     # (C,9) float32 [w, t, f, k1, k2], the start
    points: torch.Tensor   # (L,3) float32, the start
    cam_idx: torch.Tensor  # (O,) int64
    lm_idx: torch.Tensor   # (O,) int64
    uv: torch.Tensor       # (O,2) float32 observed, about the centre
    w: torch.Tensor        # (O,) float32 ones
    true_cams: torch.Tensor    # (C,9) float64
    true_points: torch.Tensor  # (L,3) float64


def track_counts(n_points: int, n_obs: int, k_max: int) -> np.ndarray:
    """Points by track length 0..k_max (int64): the power law of mean
    n_obs / n_points over lengths 2..k_max, rounded, then made to hold
    exactly n_points points and n_obs observations."""
    ks = np.arange(2, k_max + 1, dtype=np.float64)
    target = n_obs / n_points
    lo, hi = 0.0, 8.0
    for _ in range(200):
        a = 0.5 * (lo + hi)
        p = ks ** -a
        p /= p.sum()
        if float((ks * p).sum()) > target:
            lo = a
        else:
            hi = a
    counts = np.zeros(k_max + 1, dtype=np.int64)
    counts[2:] = np.round(n_points * p).astype(np.int64)
    counts[2] += n_points - counts.sum()
    extra = n_obs - int((np.arange(k_max + 1) * counts).sum())
    # Each point moved from length 2 to 3 adds one observation.
    counts[2] -= extra
    counts[3] += extra
    if counts.min() < 0:
        raise ValueError("track_counts: the sizes admit no such histogram")
    return counts


def _rotation(w):
    """Rodrigues, float64: (...,3) -> (...,3,3)."""
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    t = torch.sqrt(torch.clamp(t2, min=1e-300))
    K = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    tiny = t2 < 1e-12
    a = torch.where(tiny, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(tiny, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def _log(R):
    """The axis-angle vector (angle in [0, pi]) of rotations R (...,3,3),
    float64, through the unit quaternion (Shepperd's choice of its
    largest component): exact at every angle, pi included."""
    r = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = r[0][0] + r[1][1] + r[2][2]
    cands = torch.stack([tr, r[0][0], r[1][1], r[2][2]], -1)
    pick = torch.argmax(cands, dim=-1)
    qs = []
    big = 0.5 * torch.sqrt(torch.clamp(1 + tr, min=0.0))
    qs.append(torch.stack([big, (r[2][1] - r[1][2]) / (4 * big),
                           (r[0][2] - r[2][0]) / (4 * big),
                           (r[1][0] - r[0][1]) / (4 * big)], -1))
    big = 0.5 * torch.sqrt(torch.clamp(1 + r[0][0] - r[1][1] - r[2][2],
                                       min=0.0))
    qs.append(torch.stack([(r[2][1] - r[1][2]) / (4 * big), big,
                           (r[0][1] + r[1][0]) / (4 * big),
                           (r[0][2] + r[2][0]) / (4 * big)], -1))
    big = 0.5 * torch.sqrt(torch.clamp(1 - r[0][0] + r[1][1] - r[2][2],
                                       min=0.0))
    qs.append(torch.stack([(r[0][2] - r[2][0]) / (4 * big),
                           (r[0][1] + r[1][0]) / (4 * big), big,
                           (r[1][2] + r[2][1]) / (4 * big)], -1))
    big = 0.5 * torch.sqrt(torch.clamp(1 - r[0][0] - r[1][1] + r[2][2],
                                       min=0.0))
    qs.append(torch.stack([(r[1][0] - r[0][1]) / (4 * big),
                           (r[0][2] + r[2][0]) / (4 * big),
                           (r[1][2] + r[2][1]) / (4 * big), big], -1))
    q = torch.gather(torch.stack(qs, -2), -2,
                     pick[..., None, None].expand(*pick.shape, 1, 4))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    n = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2 * torch.atan2(n, q[..., :1])
    scale = torch.where(n > 1e-12, angle / torch.clamp(n, min=1e-300),
                        torch.full_like(n, 2.0))
    return q[..., 1:] * scale


def project(cams, X):
    """BAL's projection, float64: cams (O,9), X (O,3) -> (O,2)."""
    P = (_rotation(cams[:, :3]) @ X[:, :, None])[:, :, 0] + cams[:, 3:6]
    p = -P[:, :2] / P[:, 2:3]
    r2 = torch.sum(p * p, dim=-1)
    return (cams[:, 6] * (1 + cams[:, 7] * r2 + cams[:, 8] * r2 * r2))[:, None] * p


def make(seed: int, config: dict, device) -> Problem:
    """The configuration's problem from `seed` on `device`."""
    sc = config["scene"]
    C, L, O = config["cameras"], config["points"], config["observations"]
    g = torch.Generator(device=device).manual_seed(int(seed))
    f64 = torch.float64

    def u(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, dtype=f64,
                                           device=device)

    def logu(n, lo, hi):
        return torch.exp(u(n, math.log(lo), math.log(hi)))

    def gauss(*shape):
        return torch.randn(*shape, generator=g, dtype=f64, device=device)

    # Cameras, in angle order around the axis.
    ang = 2 * math.pi * (torch.arange(C, dtype=f64, device=device)
                         + u(C, 0.0, 1.0)) / C
    dist = logu(C, *sc["camera_distance_m"])
    centre = torch.stack([dist * torch.cos(ang), dist * torch.sin(ang),
                          u(C, *sc["camera_height_m"])], -1)
    aim = torch.zeros_like(centre)
    aim[:, 2] = u(C, *sc["aim_height_m"])
    back = centre - aim                       # BAL's camera looks down -z
    z_ax = back / torch.linalg.norm(back, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=f64, device=device).expand_as(
        z_ax)
    x_ax = torch.linalg.cross(up, z_ax)
    x_ax = x_ax / torch.linalg.norm(x_ax, dim=-1, keepdim=True)
    y_ax = torch.linalg.cross(z_ax, x_ax)
    R = torch.stack([x_ax, y_ax, z_ax], -2)   # world -> camera rows
    jit = sc["aim_jitter_rad"]
    turn = torch.zeros((C, 3), dtype=f64, device=device)
    turn[:, 1] = u(C, -jit, jit)              # yaw about the camera's y
    turn[:, 2] = u(C, -jit, jit)              # roll about its z
    R = _rotation(turn) @ R
    t = -(R @ centre[:, :, None])[:, :, 0]
    cams = torch.cat([_log(R), t, logu(C, *sc["focal_px"])[:, None],
                      u(C, *sc["k1"])[:, None], u(C, *sc["k2"])[:, None]],
                     -1)

    # Points on the facades.
    p_ang = u(L, 0.0, 2 * math.pi)
    rad = u(L, *sc["facade_radius_m"])
    pts = torch.stack([rad * torch.cos(p_ang), rad * torch.sin(p_ang),
                       u(L, *sc["facade_height_m"])], -1)

    # Track lengths: the fixed histogram, assigned to the points in a
    # seeded order.
    counts = torch.as_tensor(track_counts(L, O, sc["track_max"]),
                             device=device)
    k = torch.repeat_interleave(torch.arange(counts.shape[0],
                                             device=device), counts)
    k = k[torch.randperm(L, generator=g, device=device)]
    # The k cameras of each point: the first k of a random order of the
    # `track_window` cameras nearest it in angle.
    win = sc["track_window"]
    first = torch.floor(p_ang / (2 * math.pi) * C).long() - win // 2
    ci_parts, li_parts = [], []
    for s in range(0, L, CHUNK):
        e = min(L, s + CHUNK)
        keys = torch.rand((e - s, win), generator=g, device=device)
        pick = torch.argsort(keys, dim=1)
        take = torch.arange(win, device=device)[None, :] < k[s:e, None]
        cam = (first[s:e, None] + pick) % C
        ci_parts.append(cam[take])
        li_parts.append(torch.arange(s, e, device=device)[:, None]
                        .expand(-1, win)[take])
    ci, li = torch.cat(ci_parts), torch.cat(li_parts)
    order = torch.argsort(li * C + ci)        # by point, then camera
    ci, li = ci[order], li[order]

    uv = project(cams[ci], pts[li]) + sc["noise_px"] * gauss(O, 2)
    n_out = int(round(sc["outlier_share"] * O))
    bad = torch.randperm(O, generator=g, device=device)[:n_out]
    kick = gauss(n_out, 2)
    kick = kick / torch.linalg.norm(kick, dim=-1, keepdim=True)
    uv[bad] += kick * u(n_out, *sc["outlier_px"])[:, None]

    st = sc["start"]
    start = cams.clone()
    start[:, :3] = _log(_rotation(st["rotation_rad"] * gauss(C, 3))
                        @ _rotation(cams[:, :3]))
    start[:, 3:6] += st["translation_m"] * gauss(C, 3)
    start[:, 6] *= 1 + st["focal_rel"] * gauss(C)
    start[:, 7] += st["k1"] * gauss(C)
    start[:, 8] += st["k2"] * gauss(C)
    points = pts + st["point_m"] * gauss(L, 3)
    return Problem(start.float(), points.float(), ci, li, uv.float(),
                   torch.ones(O, dtype=torch.float32, device=device),
                   cams, pts)
