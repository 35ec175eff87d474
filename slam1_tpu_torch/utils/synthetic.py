"""Synthetic stereo sequences with exact ground truth (counterpart of
`slam1_tpu/utils/synthetic.py`).

A random textured 3D landmark field rendered into a rectified stereo
pair along a known trajectory, on any torch device. The world's random
draws come from numpy (`make_world(seed=...)`), so a seed gives another
world than the JAX package's; `render_frame` renders any world —
including one exported from the JAX package through `utils/interop.py`
— with the same arithmetic as the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from slam1_tpu_torch.models.ba import BAProblem, make_problem
from slam1_tpu_torch.models.posegraph import PoseGraph
from slam1_tpu_torch.ops import se3
from slam1_tpu_torch.ops.camera import StereoCamera, project_stereo
from slam1_tpu_torch.runtime import default_device


class SyntheticWorld(NamedTuple):
    points: torch.Tensor    # (P,3)   world-frame landmarks
    patches: torch.Tensor   # (P,ps,ps) texture stamped at each landmark
    poses: torch.Tensor     # (F,4,4) GT world-from-camera (left) poses
    cam: StereoCamera


_YAW_RATE = {"straight": lambda f: 0.0, "arc": lambda f: 0.002,
             "loop": lambda f: 2.0 * np.pi / max(f - 1, 1),
             "loop2": lambda f: 4.0 * np.pi / max(f - 1, 1)}


def make_trajectory(n_frames: int, kind: str = "arc", speed: float = 1.0,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """(F,4,4) world-from-camera poses; the camera looks along +z.
    kinds: 'straight' | 'arc' | 'loop' | 'loop2' (two laps)."""
    if kind not in _YAW_RATE:
        raise ValueError(f"unknown trajectory kind: {kind}")
    device = default_device(device)
    xi = torch.tensor([0.0, 0.0, speed, 0.0, _YAW_RATE[kind](n_frames), 0.0],
                      dtype=dtype, device=device)
    step = se3.exp_se3(xi)
    poses = [torch.eye(4, dtype=dtype, device=device)]
    for _ in range(n_frames - 1):
        poses.append(poses[-1] @ step)
    return torch.stack(poses)


def make_world(seed: int = 0, n_frames: int = 64, n_points: int = 4096,
               trajectory: str = "arc", speed: float = 1.0,
               cam: StereoCamera | None = None,
               image_hw: tuple | None = None, patch_size: int = 15,
               z_range: tuple | None = None, dtype=torch.float32,
               device=None) -> SyntheticWorld:
    """Same construction as the reference's make_world (anchor frames,
    band-limited texture with a shading dipole, boosted centre), drawn
    from numpy's generator seeded with `seed`. image_hw rescales the
    camera to that canvas and narrows the default depth band."""
    device = default_device(device)
    if cam is None:
        cam = (StereoCamera.for_canvas(*image_hw, dtype, device)
               if image_hw else StereoCamera.kitti_default(dtype, device))
        if image_hw and z_range is None:
            z_range = (9.0, 34.0)
    if z_range is None:
        z_range = (6.0, 55.0)
    poses = make_trajectory(n_frames, trajectory, speed, dtype, device)
    rng = np.random.default_rng(seed)
    anchor = torch.as_tensor(rng.integers(0, n_frames, n_points),
                             device=device)
    local = torch.as_tensor(np.stack([
        rng.uniform(-18.0, 18.0, n_points),
        rng.uniform(-4.0, 3.0, n_points),
        rng.uniform(z_range[0], z_range[1], n_points),
    ], axis=-1), dtype=dtype, device=device)
    T = poses[anchor]
    pts = (T[:, :3, :3] @ local[..., None])[..., 0] + T[:, :3, 3]
    half = (patch_size + 1) // 2 + 1
    base = torch.as_tensor(rng.uniform(0.25, 1.0, (n_points, 1, half, half)),
                           dtype=dtype, device=device)
    patches = F.interpolate(base, size=(patch_size, patch_size),
                            mode="bilinear", align_corners=False)[:, 0]
    c = patch_size // 2
    ang = torch.as_tensor(rng.uniform(0.0, 2.0 * np.pi, (n_points, 1, 1)),
                          dtype=dtype, device=device)
    yy = (torch.arange(patch_size, dtype=dtype, device=device) - c) / max(c, 1)
    shade = 1.0 + 0.5 * (torch.cos(ang) * yy[None, None, :]
                         + torch.sin(ang) * yy[None, :, None])
    patches = torch.clamp(patches * shade, 0.05, 1.0)
    patches[:, c, c] = 1.0
    return SyntheticWorld(pts, patches, poses, cam)


# Stamp model of the reference renderer: a stamp covers EXT_REF px at
# depth Z_REF (scaled by the focal length, floored for small canvases),
# drawn into a (2*R_CAN+1)^2 canvas around the projected centre.
EXT_REF = 9.0
R_CAN = 9
VIS_BUDGET = 6144


def render_frame(world: SyntheticWorld, frame_idx: int, height: int,
                 width: int):
    """Render the rectified stereo pair for one frame: perspective-
    scaled bilinear stamps, max-blended. Returns (left, right) (H,W)."""
    T_wc = world.poses[frame_idx]
    X_cam = se3.transform_points(se3.inverse(T_wc), world.points)
    uv_l, uv_r, in_front = project_stereo(world.cam, X_cam)
    z = X_cam[..., 2]
    vis = in_front & (z > 2.0) & (z < 90.0)
    zc = torch.clamp(X_cam[..., 2], min=1e-3)
    patches = world.patches

    P = world.points.shape[0]
    K = min(P, VIS_BUDGET)
    if K < P:
        # Visible points first, lowest index first among ties (the
        # reference's top_k order).
        sel = torch.sort(vis.to(torch.float32), descending=True,
                         stable=True).indices[:K]
        uv_l, uv_r, vis = uv_l[sel], uv_r[sel], vis[sel]
        patches, zc = patches[sel], zc[sel]

    ps = world.patches.shape[-1]
    r = ps // 2
    dev = world.points.device
    z_ref = 18.0 * torch.clamp(world.cam.fx / 718.0, 0.8, 1.0)
    d = torch.arange(-R_CAN, R_CAN + 1, device=dev)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    pp = F.pad(patches, (1, 2, 1, 2))
    rows = torch.arange(pp.shape[0], device=dev)[:, None, None]

    def splat(uv, valid):
        cx = torch.round(uv[..., 0]).to(torch.int64)
        cy = torch.round(uv[..., 1]).to(torch.int64)
        fx_ = uv[..., 0] - cx.to(uv.dtype)
        fy_ = uv[..., 1] - cy.to(uv.dtype)
        extent = torch.clamp(EXT_REF * z_ref / zc, 2.0, 2.0 * R_CAN - 2.0)
        s = extent / ps
        ty = (oy[None] - fy_[:, None, None]) / s[:, None, None] + r
        tx = (ox[None] - fx_[:, None, None]) / s[:, None, None] + r
        iy = torch.floor(ty).to(torch.int64)
        ix = torch.floor(tx).to(torch.int64)
        wy = ty - iy
        wx = tx - ix
        inside = (ty >= 0) & (ty <= ps - 1) & (tx >= 0) & (tx <= ps - 1)
        iy1 = torch.clamp(iy + 1, 0, ps + 1)
        ix1 = torch.clamp(ix + 1, 0, ps + 1)
        v00 = pp[rows, iy1, ix1]
        v01 = pp[rows, iy1, ix1 + 1]
        v10 = pp[rows, iy1 + 1, ix1]
        v11 = pp[rows, iy1 + 1, ix1 + 1]
        vals = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
                + v10 * wy * (1 - wx) + v11 * wy * wx)
        inb = (valid & (cx >= R_CAN) & (cx < width - R_CAN)
               & (cy >= R_CAN) & (cy < height - R_CAN))
        vals = torch.where(inside & inb[:, None, None], vals,
                           torch.zeros_like(vals))
        yy = torch.clamp(cy[:, None, None] + oy[None], 0, height - 1)
        xx = torch.clamp(cx[:, None, None] + ox[None], 0, width - 1)
        img = torch.zeros(height * width, dtype=world.points.dtype,
                          device=dev)
        # max-blend: overlapping stamps stay in [0,1]; max is
        # order-independent, so the scatter is deterministic.
        img.scatter_reduce_(0, (yy * width + xx).reshape(-1),
                            vals.reshape(-1), "amax", include_self=True)
        return img.reshape(height, width)

    return splat(uv_l, vis), splat(uv_r, vis)


def render_sequence(world: SyntheticWorld, height: int, width: int):
    """(F,H,W) left and right stacks, rendered frame by frame."""
    frames = [render_frame(world, i, height, width)
              for i in range(world.poses.shape[0])]
    return (torch.stack([f[0] for f in frames]),
            torch.stack([f[1] for f in frames]))


def misaligned_copy(t, items: int = 1):
    """A contiguous copy of `t` whose first element lies `items` elements
    past the start of its allocation: contiguous, yet off the 16-byte
    boundary that vector loads need (what `x[1:]` of a larger tensor
    is)."""
    buf = torch.empty(t.numel() + items, dtype=t.dtype, device=t.device)
    view = buf[items:].view(t.shape)
    view.copy_(t)
    return view


def chain_inputs(f: int, n_live: int, seed: int):
    """Chain-sweep operands (JjInv, Ji, winv, v) shaped like a pose
    graph's, on the CPU: Ji = -(rotation blocks) of the chain adjoints,
    JjInv = I + 1e-4 noise, unit-weight edges; rows from n_live on
    decoupled (Ji = 0, JjInv = I)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    R = se3.exp_so3(0.05 * torch.randn(f, 3, generator=g))
    ji = torch.zeros(f, 6, 6)
    ji[:, :3, :3] = -R
    ji[:, 3:, 3:] = -R
    ji[:, :3, 3:] = -0.3 * R
    jj = torch.eye(6) + 1e-4 * torch.randn(f, 6, 6, generator=g)
    winv = torch.full((f,), 1.0 / (1.0 + 1e-4))
    ji[n_live:] = 0.0
    jj[n_live:] = torch.eye(6)
    winv[n_live:] = 1e4
    v = torch.randn(f, 6, generator=g)
    return jj, ji, winv, v


def loop2_graph(n: int = 600, seed: int = 4, device=None) -> PoseGraph:
    """A two-lap loop of `n` poses with noisy odometry, the drifted
    poses it chains to, and four loop edges between the laps at 1000
    times the odometry weight (a long SLAM run's pose graph in small)."""
    rng = np.random.default_rng(seed)
    gt = make_trajectory(n, "loop2", 1.0, device="cpu")
    noise = torch.as_tensor(
        rng.normal(0, [2e-3] * 3 + [2e-2] * 3, (n - 1, 6)),
        dtype=torch.float32)
    z = se3.inverse(gt[:-1]) @ gt[1:] @ se3.exp_se3(noise)
    poses = [torch.eye(4)]
    for k in range(n - 1):
        poses.append(poses[-1] @ z[k])
    li = torch.tensor([5, 60, 120, 200])
    lj = li + n // 2
    ei = torch.arange(n - 1)
    graph = PoseGraph(
        poses=torch.stack(poses), ei=torch.cat([ei, li]),
        ej=torch.cat([ei + 1, lj]),
        z=torch.cat([z, se3.inverse(gt[li]) @ gt[lj]]),
        w=torch.cat([torch.ones(n - 1), torch.full((4,), 1000.0)]))
    device = default_device(device)
    return PoseGraph(*[x.to(device) for x in graph])


def ba_problem(seed: int = 0, n_cams: int = 6, n_pts: int = 120,
               pose_noise: float = 0.02, point_noise: float = 0.05,
               px_noise: float = 0.2, n_outliers: int = 0, device=None):
    """A small stereo BA problem with ground truth: `n_cams` cameras
    moving forward with a slight yaw past `n_pts` points, every
    in-image projection observed in both cameras with `px_noise` px of
    noise, `n_outliers` observations thrown 30-80 px off, and the
    initial poses (but camera 0) and points perturbed. All draws come
    from numpy's generator seeded with `seed`. Returns (BAProblem,
    true poses (C,4,4), true points (L,3), camera)."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    cam = StereoCamera.kitti_default(device="cpu")
    step = se3.exp_se3(torch.tensor([0.0, 0.0, 1.2, 0.0, 0.01, 0.0]))
    T = [torch.eye(4)]
    for _ in range(n_cams - 1):
        T.append(T[-1] @ step)
    T_true = torch.stack(T)
    pts_true = torch.as_tensor(np.stack([
        rng.uniform(-15, 15, n_pts), rng.uniform(-4, 3, n_pts),
        rng.uniform(8, 50, n_pts)], -1), dtype=torch.float32)

    cam_idx, lm_idx, uvs, urs = [], [], [], []
    for c in range(n_cams):
        Xc = se3.transform_points(se3.inverse(T_true[c]), pts_true)
        uv_l, uv_r, front = project_stereo(cam, Xc)
        inb = (front & (uv_l[:, 0] > 0) & (uv_l[:, 0] < 1226)
               & (uv_l[:, 1] > 0) & (uv_l[:, 1] < 370))
        sel = torch.nonzero(inb)[:, 0]
        cam_idx.append(torch.full_like(sel, c))
        lm_idx.append(sel)
        uvs.append(uv_l[sel])
        urs.append(uv_r[sel, 0])
    cam_idx, lm_idx = torch.cat(cam_idx), torch.cat(lm_idx)
    uvs, urs = torch.cat(uvs).numpy(), torch.cat(urs).numpy()
    uvs = uvs + rng.normal(0, px_noise, uvs.shape).astype(np.float32)
    urs = urs + rng.normal(0, px_noise, urs.shape).astype(np.float32)
    if n_outliers:
        sel = rng.choice(len(uvs), n_outliers, replace=False)
        uvs[sel] += rng.uniform(30, 80, (n_outliers, 2)).astype(np.float32)
        urs[sel] += rng.uniform(30, 80, n_outliers).astype(np.float32)
    dpose = rng.normal(0, pose_noise, (n_cams, 6)).astype(np.float32)
    dpose[0] = 0
    T_init = T_true @ se3.exp_se3(torch.as_tensor(dpose))
    pts_init = pts_true + torch.as_tensor(
        rng.normal(0, point_noise, (n_pts, 3)).astype(np.float32))
    w = torch.ones(len(uvs))
    prob = make_problem(poses=T_init, points=pts_init, cam_idx=cam_idx,
                        lm_idx=lm_idx, uv=torch.as_tensor(uvs), w=w,
                        ur=torch.as_tensor(urs), wr=w.clone())
    return (BAProblem(*[x.to(device) for x in prob]), T_true.to(device),
            pts_true.to(device), cam.to(device))
