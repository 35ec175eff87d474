"""The benchmark's inputs, made from the seed: a frozen copy of the
port's synthetic generator (`slam1_tpu_torch/utils/synthetic.py`:
`make_world`, `make_trajectory`, `render_frame`) with the benchmark's
own global BA problem added.

- `drive`: the camera's ground-truth poses, in closed form in float64.
  A trajectory of the port's kinds is `step ** k` for one step twist, so
  pose k is `exp_se3(k * xi)`: no chained round-off, and the same poses
  the port's `make_trajectory` chains (`arc`: 0.002 rad of yaw a frame,
  which never revisits within 3000 frames; `loop2`: the port's two-lap
  loop of `n` frames).
- `make_world`, `render_frames`: the port's landmark field and renderer
  (vectorised over frames), the same draws in the same order from
  numpy's generator. Each landmark is anchored to a frame drawn
  uniformly over the drive, so the world grows along the path; `render`
  can store the frames as 8-bit levels, as a camera delivers them.
- `ba_problem`: a global bundle adjustment over the keyframes of a
  drive, observing the world's points.

Nothing here imports the program: the harness turns these tensors into
the program's types, and the references read them as they are.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.yardstick import se3


class Camera(NamedTuple):
    """Rectified stereo rig (pixels, metres)."""
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float


class World(NamedTuple):
    points: torch.Tensor    # (P,3) float32 world landmarks
    patches: torch.Tensor   # (P,ps,ps) float32 texture of each landmark
    poses: torch.Tensor     # (F,4,4) float32 world-from-camera, rendered
    cam: Camera


def camera(cfg: dict) -> Camera:
    c = cfg["camera"]
    return Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["baseline"])


def drive(kind: str, n_frames: int, speed: float = 1.0) -> torch.Tensor:
    """(F,4,4) float64 ground-truth poses on the CPU; the camera looks
    along +z and yaws about y. kinds, as the port's make_trajectory:
    'straight', 'arc' (0.002 rad a frame), 'loop2' (two laps over the n
    frames)."""
    if kind == "straight":
        yaw = 0.0
    elif kind == "arc":
        yaw = 0.002
    elif kind == "loop2":
        yaw = 4.0 * np.pi / max(n_frames - 1, 1)
    else:
        raise ValueError(f"unknown drive kind: {kind}")
    k = torch.arange(n_frames, dtype=torch.float64)[:, None]
    xi = torch.tensor([0.0, 0.0, speed, 0.0, yaw, 0.0], dtype=torch.float64)
    return se3.exp_se3(k * xi)


def make_world(seed: int, poses: torch.Tensor, n_points: int, cam: Camera,
               patch_size: int = 15, z_range=(6.0, 55.0),
               device="cpu") -> World:
    """The port's make_world over given ground-truth poses: each landmark
    anchored to a frame drawn uniformly, placed in that camera's frustum
    band, with a band-limited texture, a shading dipole and a boosted
    centre. All draws come from numpy's generator seeded with `seed`."""
    n_frames = poses.shape[0]
    dt = torch.float32
    rng = np.random.default_rng(seed)
    anchor = torch.as_tensor(rng.integers(0, n_frames, n_points))
    local = torch.as_tensor(np.stack([
        rng.uniform(-18.0, 18.0, n_points),
        rng.uniform(-4.0, 3.0, n_points),
        rng.uniform(z_range[0], z_range[1], n_points),
    ], axis=-1), dtype=torch.float64)
    T = poses[anchor]
    pts = ((T[:, :3, :3] @ local[..., None])[..., 0] + T[:, :3, 3]).to(dt)
    half = (patch_size + 1) // 2 + 1
    base = torch.as_tensor(rng.uniform(0.25, 1.0, (n_points, 1, half, half)),
                           dtype=dt)
    patches = F.interpolate(base, size=(patch_size, patch_size),
                            mode="bilinear", align_corners=False)[:, 0]
    c = patch_size // 2
    ang = torch.as_tensor(rng.uniform(0.0, 2.0 * np.pi, (n_points, 1, 1)),
                          dtype=dt)
    yy = (torch.arange(patch_size, dtype=dt) - c) / max(c, 1)
    shade = 1.0 + 0.5 * (torch.cos(ang) * yy[None, None, :]
                         + torch.sin(ang) * yy[None, :, None])
    patches = torch.clamp(patches * shade, 0.05, 1.0)
    patches[:, c, c] = 1.0
    return World(pts.to(device), patches.to(device), poses.to(dt).to(device),
                 cam)


# The port's stamp model: a stamp covers EXT_REF px at depth Z_REF
# (scaled by the focal length), drawn into a (2 R_CAN + 1)^2 canvas
# around the projected centre; at most VIS_BUDGET landmarks a frame.
EXT_REF = 9.0
R_CAN = 9
VIS_BUDGET = 6144


def project_stereo(cam: Camera, X):
    """Camera-frame points (...,3) -> (uv_left, uv_right, valid)."""
    def project(Xc):
        z = Xc[..., 2]
        valid = z > 1e-6
        zs = torch.where(valid, z, torch.ones_like(z))
        return torch.stack([cam.fx * Xc[..., 0] / zs + cam.cx,
                            cam.fy * Xc[..., 1] / zs + cam.cy], -1), valid
    uv_l, ok_l = project(X)
    uv_r, ok_r = project(torch.cat([X[..., :1] - cam.baseline, X[..., 1:]],
                                   dim=-1))
    return uv_l, uv_r, ok_l & ok_r


def render_frames(world: World, idx, height: int, width: int):
    """The rectified stereo pairs of frames `idx` (B,), as (B,H,W)
    float32 left and right stacks: perspective-scaled bilinear stamps,
    max-blended. The port's render_frame, vectorised over frames: each
    frame's image is the same whatever else is in the batch."""
    T_wc = world.poses[idx]                                   # (B,4,4)
    X_cam = se3.transform_points(se3.inverse(T_wc), world.points[None])
    uv_l, uv_r, in_front = project_stereo(world.cam, X_cam)   # (B,P,.)
    z = X_cam[..., 2]
    vis = in_front & (z > 2.0) & (z < 90.0)
    zc = torch.clamp(z, min=1e-3)
    B, P = vis.shape
    K = min(P, VIS_BUDGET)
    # Visible landmarks first, lowest index first among ties.
    sel = torch.sort(vis.to(torch.float32), dim=1, descending=True,
                     stable=True).indices[:, :K]              # (B,K)
    uv_l = torch.gather(uv_l, 1, sel[..., None].expand(B, K, 2))
    uv_r = torch.gather(uv_r, 1, sel[..., None].expand(B, K, 2))
    vis = torch.gather(vis, 1, sel)
    zc = torch.gather(zc, 1, sel)
    ps = world.patches.shape[-1]
    r = ps // 2
    dev = world.points.device
    z_ref = 18.0 * min(max(world.cam.fx / 718.0, 0.8), 1.0)
    d = torch.arange(-R_CAN, R_CAN + 1, device=dev)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    pp = F.pad(world.patches, (1, 2, 1, 2))                   # (P,ps+3,.)
    rows = sel[..., None, None]                               # (B,K,1,1)
    base = (torch.arange(B, device=dev) * (height * width))[:, None, None,
                                                            None]

    def splat(uv, valid):
        cx = torch.round(uv[..., 0]).to(torch.int64)
        cy = torch.round(uv[..., 1]).to(torch.int64)
        fx_ = uv[..., 0] - cx.to(uv.dtype)
        fy_ = uv[..., 1] - cy.to(uv.dtype)
        extent = torch.clamp(EXT_REF * z_ref / zc, 2.0, 2.0 * R_CAN - 2.0)
        s = (extent / ps)[..., None, None]
        ty = (oy - fy_[..., None, None]) / s + r
        tx = (ox - fx_[..., None, None]) / s + r
        iy = torch.floor(ty).to(torch.int64)
        ix = torch.floor(tx).to(torch.int64)
        wy = ty - iy
        wx = tx - ix
        inside = (ty >= 0) & (ty <= ps - 1) & (tx >= 0) & (tx <= ps - 1)
        iy1 = torch.clamp(iy + 1, 0, ps + 1)
        ix1 = torch.clamp(ix + 1, 0, ps + 1)
        vals = (pp[rows, iy1, ix1] * (1 - wy) * (1 - wx)
                + pp[rows, iy1, ix1 + 1] * (1 - wy) * wx
                + pp[rows, iy1 + 1, ix1] * wy * (1 - wx)
                + pp[rows, iy1 + 1, ix1 + 1] * wy * wx)
        inb = (valid & (cx >= R_CAN) & (cx < width - R_CAN)
               & (cy >= R_CAN) & (cy < height - R_CAN))
        vals = torch.where(inside & inb[..., None, None], vals,
                           torch.zeros_like(vals))
        yy = torch.clamp(cy[..., None, None] + oy, 0, height - 1)
        xx = torch.clamp(cx[..., None, None] + ox, 0, width - 1)
        img = torch.zeros(B * height * width, dtype=world.points.dtype,
                          device=dev)
        # Max-blend: order-independent, so the scatter is deterministic.
        img.scatter_reduce_(0, (base + yy * width + xx).reshape(-1),
                            vals.reshape(-1), "amax", include_self=True)
        return img.reshape(B, height, width)

    return splat(uv_l, vis), splat(uv_r, vis)


def render(world: World, n_frames: int, height: int, width: int,
           batch: int = 8, dtype=torch.float32):
    """Frames [0, n_frames) as (F,H,W) left / right stacks on the world's
    device, rendered `batch` frames at a time into preallocated stacks:
    float32 levels in [0, 1], or with `dtype` uint8 those levels times
    255, rounded (`to_levels` turns them back)."""
    dev = world.points.device
    lefts = torch.empty((n_frames, height, width), device=dev, dtype=dtype)
    rights = torch.empty_like(lefts)
    for s in range(0, n_frames, batch):
        idx = torch.arange(s, min(s + batch, n_frames), device=dev)
        for out, img in zip((lefts, rights),
                            render_frames(world, idx, height, width)):
            if dtype == torch.uint8:
                img = torch.round(img * 255.0)
            out[s:s + len(idx)] = img
    return lefts, rights


def to_levels(frames: torch.Tensor) -> torch.Tensor:
    """8-bit frames -> float32 levels over 255, as an image loader hands
    them to a SLAM system."""
    return frames.to(torch.float32) / 255.0


class BAData(NamedTuple):
    poses: torch.Tensor     # (C,4,4) float32 initial poses (rows >= n_kf: I)
    points: torch.Tensor    # (L,3) float32 initial points
    cam_idx: torch.Tensor   # (O,) int64
    lm_idx: torch.Tensor    # (O,) int64
    uv: torch.Tensor        # (O,2) float32 observed left pixels
    ur: torch.Tensor        # (O,) float32 observed right u
    w: torch.Tensor         # (O,) float32 (1)
    n_kf: int               # live camera rows
    true_poses: torch.Tensor   # (n_kf,4,4) float64
    true_points: torch.Tensor  # (L,3) float64


def ba_problem(seed: int, world: World, truth: torch.Tensor,
               keyframe_every: int, rows: int, obs_per_frame: int,
               px_noise: float, outlier_share: float, pose_noise,
               point_noise: float, image_hw=(370, 1226)) -> BAData:
    """A global BA over the keyframes of a drive: every
    `keyframe_every`-th ground-truth pose of `truth` (F,4,4) float64 is a
    camera; each observes at most `obs_per_frame` of the world's points
    in its valid image (drawn from the seed), in both images, with
    `px_noise` px of Gaussian noise and an `outlier_share` of the
    observations thrown 30-80 px off. Initial poses (but camera 0) are
    the truth moved by twist noise of standard deviations `pose_noise`
    [rho, phi], initial points the truth moved by `point_noise` m. The
    cameras are padded to `rows` with identity poses no observation
    touches. Landmarks are the points observed at least twice."""
    rng = np.random.default_rng(seed)
    cam = world.cam
    kf = truth[::keyframe_every]
    n_kf = kf.shape[0]
    if n_kf > rows:
        raise ValueError(f"{n_kf} keyframes do not fit {rows} camera rows")
    # The projections run in float64 on the world's device; the draws
    # and the problem are on the CPU.
    dev = world.points.device
    pts_dev = world.points.double()
    pts = pts_dev.cpu()
    kf_dev = kf.to(dev)
    h, w = image_hw
    cam_idx, pt_idx, uvs, urs = [], [], [], []
    for c in range(n_kf):
        Xc = se3.transform_points(se3.inverse(kf_dev[c]), pts_dev)
        uv_l, uv_r, ok = project_stereo(cam, Xc)
        ok = (ok & (Xc[:, 2] > 2.0) & (Xc[:, 2] < 90.0)
              & (uv_l[:, 0] > 0) & (uv_l[:, 0] < w) & (uv_l[:, 1] > 0)
              & (uv_l[:, 1] < h) & (uv_r[:, 0] > 0))
        sel = torch.nonzero(ok)[:, 0].cpu().numpy()
        if len(sel) > obs_per_frame:
            sel = np.sort(rng.choice(sel, obs_per_frame, replace=False))
        sel = torch.as_tensor(sel, dtype=torch.int64)
        cam_idx.append(torch.full_like(sel, c))
        pt_idx.append(sel)
        sel_dev = sel.to(dev)
        uvs.append(uv_l[sel_dev].cpu())
        urs.append(uv_r[sel_dev, 0].cpu())
    cam_idx, pt_idx = torch.cat(cam_idx), torch.cat(pt_idx)
    uv, ur = torch.cat(uvs), torch.cat(urs)
    # Landmarks: the points seen by two keyframes or more.
    count = torch.bincount(pt_idx, minlength=pts.shape[0])
    keep = count[pt_idx] >= 2
    cam_idx, pt_idx, uv, ur = cam_idx[keep], pt_idx[keep], uv[keep], ur[keep]
    used, lm_idx = torch.unique(pt_idx, return_inverse=True)
    o = uv.shape[0]
    uv = uv + torch.as_tensor(rng.normal(0, px_noise, (o, 2)))
    ur = ur + torch.as_tensor(rng.normal(0, px_noise, o))
    n_out = int(round(outlier_share * o))
    if n_out:
        sel = torch.as_tensor(rng.choice(o, n_out, replace=False))
        uv[sel] += torch.as_tensor(rng.uniform(30, 80, (n_out, 2)))
        ur[sel] += torch.as_tensor(rng.uniform(30, 80, n_out))
    dpose = torch.as_tensor(rng.normal(0, pose_noise, (n_kf, 6)))
    dpose[0] = 0
    init = kf @ se3.exp_se3(dpose)
    true_pts = pts[used]
    init_pts = true_pts + torch.as_tensor(
        rng.normal(0, point_noise, true_pts.shape))
    poses = torch.eye(4, dtype=torch.float32).repeat(rows, 1, 1)
    poses[:n_kf] = init.float()
    return BAData(poses=poses, points=init_pts.float(), cam_idx=cam_idx,
                  lm_idx=lm_idx, uv=uv.float(), ur=ur.float(),
                  w=torch.ones(o), n_kf=n_kf, true_poses=kf,
                  true_points=true_pts)
