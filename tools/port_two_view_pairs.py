"""How well two-view geometry is posed on chip_smoke.py's arc clip.

For frame pairs 0 -> k of the 24-frame arc clip (numpy seed 0, 6000
landmarks, the default 376x1280 detector), matched as the tracker gates
temporal matches (a 48 px window around a zero-motion prediction),
prints the matches, the share of them that fit the true epipolar
geometry (Sampson distance below 1.5 px under the ground-truth
fundamental matrix), and the rotation error of
`epipolar.recover_pose_2d2d` (256 hypotheses) against the truth for 8
draw seeds. Imports the PyTorch port only.

    python3 tools/port_two_view_pairs.py [--device cpu|cuda] [--pairs 1,2,3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slam1_tpu_torch.config import SlamConfig  # noqa: E402
from slam1_tpu_torch.ops import detector, epipolar, hamming  # noqa: E402
from slam1_tpu_torch.utils import synthetic  # noqa: E402

SEEDS = 8


def rot_deg(R):
    c = (np.trace(np.asarray(R, np.float64)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--pairs", default="1,2,3")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = SlamConfig()
    world = synthetic.make_world(0, n_frames=24, n_points=6000,
                                 trajectory="arc", speed=1.0, device=dev)
    lefts, _ = synthetic.render_sequence(world, cfg.image.height,
                                         cfg.image.width)
    gt = world.poses.cpu().numpy().astype(np.float64)
    K = world.cam.K.cpu().double().numpy()
    Kinv = np.linalg.inv(K)
    for k in (int(p) for p in args.pairs.split(",")):
        f = detector.detect_pyramid(torch.stack([lefts[0], lefts[k]]),
                                    cfg.detector, cfg.image.valid_height,
                                    cfg.image.valid_width)
        m = hamming.match_windowed(f.desc[0], f.desc[1], f.xy[0], f.xy[1],
                                   f.mask[0], f.mask[1],
                                   radius=cfg.tracking.gate_radius_px)
        uv1, uv2 = f.xy[0], f.xy[1][m.idx.long()]
        T = np.linalg.inv(gt[k]) @ gt[0]            # camera k <- camera 0
        t = T[:3, 3]
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                       [-t[1], t[0], 0]])
        F = torch.as_tensor(Kinv.T @ tx @ T[:3, :3] @ Kinv,
                            dtype=torch.float32, device=dev)
        fits = (epipolar.sampson_distance(F, uv1, uv2) < 1.5 ** 2) & m.mask
        errs = []
        for seed in range(SEEDS):
            g = torch.Generator(device="cpu").manual_seed(seed)
            u = torch.rand((256, uv1.shape[0]), generator=g) * (1 - 1e-9) \
                + 1e-9
            r = epipolar.recover_pose_2d2d(uv1, uv2, m.mask, world.cam.K,
                                           iters=256, u=u.to(dev))
            errs.append(rot_deg(r.T.cpu().numpy()[:3, :3].T @ T[:3, :3]))
        n = int(m.mask.sum())
        print(json.dumps({"pair": [0, k], "matches": n,
                          "fit_true_geometry": int(fits.sum()),
                          "share": int(fits.sum()) / max(n, 1),
                          "rotation_err_deg_by_seed": errs,
                          "device": str(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
