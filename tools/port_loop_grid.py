"""Offline loop-verification grid of the PyTorch/CUDA port: inliers vs
candidate offset (counterpart of tools/loop_grid.py).

Resumes a checkpoint of tools/port_global_ba_scale.py (--ckpt) and, for
chosen hit frames, runs `verify_loop_slate` over a grid of candidate
keyframes around the geometrically true revisit, in slates of 8 with
the pipeline's draws: how sharply the PnP inlier count falls off with
the candidate's offset. It separates "BoW retrieves the wrong frame"
from "verification is weak even on the right frame".

Usage (from the repo root):
  python tools/port_loop_grid.py [--ckpt .scratch/port_gba2000.npz]
      [--hits 1311,1567,1823,1999] [--span 16] [--frames 2000]
      [--device cuda] [--tiny]
Prints two lines per hit and ONE JSON line last: {"hits": [{"hit",
"anchor", "true_revisit", "gt_dist_m", "cands", "inliers"}, ...]}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tools.port_global_ba_scale import (default_ckpt,  # noqa: E402
                                        make_scale_world, scale_config)

SLATE = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", type=str, default=default_ckpt(2000))
    ap.add_argument("--hits", type=str, default="1311,1567,1823,1999")
    ap.add_argument("--span", type=int, default=16)
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises where there "
                         "is no card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CPU tests)")
    args = ap.parse_args(argv)

    from slam1_tpu_torch import runtime
    from slam1_tpu_torch.models import pipeline
    from slam1_tpu_torch.models.loop_closure import verify_loop_slate

    dev = runtime.device(args.device)
    cfg = scale_config(args.tiny)
    world = make_scale_world(args.frames, cfg, dev)
    sys_ = pipeline.SlamSystem.resume(args.ckpt, world.cam, cfg, device=dev)
    st = sys_.state
    gt = world.poses.cpu().numpy()
    kf_frames = set(st.kf.frame_of_row[:int(st.kf.n)].cpu().tolist())

    # The geometric truth: nearest GT pose among frames < hit - 200.
    def true_revisit(hf):
        p = gt[hf, :3, 3]
        d = np.linalg.norm(gt[:max(hf - 200, 1), :3, 3] - p, axis=1)
        return int(np.argmin(d)), float(np.min(d))

    ke = max(cfg.mapping.keyframe_every, 1)
    result = []
    for hf in (int(h) for h in args.hits.split(",")):
        if not 0 <= hf <= sys_.frame_count:
            raise ValueError(f"hit frame {hf} is not in the checkpoint's "
                             f"frames 0..{sys_.frame_count}")
        tv, tvd = true_revisit(hf)
        # candidate grid: keyframes centred on the true revisit
        lo = max((tv - args.span) // ke * ke, 0)
        cands = list(range(lo, tv + args.span + 1, ke))
        rows = []
        for s in range(0, len(cands), SLATE):
            batch = cands[s:s + SLATE]
            pad = SLATE - len(batch)
            cs = batch + [-1] * pad
            hfs = [hf] * SLATE
            u = sys_.draws.slate(hfs, cs, 0, pipeline.LOOP_RANSAC_ITERS,
                                 pipeline.KF_FEATURES)
            res = verify_loop_slate(
                u, st.kf, torch.tensor(cs, device=dev),
                torch.tensor(hfs, device=dev), sys_.cam, cfg)
            inl = res.num_inliers.cpu().numpy()
            af = res.anchor_frame.cpu().numpy()
            for k, c in enumerate(batch):
                rows.append((c, int(inl[k]), int(af[k])))
        anchor = rows[0][2] if rows else -1
        # A slate's anchor is the newest keyframe at or before the hit.
        if not (anchor in kf_frames and anchor <= hf):
            raise RuntimeError(f"hit {hf}: anchor {anchor} is not a "
                               f"keyframe at or before it")
        if any(i < 0 for _, i, _ in rows):
            raise RuntimeError(f"hit {hf}: inlier counts {rows}")
        print(f"hit {hf} (anchor kf {anchor}): true revisit frame {tv} "
              f"(gt dist {tvd:.2f} m)")
        print("  cand: " + " ".join(f"{c}" for c, _i, _a in rows))
        print("  inl : " + " ".join(f"{i}" for _c, i, _a in rows))
        result.append({"hit": hf, "anchor": anchor, "true_revisit": tv,
                       "gt_dist_m": tvd, "cands": [c for c, _, _ in rows],
                       "inliers": [i for _, i, _ in rows]})
    print(json.dumps({"hits": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
