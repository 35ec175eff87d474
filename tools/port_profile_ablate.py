"""Ablation timing of the PyTorch/CUDA port's SLAM step (counterpart of
tools/profile_ablate.py): the step's stages added one at a time —
frontend only, + tracking and pose chaining, + map insert, + keyframe
snapshot, + BoW (reservoir, DB row, query) — each combination a step of
its own, timed over warm calls on frames of the 24-frame arc clip with
CUDA events (`utils/timing.py`; the host clock with --device cpu).

Usage (from the repo root):
  python tools/port_profile_ablate.py [--device cuda] [--tiny]
Prints one line per combination and ONE JSON line last:
{"device", "combos_ms": {combination: ms}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402

COMBOS = (("frontend only", ()),
          ("frontend+track", ("track",)),
          ("frontend+track+map", ("track", "map")),
          ("frontend+track+map+kf", ("track", "map", "kf")),
          ("frontend+track+map+kf+bow", ("track", "map", "kf", "bow")))


def make_step(stages, cam, cfg, draws):
    """One SLAM step made of `stages` on top of the frontend; returns
    (state, per-stage outputs)."""
    from slam1_tpu_torch.models import bow as bow_mod
    from slam1_tpu_torch.models import mapping, pipeline
    from slam1_tpu_torch.models.frontend import stereo_frontend
    from slam1_tpu_torch.models.tracker import chain_pose, temporal_track
    from slam1_tpu_torch.ops import se3

    def step(state, left, right):
        u = draws.step(cfg.tracking.ransac_iters,
                       state.prev_obs.mask.shape[0])
        feats, obs = stereo_frontend(left, right, cam, cfg)
        new = {"prev_obs": obs}
        out = [torch.sum(obs.mask)]
        frame = state.frame + 1
        new["frame"] = frame
        T_w = state.T_w_cam
        if "track" in stages:
            track = temporal_track(state.prev_obs, feats, cam, cfg,
                                   xi_prior=state.xi_vel, u=u.pnp)
            T_w, xi_used = chain_pose(state.T_w_cam, track.pnp,
                                      state.xi_vel)
            new["T_w_cam"] = T_w
            new["xi_vel"] = xi_used
            out.append(track.pnp.num_inliers)
        if "map" in stages:
            xyz_w = se3.transform_points(T_w, obs.xyz)
            new_map, lm_of = mapping.insert(
                state.map, xyz_w, obs.desc, obs.mask, frame, obs.uv_l,
                cfg.mapping, uv_r_u=obs.uv_r[:, 0], obs_row=state.kf.n)
            new["map"] = new_map
            out.append(torch.sum(lm_of >= 0))
        if "kf" in stages:
            new["kf"] = mapping.kf_insert(state.kf, obs, T_w,
                                          pipeline.KF_FEATURES, frame=frame,
                                          is_kf=True)
        if "bow" in stages:
            bw = bow_mod.accumulate(state.bow, u.bow, feats.desc, feats.mask,
                                    cfg.bow.sample_desc_per_frame)
            bw = bow_mod.add_frame(bw, u.bow2, frame, feats.desc,
                                   feats.mask)
            _, chi2 = bow_mod.query(bw, frame, feats.desc, feats.mask,
                                    cfg.bow)
            new["bow"] = bw
            out.append(chi2)
        return state._replace(**new), out

    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises where there "
                         "is no card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config, 12-frame clip (CPU tests)")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)

    from slam1_tpu_torch import runtime
    from slam1_tpu_torch.bench import make_clip_world, render_chunk
    from slam1_tpu_torch.config import SlamConfig, tiny_config
    from slam1_tpu_torch.models import pipeline
    from slam1_tpu_torch.utils.timing import call_ms

    dev = runtime.device(args.device)
    cfg = tiny_config() if args.tiny else SlamConfig()
    n_frames = 12 if args.tiny else 24
    world = make_clip_world(0, n_frames, 1500 if args.tiny else 6000, "arc",
                            cfg, dev)
    lefts, rights = render_chunk(world, 0, n_frames, cfg)
    combos = {}
    for name, stages in COMBOS:
        draws = pipeline.DrawSource(0, dev)
        step = make_step(stages, world.cam, cfg, draws)
        st = [pipeline._init_state(lefts[0], rights[0], world.cam, cfg,
                                   draws)]
        k = [0]

        def one():
            i = 1 + k[0] % (n_frames - 1)
            k[0] += 1
            st[0], _ = step(st[0], lefts[i], rights[i])
        combos[name] = call_ms(one, dev, reps=args.reps, warm=2)
        print(f"{name:42s} {combos[name]:9.3f} ms", flush=True)
    print(json.dumps({"device": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu"),
                      "combos_ms": combos}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
