"""Per-stage ms of the PyTorch/CUDA port's SLAM step at the default
config (counterpart of tools/profile_slam.py): `SlamSystem` frames/s
over the 24-frame arc clip, the full `slam_step`, and its parts — the
stereo frontend, the temporal tracker, the map insert, the keyframe
snapshot, the BoW reservoir / DB row / query — then one windowed local
BA and one live pose-graph relaxation (512-row bucket). Each is timed
over warm calls with CUDA events (`utils/timing.py`; the host clock
with --device cpu).

Usage (from the repo root):
  python tools/port_profile_slam.py [--device cuda] [--tiny]
Prints one line per stage and ONE JSON line last:
{"device", "slam_frames_per_s", "stages_ms": {stage: ms}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises where there "
                         "is no card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config, 12-frame clip (CPU tests)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    from slam1_tpu_torch import runtime
    from slam1_tpu_torch.bench import make_clip_world, render_chunk, sync
    from slam1_tpu_torch.config import SlamConfig, tiny_config
    from slam1_tpu_torch.models import bow as bow_mod
    from slam1_tpu_torch.models import mapping, pipeline
    from slam1_tpu_torch.models.frontend import stereo_frontend
    from slam1_tpu_torch.models.tracker import temporal_track
    from slam1_tpu_torch.utils.timing import call_ms

    dev = runtime.device(args.device)
    cfg = tiny_config() if args.tiny else SlamConfig()
    n_frames = 12 if args.tiny else 24
    world = make_clip_world(0, n_frames, 1500 if args.tiny else 6000, "arc",
                            cfg, dev)
    lefts, rights = render_chunk(world, 0, n_frames, cfg)
    cam = world.cam
    reps = args.reps
    stages = {}

    def timeit(name, fn, reps=reps):
        stages[name] = call_ms(fn, dev, reps=reps, warm=2)
        print(f"{name:42s} {stages[name]:9.3f} ms", flush=True)
        return fn()

    # ---- end-to-end SlamSystem frames/s (a warm pass first)
    def run_system():
        s = pipeline.SlamSystem(cam, cfg, bow_train_frame=8)
        for i in range(n_frames):
            s.process(lefts[i], rights[i])
        return s
    run_system()
    sync(dev)
    t0 = time.perf_counter()
    run_system()
    sync(dev)
    fps = n_frames / (time.perf_counter() - t0)
    print(f"{'SlamSystem frames/s':42s} {fps:9.3f}")

    # ---- slam_step alone, the state threaded through the calls
    draws = pipeline.DrawSource(0, dev)
    state = pipeline._init_state(lefts[0], rights[0], cam, cfg, draws)
    k = [0]
    st = [state]

    def step():
        i = 2 + k[0] % (n_frames - 2)
        k[0] += 1
        st[0], _, _ = pipeline.slam_step(st[0], lefts[i], rights[i], cam,
                                         cfg, draws)
    timeit("slam_step (full)", step)

    # ---- components
    left, right = lefts[2], rights[2]
    feats, obs = timeit("stereo_frontend",
                        lambda: stereo_frontend(left, right, cam, cfg))
    gen = torch.Generator(device=dev).manual_seed(1)
    timeit("temporal_track (match+pnp)",
           lambda: temporal_track(obs, feats, cam, cfg, generator=gen))
    m0 = state.map
    timeit("mapping.insert", lambda: mapping.insert(
        m0, obs.xyz, obs.desc, obs.mask, 5, obs.uv_l, cfg.mapping,
        uv_r_u=obs.uv_r[:, 0], obs_row=3))
    yes = torch.ones((), dtype=torch.bool, device=dev)
    eye = torch.eye(4, device=dev)
    timeit("kf_insert", lambda: mapping.kf_insert(
        state.kf, obs, eye, pipeline.KF_FEATURES, frame=7, is_kf=yes))
    bw = state.bow
    n = feats.mask.shape[0]
    u = draws.init(n)[0]
    timeit("bow.accumulate", lambda: bow_mod.accumulate(
        bw, u, feats.desc, feats.mask, cfg.bow.sample_desc_per_frame))
    timeit("bow.add_frame", lambda: bow_mod.add_frame(
        bw, u, 9, feats.desc, feats.mask, is_kf=yes))
    timeit("bow.query", lambda: bow_mod.query(bw, 9, feats.desc, feats.mask,
                                              cfg.bow))

    # ---- one windowed local BA on a state of 10 frames
    st2 = pipeline._init_state(lefts[0], rights[0], cam, cfg, draws)
    for i in range(1, 10):
        st2, _, _ = pipeline.slam_step(st2, lefts[i], rights[i], cam, cfg,
                                       draws)
    timeit("local_ba_step", lambda: pipeline.local_ba_step(st2, cam, cfg),
           reps=max(reps // 4, 1))

    # ---- one live pose-graph relaxation (5 GN) at the 512-row bucket
    z = torch.zeros(64, dtype=torch.int32, device=dev)
    le = (z, z, torch.eye(4, device=dev).repeat(64, 1, 1),
          torch.zeros(64, device=dev))
    n_live = int(st2.frame) + 1
    timeit("pgo_step (bucket=512)", lambda: pipeline._pgo_step(
        st2.traj, st2.rel, st2.rel_mask, st2.kf.frame_of_row, *le,
        st2.frame, st2.map.xyz, st2.map.last_frame, st2.map.valid,
        bucket=512, iters=max(cfg.ba.pg_iters // 5, 3),
        cg_iters=cfg.ba.cg_iters, n_live=n_live),
        reps=max(reps // 4, 1))
    print(json.dumps({"device": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu"),
                      "slam_frames_per_s": fps, "stages_ms": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
