"""Per-stage ms of the PyTorch/CUDA port's `vo_step` at the default
config (counterpart of tools/profile_stage.py): the full step, the
stereo frontend, one image's pyramid detection, the FAST score through
its kernel entry and through the plain twin, NMS, the blur, patch
extraction, orientation, BRIEF, the per-tile top-k, Hamming matching
and the temporal tracker, on frames of the 24-frame arc clip. Each is
timed over warm calls with CUDA events (`utils/timing.py`; the host
clock with --device cpu).

Usage (from the repo root):
  python tools/port_profile_stage.py [--device cuda] [--tiny]
Prints one line per stage and ONE JSON line last:
{"device", "stages_ms": {stage: ms}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises where there "
                         "is no card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config, 6-frame clip (CPU tests)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    from slam1_tpu_torch import runtime
    from slam1_tpu_torch.bench import make_clip_world, render_chunk
    from slam1_tpu_torch.config import SlamConfig, tiny_config
    from slam1_tpu_torch.models import vo
    from slam1_tpu_torch.models.frontend import stereo_frontend
    from slam1_tpu_torch.models.tracker import temporal_track
    from slam1_tpu_torch.ops import brief, detector, dispatch, fast, hamming
    from slam1_tpu_torch.utils.timing import call_ms

    dev = runtime.device(args.device)
    cfg = tiny_config() if args.tiny else SlamConfig()
    world = make_clip_world(0, 6, 1500 if args.tiny else 6000, "arc", cfg,
                            dev)
    lefts, rights = render_chunk(world, 0, 6, cfg)
    cam = world.cam
    left, right = lefts[1], rights[1]
    dcfg = cfg.detector
    vh, vw = cfg.image.valid_height, cfg.image.valid_width
    stages = {}

    def timeit(name, fn, reps=args.reps):
        stages[name] = call_ms(fn, dev, reps=reps, warm=2)
        print(f"{name:40s} {stages[name]:9.3f} ms", flush=True)
        return fn()

    # the full step, the state threaded through the calls
    state = [vo.init_state(left, right, cam, cfg)]

    def step():
        state[0], _ = vo.vo_step(state[0], lefts[2], rights[2], cam, cfg)
    timeit("vo_step (full)", step)

    feats, obs = timeit("stereo_frontend (2 images)",
                        lambda: stereo_frontend(left, right, cam, cfg))
    img = left[None]
    f1 = timeit("detect_pyramid (one image)",
                lambda: detector.detect_pyramid(img, dcfg, vh, vw))
    score = timeit("fast_score (kernel entry, level 0)",
                   lambda: dispatch.fast_score(img, dcfg.fast_threshold,
                                               dcfg.fast_arc))
    timeit("fast_score (plain twin, level 0)",
           lambda: fast.fast_score(img, dcfg.fast_threshold, dcfg.fast_arc))
    timeit("nms", lambda: fast.nms(score, dcfg.nms_radius))
    blurred = timeit("gaussian_blur",
                     lambda: brief.gaussian_blur(left, dcfg.blur_sigma))
    xy = f1.xy[0]
    patches = timeit(f"extract_patches ({xy.shape[0]}x{dcfg.patch_size}"
                     f"x{dcfg.patch_size})",
                     lambda: brief.extract_patches(blurred, xy,
                                                   dcfg.patch_size))
    angles = timeit("orientation", lambda: brief.orientation(patches))
    pattern = detector._pattern_for(dcfg, dev)
    timeit("describe", lambda: brief._describe(patches, angles, pattern))

    def topk():
        h, w = score.shape[-2:]
        th, tw = -(-h // dcfg.grid_rows), -(-w // dcfg.grid_cols)
        sp = torch.nn.functional.pad(score[0], (0, tw * dcfg.grid_cols - w,
                                                0, th * dcfg.grid_rows - h))
        tiles = sp.reshape(dcfg.grid_rows, th, dcfg.grid_cols, tw).permute(
            0, 2, 1, 3).reshape(-1, th * tw)
        return detector._top_k_stable(tiles, dcfg.kp_per_tile)
    timeit("per-tile top_k", topk)

    n = f1.desc.shape[1]
    mm = cfg.matcher
    timeit(f"hamming.match {n}x{n}",
           lambda: hamming.match(f1.desc[0], f1.desc[0], f1.mask[0],
                                 f1.mask[0], ratio=mm.ratio,
                                 max_distance=mm.max_hamming,
                                 cross_check=mm.cross_check))
    gen = torch.Generator(device=dev).manual_seed(1)
    timeit("temporal_track (match+pnp)",
           lambda: temporal_track(obs, feats, cam, cfg, generator=gen))
    print(json.dumps({"device": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu"),
                      "stages_ms": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
