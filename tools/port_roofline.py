"""Roofline of the PyTorch/CUDA port's hot functions on one H100
(counterpart of tools/roofline.py).

For each function at its production shape: the bytes it must move and
the operations it must do (from its own inputs and outputs, the
formulas of `slam1_tpu_torch/utils/bounds.py` that `chip_smoke.py` also
uses), the measured time per call, the achieved rates and the share of
the bound the time reaches (`pct_of_peak`: bound / time, against the
H100's published peak at 700 W):

  - hamming_top2 — 2688 x 2688 packed 256-bit descriptors, ungated (the
    default config's keypoint slots);
  - fast_score   — the three pyramid levels of a 376x1280 stereo pair in
    one launch;
  - ba_cg_matvec — one product of global BA's reduced camera system at
    the large-map scale (C=1024 cameras, L=2^17 landmarks, O=2^16
    observations), the inner loop of the CG solve;
  - ba_cost      — BA's Huber cost at the same scale.

On a card `time_us` is the device time (a CUDA graph of the calls,
replayed) and `eager_us` the calls made one by one (CUDA events); on
the CPU (--device cpu, the tests) both are host-clock times. Prints a
table and ONE JSON record as its last line, with the keys of
PROFILE_r05.json.

Usage (from the repo root):
  python tools/port_roofline.py [--device cuda] [--out PATH] [--tiny]
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

from slam1_tpu_torch.utils import bounds  # noqa: E402

# (cameras, landmarks, observations) of the BA rows: the large-map
# problem's shapes; --tiny's for the CPU tests.
BA_SHAPE = (1024, 1 << 17, 1 << 16)
BA_SHAPE_TINY = (32, 1024, 2048)


def line(name, ms, eager_ms, n_bytes, ops, peak_ops):
    bound_ms, by = bounds.bound(n_bytes, ops, peak_ops)
    t = ms / 1e3
    return {
        "kernel": name,
        "time_us": round(1e3 * ms, 3),
        "eager_us": round(1e3 * eager_ms, 3),
        "gflops": round(ops / 1e9, 4),         # operations of the peak's type
        "mbytes": round(n_bytes / 1e6, 3),
        "achieved_tflops": round(ops / t / 1e12, 4),
        "achieved_gbs": round(n_bytes / t / 1e9, 2),
        "bound": by,
        "pct_of_peak": round(100.0 * bound_ms / ms, 3),
        "sol_us": round(1e3 * bound_ms, 4),
        "x_from_sol": round(ms / bound_ms, 2),
    }


def times(fn, dev):
    """(ms, eager ms) of fn(): the device time of a CUDA graph of the
    calls on a card, and the calls one by one."""
    from slam1_tpu_torch.utils.timing import call_ms, graph_ms
    eager = call_ms(fn, dev, reps=20, warm=3)
    return (graph_ms(fn) if dev.type == "cuda" else eager), eager


def ba_problem_at(c, l, o, dev, seed=0):
    """A BA problem of C cameras, L landmarks and O stereo observations
    with random associations (what the cost and the matvec read does not
    depend on the values)."""
    from slam1_tpu_torch.models.ba import make_problem
    g = torch.Generator().manual_seed(seed)
    poses = torch.eye(4).repeat(c, 1, 1)
    poses[:, 2, 3] = torch.arange(c, dtype=torch.float32) * 0.5
    pts = torch.randn(l, 3, generator=g) * 5.0
    pts[:, 2] += 20.0 + 0.5 * c
    ci = torch.randint(0, c, (o,), generator=g)
    li = torch.randint(0, l, (o,), generator=g)
    uv = torch.rand(o, 2, generator=g) * torch.tensor([1226.0, 370.0])
    ur = uv[:, 0] - 10.0 * torch.rand(o, generator=g)
    w = torch.ones(o)
    prob = make_problem(poses, pts, ci, li, uv, w, ur=ur, wr=w.clone())
    return type(prob)(*[x.to(dev) for x in prob])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises where there "
                         "is no card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config and BA shapes (CPU tests)")
    args = ap.parse_args(argv)

    from slam1_tpu_torch import runtime
    from slam1_tpu_torch.config import SlamConfig, tiny_config
    from slam1_tpu_torch.models import ba
    from slam1_tpu_torch.ops import detector, dispatch
    from slam1_tpu_torch.ops.camera import StereoCamera

    dev = runtime.device(args.device)
    cfg = tiny_config() if args.tiny else SlamConfig()
    results = []

    # ---------------------------------------------------- hamming_top2
    n = cfg.detector.max_kp
    rng = np.random.default_rng(0)
    da, db = (torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8),
                              device=dev) for _ in range(2))
    ma = torch.ones(n, dtype=torch.bool, device=dev)
    t, te = times(lambda: dispatch.hamming_top2(da, db, ma, ma), dev)
    results.append(line(f"hamming_top2 {n}x{n}x256b", t, te,
                        *bounds.hamming_work(1, n, n, gated=False),
                        bounds.PEAK_INT8_OPS))

    # ------------------------------------------------------ fast_score
    h, w = cfg.image.height, cfg.image.width
    imgs = torch.as_tensor(rng.random((2, h, w), dtype=np.float32),
                           device=dev)
    levels = [lv.contiguous()
              for lv in detector.pyramid_levels(imgs, cfg.detector)]
    thr, arc = cfg.detector.fast_threshold, cfg.detector.fast_arc
    t, te = times(lambda: dispatch.fast_score_levels(levels, thr, arc), dev)
    results.append(line(
        f"fast_score 2x{h}x{w} {len(levels)} levels", t, te,
        *bounds.fast_score_work([lv.shape for lv in levels]),
        bounds.PEAK_F32_FLOPS))

    # --------------------------------------- BA CG matvec and BA cost
    c, l, o = BA_SHAPE_TINY if args.tiny else BA_SHAPE
    cam = StereoCamera.kitti_default(device=dev)
    prob = ba_problem_at(c, l, o, dev)
    _, _, hw = ba._cost(prob, cam, cfg.ba.huber_delta)
    r, Jc, Jl, wt = ba._linearize(prob, cam, prob.w * hw)
    lam = torch.full((), cfg.ba.lm_lambda0, device=dev)
    matvec, btil, _, _ = ba._reduced_system(
        prob, ba._normal_blocks(prob, r, Jc, Jl, wt), lam,
        ba._obs_order(prob))
    t, te = times(lambda: matvec(btil), dev)
    results.append(line(f"ba_cg_matvec C={c} L={l} O={o}", t, te,
                        *bounds.ba_matvec_work(o, c, l, 0),
                        bounds.PEAK_F32_FLOPS))
    t, te = times(lambda: ba._cost(prob, cam, cfg.ba.huber_delta), dev)
    results.append(line(f"ba_cost C={c} L={l} O={o}", t, te,
                        *bounds.ba_cost_work(
                            o, c, l, prob.cam_idx.element_size()),
                        bounds.PEAK_F32_FLOPS))

    print("| kernel | t (us) | eager (us) | G ops | MB | T ops/s | GB/s "
          "| bound | % of bound | bound (us) | x from bound |")
    print("|" + "---|" * 11)
    for q in results:
        print(f"| {q['kernel']} | {q['time_us']} | {q['eager_us']} "
              f"| {q['gflops']} | {q['mbytes']} | {q['achieved_tflops']} "
              f"| {q['achieved_gbs']} | {q['bound']} | {q['pct_of_peak']} "
              f"| {q['sol_us']} | {q['x_from_sol']} |")
    out = {"backend": dev.type,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "peaks": {"bytes_s": bounds.PEAK_BYTES_S,
                     "int8_ops": bounds.PEAK_INT8_OPS,
                     "f32_flops": bounds.PEAK_F32_FLOPS},
           "kernels": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
