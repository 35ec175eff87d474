"""Drive the PyTorch/CUDA port's main paths once on one GPU: the stereo
VO step (also at the 1.2 x 8 ORB pyramid), two-view geometry, the flow
VO, the SLAM system with local BA off, the SLAM system at the default
config (local BA on, checkpoints, asynchronous drain) followed by
resume, global BA with pose priors, the reference backend and the
distributed layer, and the `slam-torch` command line on a KITTI-layout
sequence.

    python3 chip_smoke.py [--phases kernels,slice,flow,...]

With no argument every phase runs; `--phases` runs the named ones and
what they need (slam-ba needs slam; checkpoint, global-ba, ref-backend,
dist and times-slam need slam-ba; times needs kernels), and leaves null
in the last lines what it did not measure. `--phases pyramid,two-view`
runs without the 600-frame clip.

Run from the repo root on a machine with one CUDA card (sm_90a: H100).
It imports torch, numpy and `slam1_tpu_torch` only — never jax. Phases,
each printed as it finishes; any failed check raises, so the script
exits non-zero and never prints the final `ok` line:

  1. device  — CUDA must be available; prints the card's name and power
               limit as nvidia-smi reports them.
  2. build   — compiles the CUDA kernels from `slam1_tpu_torch/csrc/`
               (one nvcc per source, together), prints what ptxas says
               of each kernel, and requires a tensor-core MMA in the
               Hamming library's SASS (cuobjdump of the CUDA toolkit).
  3. kernels — each kernel against its plain PyTorch twin on the card,
               at the main paths' shapes: fast_score on a rendered and
               a random image at the three pyramid levels (batch 2),
               level by level through its one-level entry and all
               levels in one launch, on copies moved 4 bytes off their
               alignment and on a 61 x 83 canvas (the scalar path), and
               with arc = 12 (the run-time-arc instantiation);
               hamming_top2 at 2688 x 2688 ungated / epipolar-gated /
               window-gated / with duplicated descriptors (ties) / with
               duplicates that straddle an MMA tile, a warp, a row block
               and a column strip, and at ragged sizes (1 x 2, 130 x
               257, 300 x 77); the batched hamming_top2 at 8 x 1024 x
               1024 (a verification slate, with two padded all-invalid
               pairs and ties); chain_prepare and chain_sweep at 2048
               poses (601 live rows, all rows, 1 and 2 live rows).
  4. slice   — renders the 24-frame arc clip (6000 points) at the
               default config, runs VO `run_sequence` on CUDA tensors
               with the launch counters reset just before, checks the
               counts, pnp_ok and ATE; then runs the first 6 frames on
               CPU tensors (the plain path) and on CUDA with the same
               RANSAC draws and compares them.
  pyramid  — the same clip at `SlamConfig()` with only the ORB pyramid
               (scale 1.2, 8 levels, 6528 slots): fast_score on the 8
               ragged levels of both images in one launch, level by
               level against the twin; hamming_top2 at 6528 x 6528
               (ungated, epipolar, window) exactly; detect_pyramid on
               frame 0 against the port's CPU run (differing slots
               printed and bounded); VO: fast_score F and hamming_top2
               2F-1 launches, ATE < 1 m, pnp_ok >= 0.8, vo_step ms.
  two-view — recover_pose_2d2d (256 hypotheses) and dlt on the
               tracker-gated matches of frames 0 -> 1 at the default
               detector, on the card and the CPU with the same draws:
               equal inlier masks, R and t within 1e-4, the rotation
               within 1 deg of the truth, dlt within 1e-3 relative.
  5. slam    — renders bench.measure_slam's clip with the port's
               renderer (loop2, 600 frames, 20 points per frame, speed
               1.0, numpy seed 11) at the default config with
               ba.local_every=0 and bow.poll_lag_s=0; runs
               `SlamSystem.process` on frame 0, `process_block` on
               blocks of 32, then `finalize`, with the launch counters
               reset just before and read just after; checks the launch
               counts (fast_score F, hamming_top2 2F-1, one batched
               hamming_top2 per slate, one chain_prepare per Gauss-Newton
               iteration, one chain_sweep per preconditioner
               application), >= 2 accepted
               loop edges each within 0.5 m of the ground-truth relative
               translation, the pose-graph cost after finalize <= before
               it, ATE after finalize <= the odometry-only ATE (the ATE
               before finalize is printed: the reference's final
               relaxation can raise it by centimetres), and pnp_ok >=
               0.8; chain_sweep is held against its twin on the
               chain operands of the finished run's pose graph.
  6. slam-ba — the same clip at `SlamConfig()` with only
               bow.poll_lag_s=0 (so two passes can be compared): local
               BA every 5 keyframes, a checkpoint saved at frame 320.
               Checks: one BA cost per cadence window, all finite; the
               launch counts by the same formulas (BA launches no
               hand-written kernel); loop edges, pnp_ok and ATE as in
               `slam`; a second pass gives the same ATEs; a warm
               slam_step and a warm local_ba_step make no host sync.
               Prints frames/s, ms per local_ba_step and the ATEs beside
               the BA-off run's.
  7. checkpoint — `SlamSystem.resume` from the frame-320 snapshot, frames
               321-599, finalize: final poses within 1e-3 m of the
               straight run's.
  8. global-ba — `global_ba_step` on the finished state with the
               keyframe count's bucket, the observation bucket the CLI
               picks, the run's loop edges as priors and the trace:
               final cost finite and <= the first trace entry, at least
               one accepted step, ATE after <= 1.05 x before. Prints the
               trace, ms per LM iteration and ms per CG matvec with its
               byte bound.
  ref-backend — `ref_backend.optimize_segment` over the run's first loop
               (its odometry twists, padded to a multiple of 64, the loop
               edge's measurement): endpoint gap down >= 10x, twists
               finite and within 1e-3 of the CPU run; ms per LM
               iteration.
  dist     — the distributed layer on the same state and global problem
               (no priors): partition_problem_device equal to
               partition_problem at 1 and 2 shards, nothing dropped;
               distributed_bundle_adjust at one rank over NCCL in this
               process against bundle_adjust (trace, keyframe ATE <=
               1.05 x before); optimize_sharded on the run's pose graph
               (2048 rows, 601 live, its loop edges, the live
               relaxation's 5 GN x 64 CG)
               against posegraph.optimize (cost, ATE <= odometry-only),
               chain_prepare / chain_sweep launches per rank; then both
               at two ranks spawned on the one card over gloo (joined
               under a time limit) against one rank. Prints ms per LM /
               GN iteration and all_reduce bytes per CG step.
  9. async   — the first 200 frames at `SlamConfig()` unchanged
               (poll_lag_s=0.05): no metrics row lost, poses finite,
               pnp_ok >= 0.8, the fetch worker gone with the system.
  flow     — the flow VO (`models/vo_flow.py`: FAST corners through the
               kernel's one-level entry, pyramidal LK, dense SGM
               disparity, RANSAC-PnP) over the arc clip on CUDA tensors,
               the launch counters reset just before: fast_score once per
               frame, no other kernel; pnp_ok >= 0.6, poses finite, ATE
               printed beside the VO slice's; the first 6 frames on CPU
               and CUDA with the same draws (num_tracked and num_stereo
               within 2%, poses within 1e-2 m); then flow frames/s, ms
               per vo_step, per disparity and per lk_track call (CUDA
               events), their device-busy ms and launches (torch.profiler).
 10. cpu-vs-gpu — the first 6 frames of `slam_step` on CPU and on CUDA
               with the same draws (num_stereo, kf.n and map.cursor
               within 2%, poses within 1e-2 m); `bundle_adjust` of a
               seeded 6-camera, 120-point problem on CPU and CUDA
               tensors (equal accept sequences, poses within 1e-4 m);
               the host syncs of one warm vo_step and one warm slam_step
               under torch.cuda.set_sync_debug_mode("warn") (slam_step
               may not add any).
  cli      — the first 120 frames of the loop2 clip cropped to KITTI's
               370 x 1226, written as a KITTI odometry directory (8-bit
               grayscale PNG through zlib, or P5 PGM where the native
               decoder does not build), decoded back (the decoder is
               printed; the native prefetcher held equal to the Python
               loader on 4 pairs), then in subprocesses as a user runs
               them: `slam-torch run --vo-only` (equal to vo.run_sequence
               in process), `run` at SlamConfig() with checkpoints and
               metrics (120 frames, ATE < 1 m, fast_score F and
               hamming_top2 2F-1 launches, frames/s), `eval` (the same
               ATE), `ba --state` on its checkpoint, `ba --state
               --distributed --lm-shards 1` (finite cost, nothing
               dropped), `ba` on its trajectory (finite costs), and
               `run --multihost --coordinator 127.0.0.1:<free port>
               --num-processes 1 --process-id 0 --synthetic 8` (its rank
               line, the plain run's poses).
 11. times   — per kernel: its device time (a CUDA graph of 20 calls
               replayed), its eager time (CUDA events around 20 wrapper
               calls), its plain twin's time, in turns plain, kernel,
               kernel, plain; its bound from the function's inputs and
               outputs alone, whatever the kernel's design (the larger
               of bytes / 3.35 TB/s and operations / the H100's
               published peak for their type) and the share of the bound
               reached;
               the VO frames/s of the per-frame loop, the SLAM frames/s
               of the process loop, and ms per place_query, per slate
               and per PGO (the last three: phase times-slam).

The torch.profiler sessions of every phase (device-busy ms, launch
counts) run after all of them, so that no host-bound time is taken in a
process where a session has run (whether a session leaves a cost per
launch behind is not settled: the flow phase times the disparity again
after its sessions).

The last four lines are: a JSON object of the end-to-end numbers (with
the run's seconds), the nvidia-smi line (name, power limit), {"kernels":
[...]} (`launches` is the count of the slam-ba pass, `launches_by_path`
those of every path, the dist phase's per rank) and {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import glob
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from slam1_tpu_torch import runtime  # noqa: E402
from slam1_tpu_torch.config import SlamConfig  # noqa: E402
from slam1_tpu_torch.models import ba, pipeline, posegraph, ref_backend, \
    vo, vo_flow  # noqa: E402
from slam1_tpu_torch.models.loop_closure import place_query, \
    verify_loop_slate  # noqa: E402
from slam1_tpu_torch.ops import cuda_kernels, detector, epipolar, fast, \
    hamming, lk, se3, triangulate  # noqa: E402
from slam1_tpu_torch.ops.camera import StereoCamera  # noqa: E402
from slam1_tpu_torch.ops.detector import _downsample2  # noqa: E402
from slam1_tpu_torch.ops.pnp import draw_uniform  # noqa: E402
from slam1_tpu_torch.utils import kitti, native_loader, \
    synthetic  # noqa: E402
from slam1_tpu_torch.utils.evalmetrics import ate_rmse  # noqa: E402
from slam1_tpu_torch.utils.timing import device_busy_ms, device_launches, \
    event_ms, graph_ms  # noqa: E402

N_FRAMES = 24
N_POINTS = 6000
CPU_FRAMES = 6
SEED = 0
FAST_TOL = 1e-5
FAST_ARC = SlamConfig().detector.fast_arc
SLAM_FRAMES = 600
SLAM_SEED = 11
SLAM_BLOCK = 32
SLATE_B = 8
CHAIN_F, CHAIN_LIVE = 2048, 601
CHAIN_TOL = 1e-4             # max |kernel - twin| / max |twin|
SAME_ATE_TOL = 1e-6          # m, between two runs of the same clip
CKPT_FRAME = 320             # a block boundary of the slam-ba pass
RESUME_TOL = 1e-3            # m, resumed run against the straight run
ASYNC_FRAMES = 200
BA_TOL = 1e-4                # m, bundle_adjust on CPU against CUDA
FLOW_PNP_OK = 0.6            # the flow VO's pnp_ok share on the arc clip
CLI_FRAMES = 120             # the first frames of the loop2 clip
CLI_CROP = (370, 1226)       # KITTI odometry's image size
CLI_CKPT_EVERY = 64
MULTIHOST_FRAMES = 8         # `run --multihost` against the plain `run`
NATIVE_PAIRS = 4             # native loader held to the Python loader
PYR_SCALE, PYR_LEVELS = 1.2, 8   # the original project's ORB pyramid
PYR_SLOT_TOL = 0.01          # detect_pyramid slots differing, card vs CPU
TWO_VIEW_B = 1               # frames 0 -> 1 of the arc clip (see phase)
TWO_VIEW_ITERS = 256
REF_PAD, REF_ITERS = 64, 20  # ref_backend segment padding, LM iterations
DIST_TIMEOUT_S = 600.0       # the spawned ranks' join (and gloo's) limit
DIST_TRACE_TOL = 1e-2        # sharded BA trace against bundle_adjust
DIST_PGO_COST_TOL = 5e-2     # sharded PGO cost against posegraph.optimize
REPO = os.path.dirname(os.path.abspath(__file__))
# Phases a run may select (--phases), in the order a full run takes
# them, and what each needs run before it.
PHASES = ("kernels", "slice", "pyramid", "two-view", "flow", "slam",
          "slam-ba", "checkpoint", "global-ba", "ref-backend", "dist",
          "async", "cpu-vs-gpu", "cli", "times", "times-slam")
NEEDS = {"slam-ba": ("slam",), "checkpoint": ("slam-ba",),
         "global-ba": ("slam-ba",), "ref-backend": ("slam-ba",),
         "dist": ("slam-ba",), "times": ("kernels",),
         "times-slam": ("slam-ba",)}
# name: (source, what it replaces, what one "ms" covers)
KERNELS = {
    "fast_score": ("slam1_tpu_torch/csrc/fast_score.cu",
                   "slam1_tpu/ops/pallas_kernels.py:229",
                   "one frame: 1 launch, 2 images x 3 pyramid levels"),
    "hamming_top2": ("slam1_tpu_torch/csrc/hamming_top2.cu",
                     "slam1_tpu/ops/pallas_kernels.py:100",
                     "one frame: 2 gated launches of 2688 x 2688"),
    "hamming_top2_batched": ("slam1_tpu_torch/csrc/hamming_top2.cu",
                             "slam1_tpu/ops/pallas_kernels.py:100",
                             "one slate: 1 launch of 8 x 1024 x 1024"),
    # not TPU kernels: the XLA scans of the reference's chain solve
    "chain_prepare": ("slam1_tpu_torch/csrc/chain_sweep.cu",
                      "slam1_tpu/models/posegraph.py:74",
                      "one launch, 2048 poses, 601 live"),
    "chain_sweep": ("slam1_tpu_torch/csrc/chain_sweep.cu",
                    "slam1_tpu/models/posegraph.py:74",
                    "one launch, 2048 poses, 601 live"),
}
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): device
# memory, int8 tensor-core operations (the 1-bit MMA is held to the
# int8 rate), float32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12


def bound(n_bytes, ops, peak_ops):
    """(bound in ms, "bytes" or "operations"): the least time the card
    could take to move n_bytes once or to do `ops` at `peak_ops`."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_fast_score(shapes):
    """Each image read and its score written once (8 bytes a pixel). The
    float32 operations the score itself needs per pixel, however the arc
    test is made: 16 differences, 32 threshold excesses (diff - t and
    -diff - t), 32 clamps at 0, 32 additions into the two sums and one
    maximum (113); the arc test works on predicates and is not counted."""
    px = sum(b * h * w for b, h, w in shapes)
    return bound(8 * px, 113 * px, PEAK_F32_FLOPS)


def bound_hamming(problems, n, m, gated):
    """2 N M 256 one-bit multiply-adds per problem; descriptors (32 B),
    masks (1 B) and gate coordinates (8 B) read once, three int32 per
    row and one per column written."""
    per_item = 32 + 1 + (8 if gated else 0)
    n_bytes = problems * ((n + m) * per_item + 4 * (3 * n + m))
    return bound(n_bytes, problems * 2 * n * m * 256, PEAK_INT8_OPS)


def bound_chain_prepare(f, n_live):
    """JjInv and Ji of the live rows read, the prepared value
    (CHAIN_LEVELS, 2, F, 6, 6) written; two 6x6 products (2 x 36 x 11
    operations) per live row and level."""
    levels = cuda_kernels.CHAIN_LEVELS
    return bound(4 * (2 * 36 * n_live + levels * 72 * f),
                 levels * 2 * 36 * 11 * n_live, PEAK_F32_FLOPS)


def bound_chain_sweep(f, n_live):
    """The function x = M^-1 v as chain_sweep_plain states it: JjInv and
    Ji of the live rows (72 floats a row) read, v and winv read and x
    written for all F rows (13 floats a row); four 6x6 matrix-vector
    products (66 operations each) per live row. What a design reads
    besides (prepared blocks) is its own cost, not part of the bound."""
    return bound(4 * (72 * n_live + 13 * f), 4 * 66 * n_live,
                 PEAK_F32_FLOPS)


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    return smi


def phase_build():
    t0 = time.perf_counter()
    cuda_kernels.build(verbose=True)
    mma = cuda_kernels.tensor_core_sass("hamming_top2.cu")
    say("build", seconds=f"{time.perf_counter() - t0:.3f}",
        nvcc_seconds=cuda_kernels.build_seconds,
        libraries=[os.path.basename(cuda_kernels.library_path(src))
                   for src in cuda_kernels.SOURCES],
        hamming_sass_tensor_core_instructions=mma)
    check(mma is not None, "cuobjdump not found beside nvcc: the Hamming "
          "library's SASS cannot be checked for a tensor-core MMA")
    check(any("MMA" in k for k in mma),
          f"no tensor-core MMA in the Hamming library's SASS: {mma}")


def pyramid(img, n_levels):
    out = [img]
    for _ in range(n_levels - 1):
        out.append(_downsample2(out[-1]))
    return out


def phase_kernels(cfg, lefts, rights, dev):
    errs = {"fast_score": 0.0, "hamming_top2": 0.0}
    thr, arc = cfg.detector.fast_threshold, cfg.detector.fast_arc
    g = torch.Generator(device="cpu").manual_seed(1)
    mid = lefts.shape[0] // 2
    rendered = torch.stack([lefts[mid], rights[mid]])
    noise = torch.rand(rendered.shape, generator=g).to(dev)
    def held(case, im, k, arc_):
        """One score map against the plain twin's."""
        p = fast.fast_score(im, thr, arc_)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        same_mask = bool(torch.equal(k > 0, p > 0))
        say("kernels", kernel="fast_score", case=case, arc=arc_,
            shape=tuple(im.shape), max_abs_err=err,
            corners=int((p > 0).sum()), masks_equal=same_mask)
        check(same_mask and err <= FAST_TOL,
              f"fast_score {case}: err {err}, masks equal {same_mask}")
        errs["fast_score"] = max(errs["fast_score"], err)

    def held_levels(case, imgs, arc_):
        """All levels in one launch against the twin, level by level."""
        outs = cuda_kernels.fast_score_levels_cuda(imgs, thr, arc_)
        for lvl, (im, k) in enumerate(zip(imgs, outs)):
            held(f"{case} one-launch level {lvl}", im, k, arc_)

    n_levels = cfg.detector.num_levels
    pyramids = {name: [im.contiguous() for im in pyramid(img, n_levels)]
                for name, img in (("rendered", rendered), ("random", noise))}
    for name, imgs in pyramids.items():
        for lvl, im in enumerate(imgs):
            held(f"{name} level {lvl}", im,
                 cuda_kernels.fast_score_cuda(im, thr, arc), arc)
        held_levels(name, imgs, arc)
    # The scalar path: contiguous copies 4 bytes off a 16-byte boundary,
    # and a canvas whose rows are no whole number of 16 bytes.
    moved = [synthetic.misaligned_copy(im) for im in pyramids["random"]]
    check(all(im.data_ptr() % 16 for im in moved), "copies are aligned")
    held_levels("misaligned", moved, arc)
    held("misaligned level 0", moved[0],
         cuda_kernels.fast_score_cuda(moved[0], thr, arc), arc)
    held_levels("ragged", pyramid(noise[:, :61, :83].contiguous(), n_levels),
                arc)
    # Another arc than the compiled-in one.
    check(arc != 12, "arc = 12 is the compiled-in arc")
    held_levels("random arc-12", pyramids["random"], 12)
    held_levels("ragged arc-12",
                pyramid(noise[:, :61, :83].contiguous(), n_levels), 12)

    n = cfg.detector.max_kp
    rng = np.random.default_rng(2)

    def t(a):
        return torch.as_tensor(a).to(dev)

    da = t(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    db = t(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    ma = t(rng.random(n) > 0.2)
    mb = t(rng.random(n) > 0.2)
    hw = (cfg.image.height, cfg.image.width)
    uva = t((rng.random((n, 2)) * [hw[1], hw[0]]).astype(np.float32))
    uvb = uva + t(rng.normal(0, [30.0, 1.5], (n, 2)).astype(np.float32))
    # Integer rows force exact ties in the epipolar band's dy test.
    uvb[:, 1] = torch.round(uvb[:, 1])
    uva[:, 1] = torch.round(uva[:, 1])
    mm = cfg.matcher
    r = cfg.tracking.gate_radius_px
    dup = da.clone()
    dup[1::2] = dup[0::2]                       # every row twice
    dup_b = torch.cat([dup[n // 2:], dup[:n // 2]])
    window = dict(uv_a=uva, uv_b=uvb, dy_tol=r, dx_lo=-r, dx_hi=r)
    # Equal descriptors on both sides of every boundary of the kernel's
    # tiling: an MMA tile (8 columns, 16 rows), a warp (16 rows), a row
    # block (128 rows) and a column strip (208 columns at this size).
    edge_a, edge_b = da.clone(), db.clone()
    for j in (1, 7, 8, 15, 16, 127, 128, 207, 208, 415, 416, n - 1):
        edge_b[j] = edge_b[0]
    edge_a[0:n:5] = edge_b[0]                   # rows whose best is a tie
    for i in (1, 7, 8, 15, 16, 31, 32, 127, 128, 129, n - 1):
        edge_a[i] = edge_a[2]                   # equal rows: column ties
    all_a, all_b = torch.ones_like(ma), torch.ones_like(mb)
    cases = {
        "ungated": (da, db, ma, mb, {}),
        "epipolar": (da, db, ma, mb,
                     dict(uv_a=uva, uv_b=uvb, dy_tol=mm.epipolar_dy,
                          dx_lo=mm.min_disparity, dx_hi=mm.max_disparity)),
        "window": (da, db, ma, mb, window),
        "ties": (dup, dup_b, ma, mb, {}),
        "ties-across-tiles": (edge_a, edge_b, all_a, all_b, {}),
        "ties-across-tiles-window": (edge_a, edge_b, ma, mb, window),
    }
    for rn, rm in ((1, 2), (130, 257), (300, 77)):
        cases[f"ragged-{rn}x{rm}"] = (
            edge_a[:rn], edge_b[:rm], ma[:rn], mb[:rm],
            dict(uv_a=uva[:rn], uv_b=uvb[:rm], dy_tol=r, dx_lo=-r, dx_hi=r))
        cases[f"ragged-{rn}x{rm}-ungated"] = (
            edge_a[:rn], edge_b[:rm], all_a[:rn], all_b[:rm], {})
    for name, (a, b, va, vb, kw) in cases.items():
        outk = cuda_kernels.hamming_top2_cuda(a, b, va, vb, **kw)
        outp = cuda_kernels.hamming_top2_plain(a, b, va, vb, **kw)
        torch.cuda.synchronize()
        equal = [bool(torch.equal(x, y)) for x, y in zip(outk, outp)]
        err = max((x.long() - y.long()).abs().max().item()
                  for x, y in zip(outk, outp))
        ties = int((outp[0] == outp[1]).sum())
        say("kernels", kernel="hamming_top2", case=name,
            shape=(a.shape[0], b.shape[0]), equal_d1_d2_idx_colbest=equal,
            max_abs_err=err, row_ties=ties)
        check(all(equal), f"hamming_top2 {name}: outputs differ {equal}")
        errs["hamming_top2"] = max(errs["hamming_top2"], float(err))
    return errs, (da, db, ma, mb, uva, uvb)


def rot_err(Ra, Rb):
    """Angle (rad) between two rotations, from the skew part of Ra^T Rb
    in float64 (precise at the small angles compared here)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    v = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v))))


def draws_for(cfg, n_frames, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    k, n = cfg.tracking.ransac_iters, cfg.detector.max_kp
    return [draw_uniform(k, n, g, "cpu") for _ in range(n_frames - 1)]


def phase_slice(cfg, world, lefts, rights, dev):
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, metrics = vo.run_sequence(lefts, rights, world.cam, cfg,
                                     seed=SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = cuda_kernels.launch_counts()
    f = lefts.shape[0]
    want = {"fast_score": f, "hamming_top2": 2 * f - 1}
    gt = world.poses.cpu().numpy()
    ate = ate_rmse(poses, gt, align=False)
    ok_share = float(np.mean([bool(m.pnp_ok) for m in metrics]))
    path = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    say("slice", frames=f, seconds=f"{secs:.3f}", launches=counts,
        expected=want, ate_m=ate, path_m=path, pnp_ok_share=ok_share,
        mid_metrics={k: float(v) for k, v in
                     metrics[len(metrics) // 2]._asdict().items()})
    check({k: counts[k] for k in want} == want,
          f"launch counts {counts} != {want}")
    check(bool(np.isfinite(poses).all()) and poses.shape == (f, 4, 4),
          "poses not finite / wrong shape")
    check(ok_share >= 0.8, f"pnp_ok share {ok_share} < 0.8")
    check(ate < 1.0, f"ATE {ate} m >= 1.0 m")

    # CPU (plain path) vs CUDA (kernels) on the first frames, same draws.
    draws = draws_for(cfg, CPU_FRAMES, SEED + 1)
    cam_cpu = world.cam.to("cpu")
    t0 = time.perf_counter()
    p_cpu, m_cpu = vo.run_sequence(lefts[:CPU_FRAMES].cpu(),
                                   rights[:CPU_FRAMES].cpu(), cam_cpu, cfg,
                                   draws=draws)
    cpu_secs = time.perf_counter() - t0
    p_gpu, m_gpu = vo.run_sequence(lefts[:CPU_FRAMES], rights[:CPU_FRAMES],
                                   world.cam, cfg,
                                   draws=[d.to(dev) for d in draws])
    dt = float(np.abs(p_cpu[:, :3, 3] - p_gpu[:, :3, 3]).max())
    dr = max(rot_err(a[:3, :3], b[:3, :3]) for a, b in zip(p_cpu, p_gpu))
    stereo = [(int(a.num_stereo), int(b.num_stereo))
              for a, b in zip(m_cpu, m_gpu)]
    say("slice-cpu-vs-gpu", frames=CPU_FRAMES,
        cpu_seconds=f"{cpu_secs:.3f}", max_dt_m=dt, max_drot_rad=dr,
        num_stereo_cpu_gpu=stereo)
    for c, g in stereo:
        check(abs(c - g) <= 0.02 * max(c, g), f"num_stereo {c} vs {g}")
    check(dt <= 1e-2 and dr <= 1e-3, f"CPU vs GPU poses: {dt} m, {dr} rad")
    return counts, ate, ok_share


def phase_kernels_backend(dev):
    """The loop-verification slate's batched Hamming launch and the PGO
    chain sweep against their plain twins."""
    errs = {}
    rng = np.random.default_rng(3)
    b, n = SLATE_B, pipeline.KF_FEATURES
    da = rng.integers(0, 256, (b, n, 32), dtype=np.uint8)
    db = rng.integers(0, 256, (b, n, 32), dtype=np.uint8)
    da[1, 1::2] = da[1, 0::2]                   # ties within a row's top-2
    db[1, : n // 2] = da[1, : n // 2]
    ma = rng.random((b, n)) > 0.2
    mb = rng.random((b, n)) > 0.2
    ma[b - 2:] = False                          # two padded slate pairs
    mb[b - 2:] = False
    args = [torch.as_tensor(x).to(dev) for x in (da, db, ma, mb)]
    outk = cuda_kernels.hamming_top2_batched_cuda(*args)
    outp = cuda_kernels.hamming_top2_batched_plain(*args)
    torch.cuda.synchronize()
    equal = [bool(torch.equal(x, y)) for x, y in zip(outk, outp)]
    err = max((x.long() - y.long()).abs().max().item()
              for x, y in zip(outk, outp))
    pad_ok = bool((outk[0][b - 2:] == cuda_kernels.BIG).all()
                  and (outk[1][b - 2:] == cuda_kernels.BIG).all()
                  and (outk[2][b - 2:] == 0).all())
    say("kernels", kernel="hamming_top2_batched", shape=(b, n, n),
        equal_d1_d2_idx_colbest=equal, max_abs_err=err,
        padded_rows_sentinel=pad_ok, row_ties=int((outp[0] == outp[1]).sum()))
    check(all(equal) and pad_ok,
          f"hamming_top2_batched: outputs differ {equal}, padded {pad_ok}")
    errs["hamming_top2_batched"] = float(err)

    rel_errs = {}
    for n_live in (CHAIN_F, CHAIN_LIVE, 2, 1):
        ops = [x.to(dev) for x in
               synthetic.chain_inputs(CHAIN_F, n_live, n_live)]
        keep_worst(errs, rel_errs,
                   check_chain(ops, n_live, f"poses={CHAIN_F}"))
    return errs, rel_errs


def keep_worst(errs, rel_errs, new):
    """Fold check_chain's {kernel: (abs, rel)} into the running maxima."""
    for name, (err, rel) in new.items():
        errs[name] = max(errs.get(name, 0.0), err)
        rel_errs[name] = max(rel_errs.get(name, 0.0), rel)


def check_chain(ops, n_live, what):
    """chain_prepare and chain_sweep against their plain twins on the
    operands (JjInv, Ji, winv, v): {kernel: (max abs error, the same
    over max |twin|)}; the relative one is what CHAIN_TOL bounds."""
    prep_k = cuda_kernels.chain_prepare_cuda(ops[0], ops[1], n_live)
    prep_p = cuda_kernels.chain_prepare_plain(ops[0], ops[1], n_live)
    xk = cuda_kernels.chain_sweep_cuda(*ops, n_live, prep=prep_k)
    xp = cuda_kernels.chain_sweep_plain(*ops, n_live)
    torch.cuda.synchronize()
    out = {}
    for name, k, p in (("chain_prepare", prep_k, prep_p),
                       ("chain_sweep", xk, xp)):
        err = (k - p).abs().max().item()
        scale = max(p.abs().max().item(), 1e-30)
        say("kernels", kernel=name, case=what, n_live=n_live,
            max_abs_err=err, max_abs=scale, rel_err=err / scale)
        check(bool(torch.isfinite(k).all()) and err <= CHAIN_TOL * scale,
              f"{name} {what} n_live={n_live}: |err| {err} vs scale {scale}")
        out[name] = (err, err / scale)
    return out


def slam_config(ba_on: bool):
    """The default config with the drain made synchronous, so that two
    passes can be compared; `ba_on` False also switches local BA off, as
    the JAX package documents."""
    cfg = SlamConfig()
    cfg = cfg.replace(bow=dataclasses.replace(cfg.bow, poll_lag_s=0.0))
    if not ba_on:
        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, local_every=0))
    return cfg


def odometry_poses(sys_):
    """The trajectory of the run's odometry alone (its `rel` twists
    chained from the identity, as chain_pose chains them), no loop
    closure: (F,4,4) numpy."""
    f = sys_.frame_count + 1
    steps = se3.inverse(se3.exp_se3(sys_.state.rel[1:f].cpu().double()))
    poses = [torch.eye(4, dtype=torch.float64)]
    for t in steps:
        poses.append(poses[-1] @ t)
    return torch.stack(poses).numpy()


def graph_cost(sys_, poses):
    """The weighted pose-graph cost of the trajectory `poses`."""
    return float(posegraph.optimize(sys_.pose_graph(poses), iters=0)[1])


def run_blocks(sys_, lefts, rights, first, ckpt_path=None):
    """Frames [first, F) through process_block in blocks of SLAM_BLOCK,
    saving a checkpoint after frame CKPT_FRAME when `ckpt_path` is
    given: the seconds the saves took."""
    t_ckpt = 0.0
    for s in range(first, lefts.shape[0], SLAM_BLOCK):
        sys_.process_block(lefts[s:s + SLAM_BLOCK], rights[s:s + SLAM_BLOCK])
        if ckpt_path and sys_.frame_count == CKPT_FRAME:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sys_.save_checkpoint(ckpt_path)
            t_ckpt = time.perf_counter() - t0
    return t_ckpt


def run_slam(cfg, world, lefts, rights, ckpt_path=None):
    """One pass of the clip through SlamSystem (bootstrap, blocks,
    finalize) with the launch counters reset just before and read just
    after: (system, poses before / after finalize, counts, seconds of
    bootstrap, loop without the checkpoint, finalize, checkpoint)."""
    sys_ = pipeline.SlamSystem(world.cam, cfg, seed=SEED, bow_train_frame=30)
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_.process(lefts[0], rights[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    t_ckpt = run_blocks(sys_, lefts, rights, 1, ckpt_path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pre = sys_.poses()
    post = sys_.finalize()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return (sys_, pre, post, cuda_kernels.launch_counts(),
            (t1 - t0, t2 - t1 - t_ckpt, t3 - t2, t_ckpt))


def slam_numbers(sys_, cfg, pre, post, gt):
    """What every SLAM pass is judged by: ATEs, loop edges with their
    distance to the ground truth, pnp_ok share and the launch counts the
    run's own bookkeeping implies."""
    f = post.shape[0]
    edges = []
    for i, j, Z, _ in sys_.loop_edges:
        Z_true = np.linalg.inv(gt[i]) @ gt[j]
        edges.append((i, j, float(np.linalg.norm(Z[:3, 3] - Z_true[:3, 3]))))
    # Gauss-Newton iterations: every live relaxation but the last entry
    # of stage_seconds["pgo"], which is finalize's.
    pgo_runs = len(sys_.stage_seconds["pgo"])
    gn_iters = ((pgo_runs - 1) * max(cfg.ba.pg_iters // 5, 3)
                + cfg.ba.pg_iters)
    want = {"fast_score": f, "hamming_top2": 2 * f - 1,
            "hamming_top2_batched": sys_.n_slates,
            "chain_prepare": gn_iters,
            "chain_sweep": gn_iters * (cfg.ba.cg_iters + 1)}
    return dict(ate_pre=ate_rmse(pre, gt, align=False),
                ate_post=ate_rmse(post, gt, align=False),
                ate_odo=ate_rmse(odometry_poses(sys_), gt, align=False),
                ok_share=float(np.mean([m.pnp_ok for m in sys_.metrics])),
                edges=edges, pgo_runs=pgo_runs, want=want)


def check_slam(name, n, counts, post):
    """The checks every SLAM pass must hold."""
    f = post.shape[0]
    for kernel, k in n["want"].items():
        check(counts[kernel] == k,
              f"{name}: {kernel} launches {counts[kernel]} != {k}")
    check(bool(np.isfinite(post).all()) and post.shape == (f, 4, 4),
          f"{name}: poses not finite / wrong shape")
    check(len(n["edges"]) >= 2, f"{name}: {len(n['edges'])} loop edges < 2")
    check(all(d < 0.5 for _, _, d in n["edges"]),
          f"{name}: loop edge off the ground truth by >= 0.5 m: {n['edges']}")
    check(n["ate_post"] <= n["ate_odo"],
          f"{name}: ATE after finalize {n['ate_post']} > odometry-only "
          f"{n['ate_odo']}")
    check(n["ok_share"] >= 0.8, f"{name}: pnp_ok share {n['ok_share']} < 0.8")


def render_loop2(dev):
    """bench.measure_slam's clip with the port's renderer."""
    cfg = SlamConfig()
    t0 = time.perf_counter()
    world = synthetic.make_world(SLAM_SEED, n_frames=SLAM_FRAMES,
                                 n_points=20 * SLAM_FRAMES,
                                 trajectory="loop2", speed=1.0, device=dev)
    lefts, rights = synthetic.render_sequence(world, cfg.image.height,
                                              cfg.image.width)
    torch.cuda.synchronize()
    say("slam-render", frames=SLAM_FRAMES, points=20 * SLAM_FRAMES,
        seconds=f"{time.perf_counter() - t0:.3f}")
    return world, lefts, rights


def phase_slam(cfg, world, lefts, rights, dev):
    f = SLAM_FRAMES
    sys_, pre, post, counts, (t_boot, t_loop, t_final, _) = run_slam(
        cfg, world, lefts, rights)
    gt = world.poses.cpu().numpy()
    n = slam_numbers(sys_, cfg, pre, post, gt)
    cost_pre, cost_post = (graph_cost(sys_, p) for p in (pre, post))
    fps = (f - 1) / t_loop
    say("slam", frames=f, bootstrap_seconds=f"{t_boot:.3f}",
        loop_seconds=f"{t_loop:.3f}", finalize_seconds=f"{t_final:.3f}",
        slam_frames_per_s=fps, launches=counts, expected=n["want"],
        slates=sys_.n_slates, verifications=len(sys_.loop_events),
        accepted=sum(e.accepted for e in sys_.loop_events),
        pgo_runs=n["pgo_runs"], loop_edges=n["edges"],
        ate_odometry_only_m=n["ate_odo"],
        ate_before_finalize_m=n["ate_pre"],
        ate_after_finalize_m=n["ate_post"],
        pose_graph_cost_before_finalize=cost_pre,
        pose_graph_cost_after_finalize=cost_post,
        pnp_ok_share=n["ok_share"],
        keyframes=int(sys_.state.kf.n), landmarks=int(sys_.state.map.cursor))
    check_slam("slam", n, counts, post)
    # finalize's 25-iteration relaxation must lower the pose-graph cost,
    # and the loop-closed trajectory must beat odometry alone. (Its ATE
    # against the live-relaxed trajectory before finalize is printed, not
    # bounded: the reference's own PGO, after 5 live iterations, lowers
    # the cost and can raise ATE by centimetres — see PERF.md.)
    check(cost_post <= cost_pre,
          f"pose-graph cost after finalize {cost_post} > {cost_pre}")

    # chain_sweep against its twin on the finished run's real pose graph
    # (1000:1 edge weights, adjoints with grown translation blocks).
    graph = posegraph.PoseGraph(*[x.to(dev) for x in
                                  sys_.pose_graph(post)])
    g = torch.Generator(device="cpu").manual_seed(SLAM_SEED)
    chain_errs, chain_rel = {}, {}
    for name, poses in (("after-finalize", post), ("before-finalize", pre)):
        at = graph._replace(poses=torch.as_tensor(poses, device=dev))
        jj_inv, ji_c, winv = posegraph.chain_operands(at)
        v = torch.randn(f, 6, generator=g).to(dev)
        keep_worst(chain_errs, chain_rel,
                   check_chain([jj_inv, ji_c, winv, v], f,
                               f"run-graph-{name}"))
    return sys_, counts, (chain_errs, chain_rel), dict(
        slam_frames_per_s=fps, slam_ate_odometry_m=n["ate_odo"],
        slam_ate_before_m=n["ate_pre"], slam_ate_after_m=n["ate_post"],
        slam_pnp_ok_share=n["ok_share"], slam_loop_edges=len(n["edges"]),
        slam_slates=sys_.n_slates)


def phase_slam_ba(cfg, world, lefts, rights, off, tmp, late):
    """This slice's path: the clip at the default config (local BA on),
    two passes, a checkpoint at CKPT_FRAME in each (a checkpoint consumes
    its poll's verification at once, so it is part of the run). Its
    profiler session goes into `late`."""
    f = lefts.shape[0]
    gt = world.poses.cpu().numpy()
    path = os.path.join(tmp, "ckpt.npz")
    sys_, pre, post, counts, (_, t_loop, t_final, t_ckpt) = run_slam(
        cfg, world, lefts, rights, ckpt_path=path)
    n = slam_numbers(sys_, cfg, pre, post, gt)
    kf_n = sys_.metrics[-1].kf_n
    windows = (kf_n - 1) // cfg.ba.local_every
    costs = torch.stack(sys_.ba_costs).cpu().numpy() if sys_.ba_costs else []
    fps = (f - 1) / t_loop
    say("slam-ba", frames=f, loop_seconds=f"{t_loop:.3f}",
        finalize_seconds=f"{t_final:.3f}",
        checkpoint_save_seconds=f"{t_ckpt:.3f}",
        checkpoint_mb=os.path.getsize(path) / 1e6,
        slam_frames_per_s=fps, slam_frames_per_s_ba_off=off[
            "slam_frames_per_s"], launches=counts, expected=n["want"],
        local_ba_windows=len(costs), expected_windows=windows,
        ba_cost_first_median_last=[float(costs[0]), float(np.median(costs)),
                                   float(costs[-1])],
        slates=sys_.n_slates, pgo_runs=n["pgo_runs"], loop_edges=n["edges"],
        ate_odometry_only_m=n["ate_odo"], ate_before_finalize_m=n["ate_pre"],
        ate_after_finalize_m=n["ate_post"],
        ate_ba_off_odometry_before_after_m=[
            off["slam_ate_odometry_m"], off["slam_ate_before_m"],
            off["slam_ate_after_m"]], pnp_ok_share=n["ok_share"],
        keyframes=kf_n, landmarks=int(sys_.state.map.cursor))
    check(len(costs) == windows and windows > 0,
          f"{len(costs)} local BA windows, the keyframe count implies "
          f"{windows}")
    check(bool(np.isfinite(costs).all()), "a local BA cost is not finite")
    check_slam("slam-ba", n, counts, post)

    # Every scatter-add of BA sums in float64: a second pass over the
    # same clip gives the same poses.
    sys2, pre2, post2, counts2, (_, t_loop2, _, _) = run_slam(
        cfg, world, lefts, rights, ckpt_path=os.path.join(tmp, "ckpt2.npz"))
    ate_pre2 = ate_rmse(pre2, gt, align=False)
    ate_post2 = ate_rmse(post2, gt, align=False)
    costs2 = torch.stack(sys2.ba_costs).cpu().numpy()
    moved = np.nonzero(costs2 != costs)[0]
    say("slam-ba-repeat", slam_frames_per_s=(f - 1) / t_loop2,
        first_window_with_another_cost=(int(moved[0]) if len(moved)
                                        else None),
        ate_before_finalize_m=ate_pre2, ate_after_finalize_m=ate_post2,
        max_abs_pose_diff=float(np.abs(post - post2).max()),
        loop_edges=len(sys2.loop_edges), launches_equal=counts2 == counts)
    check(abs(ate_pre2 - n["ate_pre"]) <= SAME_ATE_TOL
          and abs(ate_post2 - n["ate_post"]) <= SAME_ATE_TOL,
          f"two runs differ: ATE {n['ate_pre']}/{n['ate_post']} vs "
          f"{ate_pre2}/{ate_post2}")
    del sys2

    # One warm windowed BA on the finished state: host syncs and time.
    st, cam = sys_.state, sys_.cam
    end = kf_n // 2
    syncs, where = count_syncs(
        lambda: pipeline.local_ba_step(st, cam, cfg, end_kf=end))
    ba_ms = event_ms(lambda: pipeline.local_ba_step(st, cam, cfg, end_kf=end),
                     reps=10, warm=2)
    say("slam-ba-step", local_ba_step_ms=ba_ms, host_syncs=syncs,
        sync_lines=where, window=cfg.ba.window,
        observation_slots=cfg.ba.window * cfg.mapping.obs_per_frame,
        lm_iters=cfg.ba.local_lm_iters)
    check(syncs == 0, f"local_ba_step made {syncs} host syncs: {where}")

    def profiled():
        busy = device_busy_ms(
            lambda: pipeline.local_ba_step(st, cam, cfg, end_kf=end))
        say("slam-ba-step-profile", local_ba_step_device_busy_ms=busy)
        return dict(local_ba_step_device_busy_ms=busy)
    late.append(profiled)
    return sys_, post, counts, path, dict(
        slam_ba_frames_per_s=fps,
        slam_ba_frames_per_s_second_run=(f - 1) / t_loop2,
        slam_ba_ate_odometry_m=n["ate_odo"], slam_ba_ate_before_m=n["ate_pre"],
        slam_ba_ate_after_m=n["ate_post"], slam_ba_loop_edges=len(n["edges"]),
        slam_ba_windows=len(costs), local_ba_step_ms=ba_ms,
        local_ba_step_syncs=syncs, checkpoint_save_s=t_ckpt)


def phase_checkpoint(cfg, world, lefts, rights, path, straight):
    """Resume from the snapshot of frame CKPT_FRAME and run the rest of
    the clip: the final poses against the straight run's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_ = pipeline.SlamSystem.resume(path, world.cam.to("cpu"), cfg)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(sys_.state.traj.is_cuda and sys_.frame_count == CKPT_FRAME,
          "resume: the state is not on the card or not at the snapshot")
    run_blocks(sys_, lefts, rights, CKPT_FRAME + 1)
    post = sys_.finalize()
    diff = float(np.abs(post[:, :3, 3] - straight[:, :3, 3]).max())
    say("checkpoint", resumed_at=CKPT_FRAME, load_seconds=f"{t_load:.3f}",
        frames_after=lefts.shape[0] - 1 - CKPT_FRAME,
        max_abs_position_diff_m=diff, loop_edges=len(sys_.loop_edges),
        local_ba_windows_after=len(sys_.ba_costs))
    check(post.shape == straight.shape and diff <= RESUME_TOL,
          f"resumed run is {diff} m off the straight run")
    return dict(checkpoint_load_s=t_load, resume_max_diff_m=diff)


def bound_ba_matvec(o, c, l, e):
    """One product of the reduced camera system with x (C,6): the
    coupling blocks W (O,6,3) and both index vectors read once, Hll^-1
    (L,3,3), Hcc (C,6,6) and x read and the result written once, the
    priors' two Jacobians (E,6,6), weights and indices read once; 72
    operations per observation (two 6x3 products), 18 per landmark, 72
    per camera, 288 per prior edge."""
    n_bytes = (o * (18 * 4 + 2 * 8) + l * 36 + c * (36 + 6 + 6) * 4
               + e * (2 * 36 * 4 + 4 + 2 * 8))
    return bound(n_bytes, 72 * o + 18 * l + 72 * c + 288 * e, PEAK_F32_FLOPS)


def phase_global_ba(cfg, sys_, world):
    """Global BA with pose priors on the finished state, as the CLI's
    offline pass drives it."""
    st = sys_.state
    f = sys_.frame_count + 1
    gt = world.poses.cpu().numpy()
    n_kf = int(st.kf.n)
    bucket = min(next((b for b in (128, 512, 2048, 8192) if b >= n_kf),
                      n_kf), st.kf.xyz.shape[0])
    n_obs_real = int(torch.sum(st.map.obs_count[:bucket]))
    obs_bucket = 1 << max(int(np.ceil(np.log2(max(n_obs_real, 1)))), 10)
    loop_rows = sys_.loop_edge_rows()
    ate_before = ate_rmse(sys_.poses(), gt, align=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, cost, trace = pipeline.global_ba_step(
        st, sys_.cam, cfg, n_kf=bucket, obs_bucket=obs_bucket,
        return_trace=True, loop_rows=loop_rows)
    torch.cuda.synchronize()
    call_ms = 1e3 * (time.perf_counter() - t0)
    poses = new.traj[:f].cpu().numpy()
    ate_after = ate_rmse(poses, gt, align=False)
    tr = {k: getattr(trace, k).cpu().numpy().tolist() for k in trace._fields}
    cost = float(cost)

    # One CG matvec of the reduced system at the initial point.
    prob, _ = pipeline.build_global_problem(
        st, bucket, obs_bucket, loop_rows=loop_rows,
        prior_odo_weight=cfg.ba.prior_odo_weight,
        prior_loop_weight=cfg.ba.prior_loop_weight)
    _, r0, hw = ba._cost(prob, sys_.cam, cfg.ba.huber_delta)
    r, Jc, Jl, w = ba._linearize(prob, sys_.cam, prob.w * hw)
    lam = torch.full((), cfg.ba.lm_lambda0, device=r.device)
    matvec, btil, _, _ = ba._reduced_system(prob, r, Jc, Jl, w, lam)
    mv_ms = event_ms(lambda: matvec(btil), reps=20, warm=3)
    mv_device_ms = graph_ms(lambda: matvec(btil))
    lin_ms = event_ms(lambda: ba._linearize(prob, sys_.cam, prob.w * hw),
                      reps=10, warm=2)
    o, c, l, e = (prob.uv.shape[0], prob.poses.shape[0],
                  prob.points.shape[0], prob.pe_i.shape[0])
    mv_bound_ms, mv_by = bound_ba_matvec(o, c, l, e)
    iters = cfg.ba.lm_iters
    say("global-ba", keyframes=n_kf, camera_rows=bucket,
        observations=n_obs_real, observation_bucket=obs_bucket,
        weighted_observations=int(prob.w.sum()), landmark_rows=l,
        prior_edges=e, lm_iters=iters, cg_iters=cfg.ba.cg_iters,
        call_ms=call_ms, ms_per_lm_iteration=call_ms / iters,
        matvecs_per_call=iters * (cfg.ba.cg_iters + 1),
        matvec_ms=mv_ms, matvec_device_ms=mv_device_ms,
        matvec_bound_ms=mv_bound_ms, matvec_bound_by=mv_by,
        matvec_share_of_bound=mv_bound_ms / mv_device_ms,
        linearize_ms=lin_ms, final_cost=cost, trace=tr,
        ate_before_m=ate_before, ate_after_m=ate_after)
    check(math.isfinite(cost) and cost <= tr["cost"][0],
          f"global BA cost {cost} not finite or above the first trace "
          f"entry {tr['cost'][0]}")
    check(any(tr["accept"]), "global BA accepted no step")
    check(bool(np.isfinite(poses).all()) and ate_after <= 1.05 * ate_before,
          f"global BA moved keyframe ATE {ate_before} -> {ate_after}")
    return dict(global_ba_ms_per_lm_iteration=call_ms / iters,
                global_ba_observations=n_obs_real,
                global_ba_matvec_ms=mv_ms,
                global_ba_matvec_device_ms=mv_device_ms,
                global_ba_matvec_bound_ms=mv_bound_ms,
                global_ba_linearize_ms=lin_ms,
                global_ba_accepted=int(sum(tr["accept"])),
                global_ba_cost_first_last=[tr["cost"][0], cost],
                global_ba_ate_before_m=ate_before,
                global_ba_ate_after_m=ate_after)


def fetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("slam-fetch")]


def phase_async(world, lefts, rights):
    """The default config unchanged (asynchronous drain, BA on) over the
    first ASYNC_FRAMES frames: timing decides which poll consumes what,
    so the checks are invariants."""
    cfg = SlamConfig()
    check(cfg.bow.poll_lag_s > 0 and cfg.ba.local_every > 0,
          "SlamConfig() is not the asynchronous, BA-on default")
    f = ASYNC_FRAMES
    sys_, pre, post, _, (_, t_loop, t_final, _) = run_slam(
        cfg, world, lefts[:f], rights[:f])
    frames = [m.frame for m in sys_.metrics]
    ok_share = float(np.mean([m.pnp_ok for m in sys_.metrics]))
    workers = len(fetch_threads())
    say("async", frames=f, metrics_rows=len(frames),
        slam_frames_per_s=(f - 1) / t_loop, finalize_seconds=f"{t_final:.3f}",
        local_ba_windows=len(sys_.ba_costs), loop_edges=len(sys_.loop_edges),
        pnp_ok_share=ok_share, fetch_threads_alive=workers,
        ate_m=ate_rmse(post, world.poses[:f].cpu().numpy(), align=False))
    check(frames == list(range(1, f)), "a metrics row was lost or repeated")
    check(bool(np.isfinite(post).all()), "poses not finite")
    check(ok_share >= 0.8, f"pnp_ok share {ok_share} < 0.8")
    check(len(sys_.ba_costs) == (sys_.metrics[-1].kf_n - 1)
          // cfg.ba.local_every, "a local BA window was skipped")
    check(workers == 1, f"{workers} fetch workers alive, expected 1")
    fps = (f - 1) / t_loop
    del sys_
    gc.collect()
    deadline = time.time() + 10.0
    while fetch_threads() and time.time() < deadline:
        time.sleep(0.05)
    check(not fetch_threads(), "the fetch worker outlived its system")
    return dict(async_frames_per_s=fps, async_frames=f)


def count_syncs(fn):
    """Synchronising CUDA calls fn() makes (sync debug mode "warn"):
    (count, {"file:line": n} of the Python lines that made them)."""
    torch.cuda.synchronize()
    # Switched on outside the recording: switching it on warns itself.
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    where = {}
    for r in rec:
        if "synchroniz" in str(r.message):
            k = f"{os.path.basename(r.filename)}:{r.lineno}"
            where[k] = where.get(k, 0) + 1
    return sum(where.values()), where


def phase_slam_cpu_vs_gpu(cfg, world, lefts, rights, dev):
    """The first CPU_FRAMES of slam_step on CPU (plain path) and on CUDA
    (kernels) with the same draws; then the host syncs of a warm step."""
    out = {}
    for name, device in (("cpu", torch.device("cpu")), ("gpu", dev)):
        draws = pipeline.DrawSource(SEED + 1, device, gen_device="cpu")
        L, R = lefts[:CPU_FRAMES].to(device), rights[:CPU_FRAMES].to(device)
        cam = world.cam.to(device)
        t0 = time.perf_counter()
        st = pipeline._init_state(L[0], R[0], cam, cfg, draws)
        per = []
        for i in range(1, CPU_FRAMES):
            st, row, _ = pipeline.slam_step(st, L[i], R[i], cam, cfg, draws)
            per.append((int(row[5]), int(st.kf.n), int(st.map.cursor),
                        st.T_w_cam.cpu().numpy()))
        out[name] = (per, time.perf_counter() - t0, st, draws, cam)
    cpu, gpu = out["cpu"][0], out["gpu"][0]
    dt = max(float(np.abs(a[3][:3, 3] - b[3][:3, 3]).max())
             for a, b in zip(cpu, gpu))
    triples = [(a[:3], b[:3]) for a, b in zip(cpu, gpu)]
    say("slam-cpu-vs-gpu", frames=CPU_FRAMES,
        cpu_seconds=f"{out['cpu'][1]:.3f}", max_dt_m=dt,
        stereo_kfn_cursor_cpu_gpu=triples)
    for a, b in triples:
        for x, y in zip(a, b):
            check(abs(x - y) <= 0.02 * max(x, y), f"CPU vs GPU {a} vs {b}")
    check(dt <= 1e-2, f"CPU vs GPU poses: {dt} m")

    # Six frames are too few for a BA window: one bundle_adjust of the
    # seeded 6-camera, 120-point problem on CPU and on CUDA tensors.
    p, _, _, bcam = synthetic.ba_problem(0, px_noise=0.3, n_outliers=40,
                                         device="cpu")
    bcfg = dataclasses.replace(cfg.ba, lm_iters=6)
    out_c, cost_c, tr_c = ba.bundle_adjust(p, bcam, bcfg, return_trace=True)
    out_g, cost_g, tr_g = ba.bundle_adjust(
        ba.BAProblem(*[x.to(dev) for x in p]), bcam.to(dev), bcfg,
        return_trace=True)
    d_ba = float((out_g.poses.cpu() - out_c.poses)[:, :3, 3].abs().max())
    say("ba-cpu-vs-gpu", cameras=p.poses.shape[0], points=p.points.shape[0],
        observations=p.uv.shape[0], accept_cpu=tr_c.accept.tolist(),
        accept_gpu=tr_g.accept.tolist(), cost_cpu=float(cost_c),
        cost_gpu=float(cost_g), max_abs_position_diff_m=d_ba)
    check(tr_c.accept.tolist() == tr_g.accept.tolist(),
          "bundle_adjust: accept sequences differ between CPU and CUDA")
    check(d_ba <= BA_TOL, f"bundle_adjust CPU vs CUDA poses: {d_ba} m")

    # Warm steps with their draws made on the card, as SlamSystem and
    # vo_step make them (draws copied from the host would add syncs).
    _, _, st, _, cam = out["gpu"]
    n = CPU_FRAMES
    draws = pipeline.DrawSource(SEED, dev)

    def one_slam_step():
        pipeline.slam_step(st, lefts[n], rights[n], cam, cfg, draws)

    vs = vo.init_state(lefts[0], rights[0], cam, cfg, SEED)
    vs, _ = vo.vo_step(vs, lefts[1], rights[1], cam, cfg)
    slam_syncs, slam_where = count_syncs(one_slam_step)
    vo_syncs, vo_where = count_syncs(
        lambda: vo.vo_step(vs, lefts[2], rights[2], cam, cfg))
    say("slam-syncs", vo_step=vo_syncs, slam_step=slam_syncs,
        vo_step_lines=vo_where, slam_step_lines=slam_where)
    check(slam_syncs <= vo_syncs,
          f"slam_step syncs {slam_syncs} > vo_step's {vo_syncs}")
    return vo_syncs, slam_syncs


def flow_stage(cfg, lefts, rights):
    """The two dense stages of one flow VO step on frame 3 of the clip,
    as vo_step calls them: closures of the disparity of the new pair and
    of LK tracking of frame 2's corners into frame 3."""
    fc = cfg.flow
    prev_s = vo_flow._smooth_for_lk(lefts[2], cfg)
    cur_s = vo_flow._smooth_for_lk(lefts[3], cfg)
    xy, mask = vo_flow._detect_corners(lefts[2], cfg)
    return (lambda: vo_flow._dense_disparity(lefts[3], rights[3], cfg),
            lambda: lk.lk_track(prev_s, cur_s, xy, mask, win=fc.win,
                                levels=fc.levels, iters=fc.iters,
                                max_err=fc.max_err))


def phase_flow(cfg, world, lefts, rights, dev, vo_ate, late):
    """The second VO frontend (FAST corners, pyramidal LK, dense SGM
    disparity, RANSAC-PnP) over the arc clip on CUDA tensors, the launch
    counters reset just before; the first frames on CPU tensors against
    CUDA with the same draws; then its times (its profiler sessions go
    into `late`)."""
    f = lefts.shape[0]
    gt = world.poses.cpu().numpy()
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, metrics = vo_flow.run_sequence(lefts, rights, world.cam, cfg,
                                          seed=SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = cuda_kernels.launch_counts()
    want = {k: 0 for k in counts}
    want["fast_score"] = f                 # the one-level entry, init too
    ate = ate_rmse(poses, gt, align=False)
    ok_share = float(np.mean([bool(m.pnp_ok) for m in metrics]))
    say("flow", frames=f, seconds=f"{secs:.3f}", launches=counts,
        expected=want, ate_m=ate, vo_slice_ate_m=vo_ate,
        pnp_ok_share=ok_share,
        num_tracked=[int(m.num_tracked) for m in metrics],
        num_stereo=[int(m.num_stereo) for m in metrics],
        num_inliers=[int(m.num_inliers) for m in metrics])
    check(counts == want, f"flow launch counts {counts} != {want}")
    check(bool(np.isfinite(poses).all()) and poses.shape == (f, 4, 4),
          "flow poses not finite / wrong shape")
    check(ok_share >= FLOW_PNP_OK,
          f"flow pnp_ok share {ok_share} < {FLOW_PNP_OK}")

    # CPU (plain path) vs CUDA (kernel) on the first frames, same draws.
    n = vo_flow._detect_corners(lefts[0], cfg)[0].shape[0]
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    draws = [draw_uniform(cfg.tracking.ransac_iters, n, g, "cpu")
             for _ in range(CPU_FRAMES - 1)]
    t0 = time.perf_counter()
    p_cpu, m_cpu = vo_flow.run_sequence(
        lefts[:CPU_FRAMES].cpu(), rights[:CPU_FRAMES].cpu(),
        world.cam.to("cpu"), cfg, draws=draws)
    cpu_secs = time.perf_counter() - t0
    p_gpu, m_gpu = vo_flow.run_sequence(
        lefts[:CPU_FRAMES], rights[:CPU_FRAMES], world.cam, cfg,
        draws=[d.to(dev) for d in draws])
    dt = float(np.abs(p_cpu[:, :3, 3] - p_gpu[:, :3, 3]).max())
    dr = max(rot_err(a[:3, :3], b[:3, :3]) for a, b in zip(p_cpu, p_gpu))
    pairs = {k: [(int(getattr(a, k)), int(getattr(b, k)))
                 for a, b in zip(m_cpu, m_gpu)]
             for k in ("num_tracked", "num_stereo")}
    say("flow-cpu-vs-gpu", frames=CPU_FRAMES, cpu_seconds=f"{cpu_secs:.3f}",
        max_dt_m=dt, max_drot_rad=dr, cpu_gpu=pairs)
    for k, v in pairs.items():
        for c, g_ in v:
            check(abs(c - g_) <= 0.02 * max(c, g_), f"flow {k} {c} vs {g_}")
    check(dt <= 1e-2 and dr <= 1e-3,
          f"flow CPU vs GPU poses: {dt} m, {dr} rad")

    # Warm times: the per-frame loop, one step, its two dense stages.
    state = vo_flow.init_state(lefts[0], rights[0], world.cam, cfg, SEED)
    for i in range(1, 3):
        state, _ = vo_flow.vo_step(state, lefts[i], rights[i], world.cam, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, f):
        state, _ = vo_flow.vo_step(state, lefts[i], rights[i], world.cam, cfg)
    torch.cuda.synchronize()
    fps = (f - 1) / (time.perf_counter() - t0)

    def step():
        vo_flow.vo_step(state, lefts[5], rights[5], world.cam, cfg)
    disp, track = flow_stage(cfg, lefts, rights)
    step_ms = event_ms(step, reps=5, warm=1)
    disp_ms = event_ms(disp, reps=5, warm=1)
    lk_ms = event_ms(track, reps=10, warm=2)
    d = cfg.disparity
    say("flow-times", flow_frames_per_s=fps, vo_step_ms=step_ms,
        disparity_ms=disp_ms, lk_track_ms=lk_ms, max_disp=d.max_disp,
        radius=d.radius, sgm_columns=cfg.image.width,
        lk=dataclasses.asdict(cfg.flow))
    check(math.isfinite(fps) and fps > 0, "flow fps not measured")

    def profiled():
        """Device-busy ms and launches; the disparity is timed again
        after the sessions, against its time before any session."""
        out = dict(flow_vo_step_device_busy_ms=device_busy_ms(step, reps=2),
                   flow_disparity_device_busy_ms=device_busy_ms(disp, reps=2),
                   flow_disparity_launches=device_launches(disp),
                   flow_lk_track_launches=device_launches(track),
                   flow_disparity_ms_after_profiler=event_ms(disp, reps=5,
                                                             warm=1))
        say("flow-profile", **out)
        return out
    late.append(profiled)
    return counts, dict(
        flow_frames_per_s=fps, flow_ate_m=ate, flow_pnp_ok_share=ok_share,
        flow_vo_step_ms=step_ms, flow_disparity_ms=disp_ms,
        flow_lk_track_ms=lk_ms)


def slam_torch(*argv, timeout=900):
    """`python -m slam1_tpu_torch.cli argv...` in a subprocess from the
    repo root, as a user runs it: (its last stdout line as JSON, the
    kernel launch counts it printed on stderr, seconds, its stderr)."""
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    r = subprocess.run([sys.executable, "-m", "slam1_tpu_torch.cli",
                        *argv], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    check(r.returncode == 0, f"slam-torch {' '.join(argv)} exited "
          f"{r.returncode}: {r.stderr[-3000:]}")
    launches = [json.loads(line)["kernel_launches"]
                for line in r.stderr.splitlines()
                if line.startswith('{"kernel_launches"')]
    decoder = [line.split(": ", 1)[1] for line in r.stderr.splitlines()
               if line.startswith("decoder: ")]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    say("cli-call", args=" ".join(argv[:1] + tuple(
        a for a in argv[1:] if a.startswith("--"))),
        seconds=f"{secs:.3f}", launches=launches[-1] if launches else None,
        decoder=decoder[-1] if decoder else None,
        result={k: v for k, v in out.items() if k != "timing"})
    return out, (launches[-1] if launches else None), secs, r.stderr


def phase_cli(world, lefts, rights, tmp):
    """The user's entry points on a KITTI-layout sequence: the first
    CLI_FRAMES of the loop2 clip cropped to KITTI's image size, written
    as 8-bit grayscale PNG (P5 PGM where the native decoder does not
    build: a machine may have neither cv2 nor PIL), then
    `slam-torch run --vo-only`, `run` (SLAM, checkpoints, metrics),
    `eval`, `ba --state` and `ba` in subprocesses."""
    cfg = SlamConfig()
    f = CLI_FRAMES
    h, w = CLI_CROP
    hw = (cfg.image.height, cfg.image.width)
    root = os.path.join(tmp, "kitti_seq")
    lib = native_loader.build_library()
    fmt = "png" if lib else "pgm"
    t0 = time.perf_counter()
    kitti.write_sequence(root, lefts[:f, :h, :w].cpu().numpy(),
                         rights[:f, :h, :w].cpu().numpy(), world.cam,
                         world.poses[:f].cpu().numpy(), fmt=fmt)
    write_s = time.perf_counter() - t0
    poses_txt = os.path.join(root, "poses.txt")
    seq = kitti.KittiSequence(root, hw, poses_path=poses_txt)
    decoder = kitti.decoder_for(seq.lefts[0])
    t0 = time.perf_counter()
    frames = list(seq.frames())
    decode_s = time.perf_counter() - t0
    check(len(frames) == f and frames[0][0].shape == hw
          and float(frames[0][0][h:].max()) == 0.0
          and float(frames[0][0][:, w:].max()) == 0.0,
          "the decoded sequence is not the padded canvas")
    native_equal = None
    if lib:
        pairs = list(native_loader.stereo_frames(
            seq.lefts[:NATIVE_PAIRS], seq.rights[:NATIVE_PAIRS], *hw))
        native_equal = len(pairs) == NATIVE_PAIRS and all(
            np.array_equal(a, c) and np.array_equal(b, d)
            for (a, b), (c, d) in zip(pairs, frames))
    say("cli-data", frames=f, crop=CLI_CROP, canvas=hw, format=fmt,
        decoder=decoder, native_library=bool(lib),
        native_equals_python_loader=native_equal,
        write_seconds=f"{write_s:.3f}", decode_seconds=f"{decode_s:.3f}")
    check(native_equal in (None, True),
          "native stereo_frames differ from KittiSequence.frames()")

    vo_npy = os.path.join(tmp, "vo.npy")
    out, vo_launches, _, _ = slam_torch("run", "--data", root, "--poses",
                                     poses_txt, "--vo-only", "--out", vo_npy)
    L = torch.as_tensor(np.stack([a for a, _ in frames])).cuda()
    R = torch.as_tensor(np.stack([b for _, b in frames])).cuda()
    ref, _ = vo.run_sequence(L, R, seq.cam, cfg, seed=0)
    del L, R
    same = bool(np.array_equal(np.load(vo_npy), ref))
    say("cli-vo-only", frames=out["frames"], equals_in_process=same,
        max_abs_diff=float(np.abs(np.load(vo_npy) - ref).max()),
        ate_rmse_m=out["ate_rmse_m"], decoder=out.get("decoder"))
    check(same, "`run --vo-only` differs from vo.run_sequence in process")
    check(vo_launches is not None and vo_launches == {
        **{k: 0 for k in vo_launches},
                          "fast_score": f, "hamming_top2": 2 * f - 1},
          f"`run --vo-only` launches {vo_launches}")

    traj = os.path.join(tmp, "traj.npy")
    ckdir = os.path.join(tmp, "ckpt")
    mpath = os.path.join(tmp, "metrics.jsonl")
    run, counts, run_s, _ = slam_torch(
        "run", "--data", root, "--poses", poses_txt, "--out", traj,
        "--metrics", mpath, "--checkpoint-every", str(CLI_CKPT_EVERY),
        "--checkpoint-dir", ckdir)
    timing = run["timing"]["frame"]
    fps = timing["count"] / timing["total_s"]
    rows = len(open(mpath).readlines())
    say("cli-run", frames=run["frames"], ate_rmse_m=run["ate_rmse_m"],
        rpe_trans_m=run["rpe_trans_m"], loop_closures=run["loop_closures"],
        frames_per_s=fps, seconds=f"{run_s:.3f}", metrics_rows=rows,
        checkpoints=sorted(os.listdir(ckdir)), launches=counts)
    check(run["frames"] == f and math.isfinite(run["ate_rmse_m"])
          and run["ate_rmse_m"] < 1.0 and "loop_closures" in run,
          f"`run` line {run}")
    check(counts is not None and counts["fast_score"] == f
          and counts["hamming_top2"] == 2 * f - 1, f"`run` launches {counts}")
    check(rows > 0, "`run --metrics` wrote no row")

    ev, _, _, _ = slam_torch("eval", traj, poses_txt)
    check(ev["ate_rmse_m"] == run["ate_rmse_m"],
          f"`eval` ATE {ev['ate_rmse_m']} != `run`'s {run['ate_rmse_m']}")
    ckpts = sorted(glob.glob(os.path.join(ckdir, "*.npz")))
    check(len(ckpts) > 0, "`run --checkpoint-every` wrote no checkpoint")
    bs, _, _, _ = slam_torch("ba", "--state", ckpts[-1], "--out",
                             os.path.join(tmp, "opt_state.npy"))
    check(bs["keyframes"] > 0 and math.isfinite(bs["final_cost"]),
          f"`ba --state` line {bs}")
    bd, _, _, bd_err = slam_torch("ba", "--state", ckpts[-1], "--distributed",
                                  "--lm-shards", "1", "--out",
                                  os.path.join(tmp, "opt_dist.npy"))
    say("cli-ba-distributed", result=bd,
        backend_line=[ln for ln in bd_err.splitlines()
                      if ln.startswith("torch.distributed")])
    check(bd["keyframes"] == bs["keyframes"]
          and math.isfinite(bd["final_cost"]) and bd["dropped_obs"] == 0
          and bd["mesh"] == {"batch": 1, "lm": 1},
          f"`ba --state --distributed` line {bd}")
    bt, _, _, _ = slam_torch("ba", traj, "--out",
                             os.path.join(tmp, "opt_traj.npy"))
    check(bt["frames"] == f and math.isfinite(bt["final_cost"]),
          f"`ba` line {bt}")
    # `run --multihost` as one process of a world of one: the plain run.
    plain_npy, multi_npy = (os.path.join(tmp, x) for x in ("p.npy", "m.npy"))
    slam_torch("run", "--synthetic", str(MULTIHOST_FRAMES), "--out",
               plain_npy)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    _, _, _, mh_err = slam_torch(
        "run", "--synthetic", str(MULTIHOST_FRAMES), "--out", multi_npy,
        "--multihost", "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", "1", "--process-id", "0")
    rank_line = [ln for ln in mh_err.splitlines()
                 if ln.startswith("multihost: process")]
    same = bool(np.array_equal(np.load(plain_npy), np.load(multi_npy)))
    say("cli-multihost", rank_line=rank_line, equals_plain_run=same)
    check(rank_line == ["multihost: process 0/1, device cuda:0"] and same,
          f"`run --multihost`: rank line {rank_line}, equal poses {same}")
    return counts, dict(cli_frames_per_s=fps, cli_ate_m=run["ate_rmse_m"],
                        cli_loop_closures=run["loop_closures"],
                        cli_decoder=decoder, cli_format=fmt,
                        cli_ba_state_keyframes=bs["keyframes"],
                        cli_ba_state_final_cost=bs["final_cost"],
                        cli_ba_distributed_final_cost=bd["final_cost"])


def time_kernel(name, plain, kern, bound_ms, bound_by, plain_reps=10):
    """Times of one kernel's unit of work, in turns plain, kernel,
    kernel, plain: `ms` the device time (CUDA graph replay), `eager_ms`
    the wrapper called eagerly, `plain_ms` the plain twin (eager), and
    the share of the bound that `ms` reaches."""
    runs = {"plain": [], "ms": [], "eager": []}
    for which in ("plain", "cuda", "cuda", "plain"):
        if which == "plain":
            runs["plain"].append(event_ms(plain, reps=plain_reps, warm=2))
        else:
            runs["ms"].append(graph_ms(kern))
            runs["eager"].append(event_ms(kern))
    out = {"ms": float(np.mean(runs["ms"])),
           "eager_ms": float(np.mean(runs["eager"])),
           "plain_ms": float(np.mean(runs["plain"])),
           "bound_ms": bound_ms, "bound_by": bound_by}
    say("times", kernel=name, per=KERNELS[name][2], kernel_ms=out["ms"],
        eager_ms=out["eager_ms"], plain_ms=out["plain_ms"],
        bound_us=1e3 * bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / out["ms"])
    return out


def phase_times_slam(cfg, sys_, world):
    """ms per place_query, slate and PGO on the final SLAM state, the
    backend's kernels against their plain twins, and the per-stage host
    times of the SLAM run."""
    st = sys_.state
    kf_n = int(st.kf.n)
    q_row = kf_n - 1
    q_frame = int(st.kf.frame_of_row[q_row])
    n_rows = next(b for b in (128, 512, 1024, 2048, 8192) if b >= kf_n)
    bcfg = cfg.bow
    pq_ms = event_ms(lambda: place_query(
        st.kf, q_row, q_frame - bcfg.query_exclude, n_rows,
        k=bcfg.place_topk, thresh=bcfg.place_thresh,
        nms_frames=bcfg.place_nms_frames), reps=5, warm=1)
    pairs = [(j, i) for i, j, _, _ in sys_.loop_edges][:SLATE_B]
    hfs = [a for a, _ in pairs] + [0] * (SLATE_B - len(pairs))
    cs = [c for _, c in pairs] + [-1] * (SLATE_B - len(pairs))
    dev = st.kf.xyz.device
    u = sys_.draws.slate(hfs, cs, 0, pipeline.LOOP_RANSAC_ITERS,
                         pipeline.KF_FEATURES)
    slate_ms = event_ms(lambda: verify_loop_slate(
        u, st.kf, torch.tensor(cs, device=dev), torch.tensor(hfs, device=dev),
        sys_.cam, cfg), reps=5, warm=1)
    pgo = sys_.stage_seconds["pgo"]

    times = {}
    rng = np.random.default_rng(5)
    b, n = SLATE_B, pipeline.KF_FEATURES
    hargs = [torch.as_tensor(x).to(dev) for x in (
        rng.integers(0, 256, (b, n, 32), dtype=np.uint8),
        rng.integers(0, 256, (b, n, 32), dtype=np.uint8),
        rng.random((b, n)) > 0.2, rng.random((b, n)) > 0.2)]
    times["hamming_top2_batched"] = time_kernel(
        "hamming_top2_batched",
        lambda: cuda_kernels.hamming_top2_batched_plain(*hargs),
        lambda: cuda_kernels.hamming_top2_batched_cuda(*hargs),
        *bound_hamming(b, n, n, gated=False))
    cargs = [x.to(dev)
             for x in synthetic.chain_inputs(CHAIN_F, CHAIN_LIVE, 1)]
    prep = cuda_kernels.chain_prepare_cuda(cargs[0], cargs[1], CHAIN_LIVE)
    times["chain_prepare"] = time_kernel(
        "chain_prepare",
        lambda: cuda_kernels.chain_prepare_plain(cargs[0], cargs[1],
                                                 CHAIN_LIVE),
        lambda: cuda_kernels.chain_prepare_cuda(cargs[0], cargs[1],
                                                CHAIN_LIVE),
        *bound_chain_prepare(CHAIN_F, CHAIN_LIVE))
    times["chain_sweep"] = time_kernel(
        "chain_sweep",
        lambda: cuda_kernels.chain_sweep_plain(*cargs, CHAIN_LIVE),
        lambda: cuda_kernels.chain_sweep_cuda(*cargs, CHAIN_LIVE, prep=prep),
        *bound_chain_sweep(CHAIN_F, CHAIN_LIVE), plain_reps=3)
    stage = {k: (1e3 * float(np.median(v)) if v else None, len(v))
             for k, v in sys_.stage_seconds.items()}
    live = [1e3 * t for t in pgo[:-1]]
    say("times-slam", place_query_ms=pq_ms, place_query_rows=n_rows,
        slate_ms=slate_ms, slate_pairs=len(pairs),
        pgo_ms_median_live=float(np.median(live)) if live else None,
        pgo_ms_live=live, pgo_runs=len(pgo),
        pgo_ms_finalize=1e3 * pgo[-1] if pgo else None,
        run_stage_ms_median_and_count=stage)
    return times, dict(place_query_ms=pq_ms, slate_ms=slate_ms,
                       pgo_ms_median_live=(float(np.median(live))
                                           if live else None),
                       pgo_ms_finalize=1e3 * pgo[-1] if pgo else None)


def phase_times(cfg, lefts, rights, world, hamming_inputs):
    thr, arc = cfg.detector.fast_threshold, cfg.detector.fast_arc
    imgs = pyramid(torch.stack([lefts[3], rights[3]]),
                   cfg.detector.num_levels)
    imgs = [im.contiguous() for im in imgs]
    times = {}
    times["fast_score"] = time_kernel(
        "fast_score",
        lambda: [fast.fast_score(im, thr, arc) for im in imgs],
        lambda: cuda_kernels.fast_score_levels_cuda(imgs, thr, arc),
        *bound_fast_score([im.shape for im in imgs]))

    da, db, ma, mb, uva, uvb = hamming_inputs
    mm = cfg.matcher
    r = cfg.tracking.gate_radius_px
    gates = [dict(uv_a=uva, uv_b=uvb, dy_tol=mm.epipolar_dy,
                  dx_lo=mm.min_disparity, dx_hi=mm.max_disparity),
             dict(uv_a=uva, uv_b=uvb, dy_tol=r, dx_lo=-r, dx_hi=r)]
    n = da.shape[0]
    one_ms, by = bound_hamming(1, n, n, gated=True)
    times["hamming_top2"] = time_kernel(
        "hamming_top2",
        lambda: [cuda_kernels.hamming_top2_plain(da, db, ma, mb, **kw)
                 for kw in gates],
        lambda: [cuda_kernels.hamming_top2_cuda(da, db, ma, mb, **kw)
                 for kw in gates],
        len(gates) * one_ms, by)

    # VO frames/s of the per-frame loop (warm state, frames 1..F-1).
    state = vo.init_state(lefts[0], rights[0], world.cam, cfg, SEED)
    state, _, _ = vo.vo_block(state, lefts[1:4], rights[1:4], world.cam, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, poses, _ = vo.vo_block(state, lefts[1:], rights[1:], world.cam,
                                  cfg)
    torch.cuda.synchronize()
    fps = (lefts.shape[0] - 1) / (time.perf_counter() - t0)
    say("times", vo_frames_per_s=fps)
    check(math.isfinite(fps) and fps > 0, "VO fps not measured")
    return times, fps


def pyramid_config():
    """SlamConfig() with only the original project's ORB pyramid: scale
    1.2, 8 levels."""
    cfg = SlamConfig()
    return cfg.replace(detector=dataclasses.replace(
        cfg.detector, scale_factor=PYR_SCALE, num_levels=PYR_LEVELS))


def phase_pyramid(lefts, rights, world, dev):
    """The VO path at the 1.2 x 8 pyramid: fast_score over the 8 ragged
    levels of both images in one launch, hamming_top2 at the pyramid's
    slot count, detect_pyramid against the port's CPU run, then the VO
    slice's gates; the launch counts of the VO run."""
    cfg = pyramid_config()
    dc = cfg.detector
    thr, arc = dc.fast_threshold, dc.fast_arc
    mid = lefts.shape[0] // 2
    levels = [im.contiguous() for im in detector.pyramid_levels(
        torch.stack([lefts[mid], rights[mid]]), dc)]
    check(len(levels) == PYR_LEVELS <= cuda_kernels.FAST_MAX_LEVELS,
          f"{len(levels)} levels do not fit one fast_score launch")
    outs = cuda_kernels.fast_score_levels_cuda(levels, thr, arc)
    fast_err = 0.0
    for lvl, (im, k) in enumerate(zip(levels, outs)):
        p = fast.fast_score(im, thr, arc)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        same = bool(torch.equal(k > 0, p > 0))
        say("pyramid", kernel="fast_score", level=lvl, shape=tuple(im.shape),
            max_abs_err=err, corners=int((p > 0).sum()), masks_equal=same)
        check(same and err <= FAST_TOL,
              f"fast_score 1.2-pyramid level {lvl}: err {err}, masks {same}")
        fast_err = max(fast_err, err)

    n = dc.max_kp
    rng = np.random.default_rng(7)
    da, db = (torch.as_tensor(rng.integers(0, 256, (n, 32), dtype=np.uint8)
                              ).to(dev) for _ in range(2))
    ma, mb = (torch.as_tensor(rng.random(n) > 0.2).to(dev) for _ in range(2))
    uva = torch.as_tensor((rng.random((n, 2)) * [cfg.image.width,
                                                 cfg.image.height]
                           ).astype(np.float32)).to(dev)
    uvb = uva + torch.as_tensor(rng.normal(0, [30.0, 1.5], (n, 2)).astype(
        np.float32)).to(dev)
    mm, r = cfg.matcher, cfg.tracking.gate_radius_px
    for case, kw in (("ungated", {}),
                     ("epipolar", dict(uv_a=uva, uv_b=uvb,
                                       dy_tol=mm.epipolar_dy,
                                       dx_lo=mm.min_disparity,
                                       dx_hi=mm.max_disparity)),
                     ("window", dict(uv_a=uva, uv_b=uvb, dy_tol=r, dx_lo=-r,
                                     dx_hi=r))):
        outk = cuda_kernels.hamming_top2_cuda(da, db, ma, mb, **kw)
        outp = cuda_kernels.hamming_top2_plain(da, db, ma, mb, **kw)
        torch.cuda.synchronize()
        equal = [bool(torch.equal(x, y)) for x, y in zip(outk, outp)]
        say("pyramid", kernel="hamming_top2", case=case, shape=(n, n),
            equal_d1_d2_idx_colbest=equal)
        check(all(equal), f"hamming_top2 at {n} slots {case}: {equal}")
    # A frame's device time at this pyramid: one fast_score launch over
    # the 16 level images, two gated hamming_top2 calls at n x n.
    gates = [dict(uv_a=uva, uv_b=uvb, dy_tol=mm.epipolar_dy,
                  dx_lo=mm.min_disparity, dx_hi=mm.max_disparity),
             dict(uv_a=uva, uv_b=uvb, dy_tol=r, dx_lo=-r, dx_hi=r)]
    fast_ms = graph_ms(lambda: cuda_kernels.fast_score_levels_cuda(
        levels, thr, arc))
    ham_ms = graph_ms(lambda: [cuda_kernels.hamming_top2_cuda(
        da, db, ma, mb, **kw) for kw in gates])
    fast_bound = bound_fast_score([im.shape for im in levels])
    ham_bound = bound_hamming(2, n, n, gated=True)
    say("pyramid-times", fast_score_ms=fast_ms, fast_score_bound_ms=
        fast_bound[0], fast_score_bound_by=fast_bound[1],
        hamming_top2_2_calls_ms=ham_ms, hamming_top2_bound_ms=ham_bound[0],
        hamming_top2_bound_by=ham_bound[1])

    # detect_pyramid on frame 0, card against the port's CPU run.
    vh, vw = cfg.image.valid_height, cfg.image.valid_width
    pair = torch.stack([lefts[0], rights[0]])
    fk = detector.detect_pyramid(pair, dc, vh, vw)
    fc = detector.detect_pyramid(pair.cpu(), dc, vh, vw)
    differ = ((fk.mask.cpu() != fc.mask)
              | ((fk.xy.cpu() - fc.xy).abs().amax(-1) > 1e-3)
              | (fk.desc.cpu() != fc.desc).any(-1))
    n_diff, n_valid = int(differ.sum()), int(fc.mask.sum())
    level_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        detector.pyramid_levels(pair, dc),
        detector.pyramid_levels(pair.cpu(), dc)))
    say("pyramid", detect_pyramid_slots=tuple(fc.mask.shape),
        valid_slots=n_valid, slots_differing_from_cpu=n_diff,
        level_max_abs_diff_from_cpu=level_err)
    check(fk.mask.shape[1] == n and n_diff <= PYR_SLOT_TOL * n_valid,
          f"detect_pyramid: {n_diff} of {n_valid} slots differ from the "
          "CPU run")

    f = lefts.shape[0]
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, metrics = vo.run_sequence(lefts, rights, world.cam, cfg, seed=SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = cuda_kernels.launch_counts()
    want = {"fast_score": f, "hamming_top2": 2 * f - 1}
    ate = ate_rmse(poses, world.poses.cpu().numpy(), align=False)
    ok_share = float(np.mean([bool(m.pnp_ok) for m in metrics]))
    state = vo.init_state(lefts[0], rights[0], world.cam, cfg, SEED)
    state, _ = vo.vo_step(state, lefts[1], rights[1], world.cam, cfg)
    step_ms = event_ms(lambda: vo.vo_step(state, lefts[2], rights[2],
                                          world.cam, cfg), reps=5, warm=1)
    say("pyramid-vo", frames=f, slots=n, seconds=f"{secs:.3f}",
        launches=counts, launches_per_frame={k: v / f for k, v in
                                             counts.items()},
        expected=want, ate_m=ate, pnp_ok_share=ok_share, vo_step_ms=step_ms)
    check({k: counts[k] for k in want} == want,
          f"pyramid VO launch counts {counts} != {want}")
    check(bool(np.isfinite(poses).all()), "pyramid VO poses not finite")
    check(ok_share >= 0.8, f"pyramid VO pnp_ok share {ok_share} < 0.8")
    check(ate < 1.0, f"pyramid VO ATE {ate} m >= 1.0 m")
    return counts, fast_err, dict(
        pyramid_slots=n, pyramid_ate_m=ate, pyramid_pnp_ok_share=ok_share,
        pyramid_vo_step_ms=step_ms, pyramid_slots_differing=n_diff,
        pyramid_fast_score_ms=fast_ms, pyramid_hamming_top2_ms=ham_ms)


def rot_deg(R):
    """The angle of a rotation matrix, in degrees."""
    c = (np.trace(np.asarray(R, np.float64)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def phase_two_view(lefts, world, dev):
    """recover_pose_2d2d and dlt on the temporal matches of frames 0 ->
    TWO_VIEW_B at the default detector, on the card and on the CPU with
    the same draws. Frames 0 -> 1, not 0 -> 3: over three frames only a
    third of the gated matches fit the true geometry on this clip, so 256
    hypotheses of 8 rarely hold a clean sample and the rotation error
    varies by degrees with the draws (`tools/port_two_view_pairs.py`
    prints both per pair)."""
    cfg = SlamConfig()
    dc = cfg.detector
    vh, vw = cfg.image.valid_height, cfg.image.valid_width
    cuda_kernels.reset_launch_counts()
    feats = detector.detect_pyramid(torch.stack([lefts[0], lefts[TWO_VIEW_B]]),
                                    dc, vh, vw)
    # The tracker's temporal gate around a zero-motion prediction: the
    # clip's repeated texture defeats ungated matching over 3 frames.
    m = hamming.match_windowed(feats.desc[0], feats.desc[1], feats.xy[0],
                               feats.xy[1], feats.mask[0], feats.mask[1],
                               radius=cfg.tracking.gate_radius_px)
    uv1, uv2 = feats.xy[0], feats.xy[1][m.idx.long()]
    mask = m.mask
    g = torch.Generator(device="cpu").manual_seed(SEED)
    u = draw_uniform(TWO_VIEW_ITERS, uv1.shape[0], g, "cpu")
    K = world.cam.K
    rk = epipolar.recover_pose_2d2d(uv1, uv2, mask, K, iters=TWO_VIEW_ITERS,
                                    u=u.to(dev))
    counts = cuda_kernels.launch_counts()
    call_ms = event_ms(lambda: epipolar.recover_pose_2d2d(
        uv1, uv2, mask, K, iters=TWO_VIEW_ITERS, u=u.to(dev)), reps=3, warm=1)
    rc = epipolar.recover_pose_2d2d(uv1.cpu(), uv2.cpu(), mask.cpu(),
                                    K.cpu(), iters=TWO_VIEW_ITERS, u=u)
    Tk, Tc = rk.T.cpu().numpy(), rc.T.numpy()
    gt = world.poses.cpu().numpy().astype(np.float64)
    T_true = np.linalg.inv(gt[TWO_VIEW_B]) @ gt[0]     # camera 3 <- 0
    ang_gt = rot_deg(Tc[:3, :3].T @ T_true[:3, :3])
    t_true = T_true[:3, 3] / np.linalg.norm(T_true[:3, 3])
    same_mask = bool(torch.equal(rk.inliers.cpu(), rc.inliers))
    r_err = float(np.abs(Tk[:3, :3] - Tc[:3, :3]).max())
    t_err = float(np.abs(Tk[:3, 3] - Tc[:3, 3]).max())
    # dlt of the inliers, both sides with the CPU run's projections.
    Kc = K.cpu()
    P1 = Kc @ torch.eye(3, 4)
    P2 = Kc @ torch.as_tensor(Tc[:3])
    inl = rc.inliers
    Xk = triangulate.dlt(P1.to(dev), P2.to(dev), uv1[inl.to(dev)],
                         uv2[inl.to(dev)]).cpu()
    Xc = triangulate.dlt(P1, P2, uv1.cpu()[inl], uv2.cpu()[inl])
    dlt_rel = float(((Xk - Xc).norm(dim=-1) / Xc.norm(dim=-1)).max())
    say("two-view", frames=(0, TWO_VIEW_B), matches=int(mask.sum()),
        iters=TWO_VIEW_ITERS, inliers_card=int(rk.num_inliers),
        inliers_cpu=int(rc.num_inliers), inlier_masks_equal=same_mask,
        ok=bool(rk.ok), R_max_abs_diff=r_err, t_max_abs_diff=t_err,
        rotation_err_to_gt_deg=ang_gt,
        t_dot_gt=float(np.dot(Tc[:3, 3], t_true)),
        recover_pose_ms=call_ms, dlt_points=int(inl.sum()),
        dlt_max_rel_diff=dlt_rel, launches=counts)
    check(bool(rk.ok) and bool(rc.ok), "recover_pose_2d2d not ok")
    check(same_mask and int(rk.num_inliers) == int(rc.num_inliers),
          "two-view inlier masks / counts differ between card and CPU")
    check(r_err <= 1e-4 and t_err <= 1e-4,
          f"two-view R / t differ from the CPU run: {r_err}, {t_err}")
    check(ang_gt < 1.0, f"two-view rotation {ang_gt} deg from the truth")
    check(dlt_rel <= 1e-3, f"dlt points {dlt_rel} relative off the CPU run")
    return counts, dict(two_view_inliers=int(rc.num_inliers),
                        two_view_rotation_err_deg=ang_gt,
                        two_view_recover_pose_ms=call_ms)


def loop_segment(sys_):
    """The run's first accepted loop as a ref_backend segment: (twists
    frame k -> k+1 between the loop's frames, padded to a multiple of
    REF_PAD, valid mask, the loop edge's measurement from the earlier
    frame to the later, (first, last) frame)."""
    i, j, Z, _ = sys_.loop_edges[0]
    Z = np.asarray(Z, np.float32)
    if i > j:
        i, j, Z = j, i, np.linalg.inv(Z).astype(np.float32)
    rel = sys_.state.rel.cpu()
    n = j - i
    s = -(-n // REF_PAD) * REF_PAD
    twists = torch.zeros((s, 6))
    twists[:n] = -rel[i + 1:j + 1]       # rel[f] = log(T_f_{f-1})
    valid = torch.arange(s) < n
    return twists, valid, torch.as_tensor(Z), (i, j)


def phase_ref_backend(sys_, dev):
    """optimize_segment on the first closed loop of the run, on the card
    and on the CPU."""
    twists, valid, Z, (i, j) = loop_segment(sys_)

    def gap(tw, v):
        end = ref_backend.recompose(torch.eye(4, device=tw.device), tw, v)[-1]
        return float((end[:3, 3] - Z.to(tw.device)[:3, 3]).norm())

    before = gap(twists, valid)
    args = (twists.to(dev), valid.to(dev), Z.to(dev))
    ref_backend.optimize_segment(*args, iters=1)                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xk, ck = ref_backend.optimize_segment(*args, iters=REF_ITERS)
    torch.cuda.synchronize()
    ms_iter = 1e3 * (time.perf_counter() - t0) / REF_ITERS
    after = gap(xk, valid.to(dev))
    t0 = time.perf_counter()
    xc, cc = ref_backend.optimize_segment(twists, valid, Z, iters=REF_ITERS)
    cpu_s = time.perf_counter() - t0
    diff = float((xk.cpu() - xc).abs().max())
    say("ref-backend", loop_frames=(i, j), segment=int(valid.sum()),
        padded_to=valid.shape[0], lm_iters=REF_ITERS,
        endpoint_gap_before_m=before, endpoint_gap_after_m=after,
        cost_card=float(ck), cost_cpu=float(cc), ms_per_lm_iteration=ms_iter,
        twists_max_abs_diff_to_cpu=diff, cpu_seconds=f"{cpu_s:.3f}")
    check(bool(torch.isfinite(xk).all()), "ref_backend twists not finite")
    check(after * 10.0 <= before,
          f"endpoint gap {before} -> {after} m: not 10x smaller")
    check(diff <= 1e-3, f"ref_backend twists {diff} off the CPU run")
    return dict(ref_backend_ms_per_lm_iteration=ms_iter,
                ref_backend_gap_before_after_m=[before, after],
                ref_backend_segment=int(valid.sum()),
                ref_backend_twists_diff_to_cpu=diff)


def global_problem(sys_):
    """The CLI's global problem of the finished state (no pose priors):
    (problem, keyframe count, bucket, observation bucket, real
    observations)."""
    st = sys_.state
    n_kf = int(st.kf.n)
    bucket = min(next((b for b in (128, 512, 2048, 8192) if b >= n_kf),
                      n_kf), st.kf.xyz.shape[0])
    n_obs_real = int(torch.sum(st.map.obs_count[:bucket]))
    obs_bucket = 1 << max(int(np.ceil(np.log2(max(n_obs_real, 1)))), 10)
    prob, _ = pipeline.build_global_problem(st, bucket, obs_bucket)
    return prob, n_kf, bucket, obs_bucket, n_obs_real


def run_pose_graph(sys_):
    """The run's pose graph at its odometry-only trajectory, as
    _run_pgo sizes it (2048 rows, loop edges at MAX_LOOP_EDGES
    capacity): dict of the sharded solver's CPU arrays and n_live."""
    st = sys_.state
    n = sys_.frame_count + 1
    f = next(b for b in pipeline.PGO_BUCKETS if b >= n)
    poses = torch.eye(4).repeat(f, 1, 1)
    poses[:n] = torch.as_tensor(odometry_poses(sys_), dtype=torch.float32)
    z = torch.eye(4).repeat(f, 1, 1)
    z[:f - 1] = se3.exp_se3(-st.rel[1:f].cpu())
    w = torch.zeros(f)
    w[:f - 1] = st.rel_mask[1:f].cpu().float()
    cap = pipeline.MAX_LOOP_EDGES
    le_i, le_j = torch.zeros(cap, dtype=torch.long), torch.zeros(
        cap, dtype=torch.long)
    le_z, le_w = torch.eye(4).repeat(cap, 1, 1), torch.zeros(cap)
    for k, (i, j, Z, wt) in enumerate(sys_.loop_edges[:cap]):
        le_i[k], le_j[k], le_z[k], le_w[k] = i, j, torch.as_tensor(Z), wt
    return dict(poses=poses, z=z, w=w, le_i=le_i, le_j=le_j, le_z=le_z,
                le_w=le_w, n_live=n)


def pgo_graph(g):
    """posegraph.PoseGraph of the same edges (odometry + loop)."""
    f = g["poses"].shape[0]
    ei = torch.arange(f - 1)
    return posegraph.PoseGraph(
        poses=g["poses"], ei=torch.cat([ei, g["le_i"]]),
        ej=torch.cat([ei + 1, g["le_j"]]),
        z=torch.cat([g["z"][:f - 1], g["le_z"]]),
        w=torch.cat([g["w"][:f - 1], g["le_w"]]))


def _dist_rank(rank, world, in_path, init_file, out_path):
    """One spawned rank of the dist phase: the sharded BA and pose graph
    of the parent's problem on the card, over gloo (ranks share it)."""
    from slam1_tpu_torch.parallel import dist_ba, dist_pgo
    from slam1_tpu_torch.parallel import mesh as mesh_mod
    data = torch.load(in_path, weights_only=False)
    mesh_mod.init_multihost(f"file://{init_file}", world, rank, device="cuda",
                            timeout_s=DIST_TIMEOUT_S)
    try:
        mesh = mesh_mod.make_mesh(lm_axis=world, device="cuda")
        dev = mesh.device
        cfg = data["cfg"]
        prob = ba.BAProblem(*[x.to(dev) for x in data["prob"]])
        cam = StereoCamera(*[x.to(dev) for x in data["cam"]])
        sharded, _, dropped = dist_ba.partition_problem_device(
            prob, world, data["obs_bucket"])
        g = data["graph"]
        pargs = [g[k] for k in ("poses", "z", "w", "le_i", "le_j", "le_z",
                                "le_w")]
        # One-off costs (the first collectives, first-call set-up) out of
        # the timed runs.
        dist_ba.distributed_bundle_adjust(
            sharded, cam, dataclasses.replace(cfg.ba, lm_iters=1), mesh)
        dist_pgo.optimize_sharded(*pargs, mesh=mesh, iters=1, cg_iters=1,
                                  n_live=g["n_live"])
        mesh.comm.update({k: 0 for k in mesh.comm})
        cuda_kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cost, trace = dist_ba.distributed_bundle_adjust(
            sharded, cam, cfg.ba, mesh, return_trace=True)
        torch.cuda.synchronize()
        ba_s = time.perf_counter() - t0
        ba_comm = dict(mesh.comm)
        mesh.comm.update({k: 0 for k in mesh.comm})
        t0 = time.perf_counter()
        poses, pcost = dist_pgo.optimize_sharded(
            *pargs, mesh=mesh, iters=data["pg_iters"],
            cg_iters=cfg.ba.cg_iters, n_live=g["n_live"])
        torch.cuda.synchronize()
        pgo_s = time.perf_counter() - t0
        torch.save(dict(
            poses=out.poses.cpu(), cost=float(cost), trace=trace.cpu(),
            dropped=int(dropped), ba_s=ba_s, ba_comm=ba_comm,
            pgo_poses=poses.cpu(), pgo_cost=float(pcost), pgo_s=pgo_s,
            pgo_comm=dict(mesh.comm), backend=mesh.backend,
            device=str(dev), launches=cuda_kernels.launch_counts()),
            f"{out_path}.{rank}")
    finally:
        torch.distributed.destroy_process_group()


def spawn_dist_ranks(world, data, tmp):
    """`world` ranks of _dist_rank on the one card, joined under
    DIST_TIMEOUT_S; their results by rank. A failed or late rank fails
    the phase."""
    import torch.multiprocessing as mp
    in_path = os.path.join(tmp, "dist_inputs.pt")
    torch.save(data, in_path)
    init_file = os.path.join(tmp, "dist_rendezvous")
    out_path = os.path.join(tmp, "dist_rank")
    ctx = mp.start_processes(_dist_rank, args=(world, in_path, init_file,
                                               out_path),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            check(time.monotonic() <= deadline,
                  f"dist ranks did not finish in {DIST_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return [torch.load(f"{out_path}.{r}", weights_only=False)
            for r in range(world)]


def phase_dist(cfg, sys_, world, tmp):
    """The distributed layer on the finished 600-frame state: the
    partitioners, the sharded BA at one rank over NCCL (this process)
    against the single-device BA, at two ranks sharing the card over
    gloo (spawned) against one rank, and the sharded pose graph at one
    and two ranks against posegraph.optimize."""
    from slam1_tpu_torch.parallel import dist_ba, dist_pgo
    from slam1_tpu_torch.parallel import mesh as mesh_mod
    gt = world.poses.cpu().numpy()
    prob, n_kf, bucket, obs_bucket, n_obs = global_problem(sys_)
    cam = sys_.cam

    # (a) the partitioners at 1 and 2 shards
    for shards in (1, 2):
        host, horig = dist_ba.partition_problem(prob, shards)
        devp, dorig, dropped = dist_ba.partition_problem_device(
            prob, shards, obs_per_shard=obs_bucket)
        same = bool(torch.equal(host.points, devp.points)
                    and torch.equal(horig, dorig))
        for s in range(shards):
            k = int((host.w[s] > 0).sum())
            same &= k == int((devp.w[s] > 0).sum()) and all(
                torch.equal(getattr(host, name)[s, :k].to(
                    getattr(devp, name).dtype), getattr(devp, name)[s, :k])
                for name in ("cam_idx", "lm_idx", "uv", "w", "ur", "wr"))
        say("dist-partition", shards=shards, observations=n_obs,
            obs_per_shard=obs_bucket, device_equals_host=same,
            dropped=int(dropped))
        check(same and int(dropped) == 0,
              f"partition_problem_device at {shards} shards: equal {same}, "
              f"dropped {int(dropped)}")

    # (b) one rank over NCCL, in this process, against bundle_adjust
    backend = mesh_mod.init_multihost(device="cuda")
    mesh = mesh_mod.make_mesh(lm_axis=1, device="cuda")
    sharded, _, _ = dist_ba.partition_problem_device(prob, 1, obs_bucket)
    iters = cfg.ba.lm_iters
    g = run_pose_graph(sys_)
    gd = {k: (v.to(mesh.device) if torch.is_tensor(v) else v)
          for k, v in g.items()}
    pargs = [gd[k] for k in ("poses", "z", "w", "le_i", "le_j", "le_z",
                             "le_w")]
    # One-off costs (the first collectives, first-call set-up) out of the
    # timed runs.
    dist_ba.distributed_bundle_adjust(
        sharded, cam, dataclasses.replace(cfg.ba, lm_iters=1), mesh)
    dist_pgo.optimize_sharded(*pargs, mesh=mesh, iters=1, cg_iters=1,
                              n_live=g["n_live"])
    mesh.comm.update({k: 0 for k in mesh.comm})
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out1, cost1, trace1 = dist_ba.distributed_bundle_adjust(
        sharded, cam, cfg.ba, mesh, return_trace=True)
    torch.cuda.synchronize()
    d_ms = 1e3 * (time.perf_counter() - t0) / iters
    ba_comm = dict(mesh.comm)
    t0 = time.perf_counter()
    outs, costs, traces = ba.bundle_adjust(prob, cam, cfg.ba,
                                           return_trace=True)
    torch.cuda.synchronize()
    s_ms = 1e3 * (time.perf_counter() - t0) / iters
    rows = torch.arange(bucket, device=prob.poses.device) < n_kf
    frames = sys_.state.kf.frame_of_row[:bucket][rows].long().cpu().numpy()

    def kf_ate(poses):
        return ate_rmse(poses[rows].cpu().numpy(), gt[frames], align=False)

    ate0, ate1, ate_s = kf_ate(prob.poses), kf_ate(out1.poses), kf_ate(
        outs.poses)
    t1, ts = trace1.cpu().numpy(), traces.cost.cpu().numpy()
    trace_rel = float(np.max(np.abs(t1 - ts) / np.maximum(np.abs(ts), 1.0)))
    cg_steps = iters * (cfg.ba.cg_iters + 1)
    say("dist-ba-1", backend=backend, keyframes=n_kf, camera_rows=bucket,
        observations=n_obs, lm_iters=iters, cost=float(cost1),
        cost_single=float(costs), trace=t1.tolist(), trace_single=ts.tolist(),
        trace_max_rel_diff=trace_rel, kf_ate_before_m=ate0,
        kf_ate_after_m=ate1, kf_ate_single_m=ate_s,
        ms_per_lm_iteration=d_ms, ms_per_lm_iteration_single=s_ms,
        all_reduce_calls=ba_comm["all_reduce_calls"],
        all_reduce_bytes_per_cg_step=6 * 8 * bucket,
        all_reduce_bytes_total=ba_comm["all_reduce_bytes"],
        cg_steps=cg_steps, launches=cuda_kernels.launch_counts())
    check(math.isfinite(float(cost1)) and trace_rel <= DIST_TRACE_TOL,
          f"distributed BA trace {trace_rel} relative off bundle_adjust")
    check(ate1 <= 1.05 * ate0, f"distributed BA keyframe ATE {ate0} -> "
          f"{ate1}")

    # (d) the pose graph at one rank, against posegraph.optimize, at the
    # live relaxation's Gauss-Newton count
    pg_it, pg_cg = max(cfg.ba.pg_iters // 5, 3), cfg.ba.cg_iters
    mesh.comm.update({k: 0 for k in mesh.comm})
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1, pc1 = dist_pgo.optimize_sharded(*pargs, mesh=mesh, iters=pg_it,
                                        cg_iters=pg_cg, n_live=g["n_live"])
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0) / pg_it
    counts1 = cuda_kernels.launch_counts()
    pgo_comm = dict(mesh.comm)
    graph = posegraph.PoseGraph(*[x.to(mesh.device) for x in pgo_graph(g)])
    ps, pcs = posegraph.optimize(graph, iters=pg_it, cg_iters=pg_cg,
                                 n_live=g["n_live"])
    torch.distributed.destroy_process_group()
    n = g["n_live"]
    ate_odo = ate_rmse(g["poses"][:n].numpy(), gt[:n], align=False)
    ate_p1 = ate_rmse(p1[:n].cpu().numpy(), gt[:n], align=False)
    ate_ps = ate_rmse(ps[:n].cpu().numpy(), gt[:n], align=False)
    want = {"chain_prepare": pg_it, "chain_sweep": pg_it * (pg_cg + 1)}
    pgo_rel = abs(float(pc1) - float(pcs)) / float(pcs)
    cg_total = pg_it * pg_cg
    say("dist-pgo-1", poses=g["poses"].shape[0], live=n,
        loop_edges=len(sys_.loop_edges), gn_iters=pg_it, cg_iters=pg_cg,
        cost=float(pc1), cost_single=float(pcs), cost_rel_diff=pgo_rel,
        ate_odometry_m=ate_odo, ate_m=ate_p1, ate_single_m=ate_ps,
        ms_per_gn_iteration=p_ms, launches=counts1, expected=want,
        all_reduce_bytes_per_cg_step=pgo_comm["all_reduce_bytes"] / cg_total,
        p2p_calls=pgo_comm["p2p_calls"])
    check({k: counts1[k] for k in want} == want,
          f"sharded PGO launches {counts1} != {want}")
    check(pgo_rel <= DIST_PGO_COST_TOL and ate_p1 <= ate_odo,
          f"sharded PGO cost {float(pc1)} vs {float(pcs)}, ATE {ate_p1} vs "
          f"odometry {ate_odo}")

    # (c) and (d) at two ranks sharing the card over gloo
    data = dict(prob=tuple(x.cpu() for x in prob),
                cam=tuple(x.cpu() for x in cam), cfg=cfg,
                obs_bucket=obs_bucket, graph=g, pg_iters=pg_it)
    t0 = time.perf_counter()
    res = spawn_dist_ranks(2, data, tmp)
    spawn_s = time.perf_counter() - t0
    r0 = res[0]
    cost_rel = abs(r0["cost"] - float(cost1)) / max(abs(float(cost1)), 1.0)
    pose_diff = float((r0["poses"][rows.cpu()] - out1.poses.cpu()[
        rows.cpu()])[:, :3, 3].abs().max())
    pgo2_rel = abs(r0["pgo_cost"] - float(pcs)) / float(pcs)
    ate_p2 = ate_rmse(r0["pgo_poses"][:n].numpy(), gt[:n], align=False)
    for r, rr in enumerate(res):
        say("dist-rank", rank=r, backend=rr["backend"], device=rr["device"],
            ba_seconds=f"{rr['ba_s']:.3f}", pgo_seconds=f"{rr['pgo_s']:.3f}",
            dropped=rr["dropped"], launches=rr["launches"],
            ba_comm=rr["ba_comm"], pgo_comm=rr["pgo_comm"])
        check(rr["backend"] == "gloo" and rr["dropped"] == 0,
              f"rank {r}: backend {rr['backend']}, dropped {rr['dropped']}")
        check({k: rr["launches"][k] for k in want} == want,
              f"rank {r}: chain launches {rr['launches']} != {want}")
        check(torch.equal(rr["poses"], r0["poses"]),
              f"rank {r} ended with other BA poses than rank 0")
    say("dist-2", seconds=f"{spawn_s:.3f}", ba_cost=r0["cost"],
        ba_cost_1_rank=float(cost1), ba_cost_rel_diff=cost_rel,
        ba_max_position_diff_m=pose_diff,
        ba_ms_per_lm_iteration=1e3 * r0["ba_s"] / iters,
        pgo_cost=r0["pgo_cost"], pgo_cost_rel_diff_to_single=pgo2_rel,
        pgo_ate_m=ate_p2, pgo_ms_per_gn_iteration=1e3 * r0["pgo_s"] / pg_it,
        pgo_all_reduce_bytes_per_cg_step=r0["pgo_comm"]["all_reduce_bytes"]
        / cg_total, pgo_p2p_bytes_per_cg_step=r0["pgo_comm"]["p2p_bytes"]
        / cg_total)
    check(cost_rel <= 1e-3 and pose_diff <= 1e-3,
          f"2-rank BA off the 1-rank BA: cost {cost_rel}, poses {pose_diff} m")
    check(pgo2_rel <= DIST_PGO_COST_TOL and ate_p2 <= ate_odo,
          f"2-rank PGO cost {r0['pgo_cost']} vs {float(pcs)}, ATE {ate_p2}")
    by_path = {"dist_1_rank": counts1}
    by_path.update({f"dist_rank{r}": rr["launches"] for r, rr in
                    enumerate(res)})
    return by_path, dict(
        dist_ba_ms_per_lm_iteration=d_ms, dist_ba_trace_max_rel_diff=trace_rel,
        dist_ba_2_rank_cost_rel_diff=cost_rel,
        dist_ba_all_reduce_bytes_per_cg_step=6 * 8 * bucket,
        dist_pgo_ms_per_gn_iteration=p_ms,
        dist_pgo_2_rank_ms_per_gn_iteration=1e3 * r0["pgo_s"] / pg_it,
        dist_pgo_cost_rel_diff=pgo_rel, dist_pgo_ate_m=ate_p1)


def selected_phases(arg):
    """The phases --phases names (all when it names none), with what
    each of them needs."""
    if not arg:
        return set(PHASES)
    want = {p.strip() for p in arg.split(",") if p.strip()}
    unknown = want - set(PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}; "
                         f"known: {','.join(PHASES)}")
    todo = list(want)
    while todo:
        for need in NEEDS.get(todo.pop(), ()):
            if need not in want:
                want.add(need)
                todo.append(need)
    return want


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run, with what they "
                         f"need (default: all): {','.join(PHASES)}")
    phases = selected_phases(ap.parse_args(argv).phases)
    t_start = time.perf_counter()
    smi = phase_device()
    dev = runtime.device("cuda")
    phase_build()
    say("phases", run=[p for p in PHASES if p in phases])
    cfg = SlamConfig()
    h, w = cfg.image.height, cfg.image.width
    t0 = time.perf_counter()
    world = synthetic.make_world(SEED, n_frames=N_FRAMES, n_points=N_POINTS,
                                 trajectory="arc", speed=1.0, device=dev)
    lefts, rights = synthetic.render_sequence(world, h, w)
    torch.cuda.synchronize()
    say("render", frames=N_FRAMES, points=N_POINTS, shape=(h, w),
        seconds=f"{time.perf_counter() - t0:.3f}",
        mean_intensity=float(lefts.mean()))
    check(bool(torch.isfinite(lefts).all()) and float(lefts.max()) > 0,
          "rendered frames empty or not finite")

    errs, rel_errs, by_path, times, numbers = {}, {}, {}, {}, {}
    # torch.profiler sessions, run after every other phase (see the
    # module docstring).
    late = []
    vo_syncs = slam_syncs = fps = ate = ok_share = None
    if "kernels" in phases:
        kernel_errs, hamming_inputs = phase_kernels(cfg, lefts, rights, dev)
        errs.update(kernel_errs)
        backend_errs, backend_rel = phase_kernels_backend(dev)
        errs.update(backend_errs)
        rel_errs.update(backend_rel)
    if "slice" in phases:
        by_path["vo"], ate, ok_share = phase_slice(cfg, world, lefts, rights,
                                                   dev)
    phase_s = {}
    if "pyramid" in phases:
        t0 = time.perf_counter()
        by_path["pyramid"], pyr_err, pyr = phase_pyramid(lefts, rights, world,
                                                          dev)
        phase_s["pyramid"] = time.perf_counter() - t0
        errs["fast_score"] = max(errs.get("fast_score", 0.0), pyr_err)
        numbers.update(pyr)
    if "two-view" in phases:
        t0 = time.perf_counter()
        by_path["two_view"], two_view = phase_two_view(lefts, world, dev)
        numbers.update(two_view)
        phase_s["two-view"] = time.perf_counter() - t0
    if "flow" in phases:
        by_path["flow"], flow = phase_flow(cfg, world, lefts, rights, dev, ate,
                                           late)
        numbers.update(flow)
    if phases & {"slam", "async", "cpu-vs-gpu", "cli"}:
        sworld, slefts, srights = render_loop2(dev)
    bcfg = slam_config(ba_on=True)
    if "slam" in phases:
        sys_off, by_path["slam"], run_graph_errs, slam = phase_slam(
            slam_config(ba_on=False), sworld, slefts, srights, dev)
        numbers.update(slam)
        del sys_off
        keep_worst(errs, rel_errs, {k: (e, run_graph_errs[1][k])
                                    for k, e in run_graph_errs[0].items()})
    if "slam-ba" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            sys_, post_ba, by_path["slam_ba"], ckpt, slam_ba = phase_slam_ba(
                bcfg, sworld, slefts, srights, slam, tmp, late)
            numbers.update(slam_ba)
            if "checkpoint" in phases:
                numbers.update(phase_checkpoint(bcfg, sworld, slefts,
                                                srights, ckpt, post_ba))
    if "global-ba" in phases:
        numbers.update(phase_global_ba(bcfg, sys_, sworld))
    if "ref-backend" in phases:
        t0 = time.perf_counter()
        numbers.update(phase_ref_backend(sys_, dev))
        phase_s["ref-backend"] = time.perf_counter() - t0
    if "dist" in phases:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            dist_paths, dist_numbers = phase_dist(bcfg, sys_, sworld, tmp)
        by_path.update(dist_paths)
        numbers.update(dist_numbers)
        phase_s["dist"] = time.perf_counter() - t0
    if "async" in phases:
        numbers.update(phase_async(sworld, slefts, srights))
    if "cpu-vs-gpu" in phases:
        vo_syncs, slam_syncs = phase_slam_cpu_vs_gpu(bcfg, sworld, slefts,
                                                     srights, dev)
    if "cli" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            by_path["cli"], cli_numbers = phase_cli(sworld, slefts, srights,
                                                    tmp)
        numbers.update(cli_numbers)
    if "times" in phases:
        new_times, fps = phase_times(cfg, lefts, rights, world,
                                     hamming_inputs)
        times.update(new_times)
    if "times-slam" in phases:
        new_times, stages = phase_times_slam(bcfg, sys_, sworld)
        times.update(new_times)
        numbers.update(stages)
    for profiled in late:
        numbers.update(profiled())

    # No single PyTorch call computes any of these functions (no packed
    # Hamming top-2, FAST score or block-bidiagonal sweep): library_ms
    # is null throughout. The chain rows also carry max_rel_err, the
    # error over max |twin| that CHAIN_TOL bounds (their operands on the
    # run's graph reach 1e9, so the absolute error says little). A run
    # of some phases leaves null what it did not measure.
    unmeasured = {"ms": None, "eager_ms": None, "plain_ms": None,
                  "bound_ms": None, "bound_by": None}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep,
                "launches": by_path.get("slam_ba", {}).get(name),
                "launches_by_path": {k: v.get(name, 0)
                                     for k, v in by_path.items()},
                "max_abs_err": errs.get(name),
                **({"max_rel_err": rel_errs[name]} if name in rel_errs
                   else {}),
                "per": per, **times.get(name, unmeasured),
                "library_ms": None}
               for name, (src, rep, per) in KERNELS.items()]
    print(json.dumps({"phases": [p for p in PHASES if p in phases],
                      "vo_frames_per_s": fps, "ate_m": ate,
                      "pnp_ok_share": ok_share, **numbers,
                      "syncs_per_step": {"vo_step": vo_syncs,
                                         "slam_step": slam_syncs},
                      "phase_seconds": phase_s,
                      "seconds": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
