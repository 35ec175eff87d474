"""Time the CUDA kernels of `slam1_tpu_torch` that were redesigned for
the H100 against the sources they replaced, in one process on one card.

    mkdir -p slam1_tpu_torch/build/old
    for f in hamming_top2 chain_sweep; do
      git show e540e2a:slam1_tpu_torch/csrc/$f.cu \\
        > slam1_tpu_torch/build/old/$f.cu
    done
    git show 7bc37b4:slam1_tpu_torch/csrc/fast_score.cu \\
      > slam1_tpu_torch/build/old/fast_score.cu
    python3 kernel_bench.py slam1_tpu_torch/build/old [--out FILE]

Run from the repo root on a machine with a CUDA card (sm_90a) and nvcc.
It imports torch, numpy and `slam1_tpu_torch` only. The directory holds
earlier versions of the kernels' sources, each optional: the
`hamming_top2.cu` and `chain_sweep.cu` of the commit before their
redesign (their C interface took `splits, part, colkey` and `ji`) and
the `fast_score.cu` before its own (one launch per pyramid level). Each
is built with the current flags beside the current kernels, and what the
directory lacks is not timed. That the current kernels are right is
`chip_smoke.py`'s business; here the two sets only have to agree with
each other. Steps:

  1. prints the card's name and power limit (nvidia-smi);
  2. at the main paths' shapes (`hamming_top2` 2688 x 2688 ungated,
     epipolar- and window-gated; its batched entry 8 x 1024 x 1024;
     `chain_sweep` at 2048 poses with 601 and 2048 live rows;
     `fast_score` on a frame's pyramid, 2 images x 376 x 1280, 188 x 640
     and 94 x 320: rendered, uniform noise, and a ramp with few
     corners) times old and new in turns old, new, new, old on the same
     inputs, after their results are compared. Two times each: `device_ms`, from a CUDA graph of 20
     calls replayed (what the card needs, no host in the way), and
     `eager_ms`, CUDA events around 20 calls of the wrapper (what a
     caller pays when nothing else is queued). `fast_score` is timed per
     frame (the old source's three launches against the one launch of
     the levels entry) and level by level through the one-level entry;
  3. builds the current `fast_score.cu` at other tilings (-DFAST_TW,
     -DFAST_TH, -DFAST_PPT: tile width and height, pixels per thread;
     -DFAST_MIN_BLOCKS caps the registers; -DFAST_COPY_ONLY=1 leaves
     the arithmetic out, =2 stops after the taps' differences) and
     times a frame through each, on aligned inputs (16-byte loads and
     stores) and on copies moved by 4 bytes (the scalar path), and the
     three levels as three one-level launches of the current build;
  4. times one live pose-graph relaxation (`posegraph.optimize`, 5
     Gauss-Newton iterations x 64 CG iterations, chain preconditioner)
     on `synthetic.loop2_graph` (600 poses, four loop edges), host clock
     around a synchronise, with the old chain sweep in the
     preconditioner's place and with the new one, in the same turns,
     op by op (`graphs=False`, as every earlier record of it ran), and
     beside them the same relaxation as `optimize` runs it by default
     on a card, replays of its captured CUDA graphs (`graphed_ms`).

The last line is one JSON object with every number; --out also writes it
to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from slam1_tpu_torch import runtime  # noqa: E402
from slam1_tpu_torch.config import SlamConfig  # noqa: E402
from slam1_tpu_torch.models import posegraph  # noqa: E402
from slam1_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam1_tpu_torch.ops.detector import _downsample2  # noqa: E402
from slam1_tpu_torch.utils import synthetic  # noqa: E402
from slam1_tpu_torch.utils.graphs import GRAPHS  # noqa: E402
from slam1_tpu_torch.utils.timing import event_ms, graph_ms  # noqa: E402

N_KP = 2688
SLATE = (8, 1024)
CHAIN_F = 2048
GATES = {"ungated": {}, "epipolar": dict(dy_tol=10.0, dx_lo=0.5, dx_hi=40.0),
         "window": dict(dy_tol=12.0, dx_lo=-12.0, dx_hi=12.0)}


def in_turns(old, new):
    """device and eager ms of old and new, measured old, new, new, old."""
    out = {}
    for name, timer in (("device_ms", graph_ms), ("eager_ms", event_ms)):
        runs = [("old", timer(old)), ("new", timer(new)),
                ("new", timer(new)), ("old", timer(old))]
        for which in ("old", "new"):
            out[f"{which}_{name}"] = float(
                np.mean([t for w, t in runs if w == which]))
    return out


def nvcc_build(out_dir, name, source, defines=()):
    """Build one source with the current flags (plus -D `defines`) into
    out_dir/name.so and load it."""
    path = os.path.join(out_dir, name + ".so")
    cmd = [ck._nvcc(), *ck.NVCC_FLAGS, *[f"-D{d}" for d in defines],
           "-o", path, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} {defines}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(path)


class FastLib:
    """A build of a `fast_score.cu` (an earlier one, or the current one
    at another tiling), called as `ops/cuda_kernels.py` calls it."""

    def __init__(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.slam_fast_score.argtypes = [p, p, i, i, i, f, i, p]
        lib.slam_fast_score.restype = i
        # The source before the redesign has no levels entry.
        self.has_levels = hasattr(lib, "slam_fast_score_levels")
        if self.has_levels:
            lib.slam_fast_score_levels.argtypes = [
                ctypes.POINTER(ck._FastLevel), i, f, i, p]
            lib.slam_fast_score_levels.restype = i
        self.lib = lib

    def level(self, img, thr, arc):
        out = torch.empty_like(img)
        err = self.lib.slam_fast_score(
            img.data_ptr(), out.data_ptr(), *img.shape, float(thr), int(arc),
            torch.cuda.current_stream(img.device).cuda_stream)
        if err:
            raise RuntimeError(f"fast_score launch: CUDA error {err}")
        return out

    def frame(self, imgs, thr, arc):
        """All levels: one launch where the source has the levels entry,
        else one launch per level."""
        if not self.has_levels:
            return [self.level(im, thr, arc) for im in imgs]
        outs = [torch.empty_like(im) for im in imgs]
        levels = (ck._FastLevel * len(imgs))(*[
            ck._FastLevel(im.data_ptr(), o.data_ptr(), *im.shape)
            for im, o in zip(imgs, outs)])
        err = self.lib.slam_fast_score_levels(
            levels, len(imgs), float(thr), int(arc),
            torch.cuda.current_stream(imgs[0].device).cuda_stream)
        if err:
            raise RuntimeError(f"fast_score launch: CUDA error {err}")
        return outs


class OldKernels:
    """The kernels of the commits before their redesign, built from a
    directory with the flags of the current build and called as those
    commits called them. `has` says which sources the directory held."""

    def __init__(self, csrc):
        self.dir = tempfile.mkdtemp(prefix="old_kernels_", dir=ck.BUILD_DIR)
        self.has = {src: os.path.exists(os.path.join(csrc, src))
                    for src in ck.SOURCES}
        libs = {src: nvcc_build(self.dir, "libold_" + src[:-3],
                                os.path.join(csrc, src))
                for src, there in self.has.items() if there}
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if self.has["hamming_top2.cu"]:
            ham = self.ham = libs["hamming_top2.cu"]
            ham.slam_hamming_top2.argtypes = [p, p, p, p, p, p, i, i, i, f,
                                              f, f, i, p, p, p, p, p, p, p]
            ham.slam_hamming_top2_batched.argtypes = [p, p, p, p, i, i, i, i,
                                                      p, p, p, p, p, p, p]
            ham.slam_hamming_top2.restype = i
            ham.slam_hamming_top2_batched.restype = i
        if self.has["chain_sweep.cu"]:
            self.chain_lib = libs["chain_sweep.cu"]
            self.chain_lib.slam_chain_sweep.argtypes = [p, p, p, p, i, i, p,
                                                        p]
            self.chain_lib.slam_chain_sweep.restype = i
        if self.has["fast_score.cu"]:
            self.fast = FastLib(libs["fast_score.cu"])

    def hamming(self, da, db, ma, mb, uv_a=None, uv_b=None, dy_tol=None,
                dx_lo=0.0, dx_hi=0.0):
        batched = da.dim() == 3
        b = da.shape[0] if batched else 1
        n, m = da.shape[-2], db.shape[-2]
        dev = da.device
        # Column splits as that commit's wrapper chose them: ~170 blocks.
        splits = max(1, min(-(-m // 128), -(-170 // (-(-n // 128) * b))))
        part = torch.empty((b * 3 * splits * n,), dtype=torch.int32,
                           device=dev)
        colkey = torch.empty((b * m,), dtype=torch.int32, device=dev)
        lead = (b,) if batched else ()
        d1 = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
        d2, idx = torch.empty_like(d1), torch.empty_like(d1)
        cb = torch.empty(lead + (m,), dtype=torch.int32, device=dev)
        st = torch.cuda.current_stream(dev).cuda_stream
        if batched:
            err = self.ham.slam_hamming_top2_batched(
                da.data_ptr(), db.data_ptr(), ma.data_ptr(), mb.data_ptr(),
                b, n, m, splits, part.data_ptr(), colkey.data_ptr(),
                d1.data_ptr(), d2.data_ptr(), idx.data_ptr(), cb.data_ptr(),
                st)
        else:
            gated = uv_a is not None
            err = self.ham.slam_hamming_top2(
                da.data_ptr(), db.data_ptr(), ma.data_ptr(), mb.data_ptr(),
                uv_a.data_ptr() if gated else None,
                uv_b.data_ptr() if gated else None, n, m, int(gated),
                float(dy_tol) if gated else 0.0, float(dx_lo), float(dx_hi),
                splits, part.data_ptr(), colkey.data_ptr(), d1.data_ptr(),
                d2.data_ptr(), idx.data_ptr(), cb.data_ptr(), st)
        if err:
            raise RuntimeError(f"old hamming launch: CUDA error {err}")
        return d1, d2, idx, cb

    def chain(self, jj, ji, winv, v, n_live):
        x = torch.empty_like(v)
        err = self.chain_lib.slam_chain_sweep(
            jj.data_ptr(), ji.data_ptr(), winv.data_ptr(), v.data_ptr(),
            v.shape[0], int(n_live), x.data_ptr(),
            torch.cuda.current_stream(v.device).cuda_stream)
        if err:
            raise RuntimeError(f"old chain_sweep launch: CUDA error {err}")
        return x

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)


def both(times, name, prev, new, same):
    """Compare prev() with new(), then time them in turns."""
    times[name] = dict(in_turns(prev, new), **same(prev(), new()))
    print(f"[time] {name}: {times[name]}", flush=True)


def equal(a, b):
    return {"old_equals_new": all(torch.equal(x, y) for x, y in zip(a, b))}


def rel(a, b):
    return {"old_vs_new_rel": ((a - b).abs().max() / a.abs().max()).item()}


def time_kernels(dev, old):
    times = {}
    rng = np.random.default_rng(2)

    def descriptors(*lead):
        return [torch.as_tensor(x).to(dev) for x in (
            rng.integers(0, 256, (*lead, 32), dtype=np.uint8),
            rng.integers(0, 256, (*lead, 32), dtype=np.uint8),
            rng.random(lead) > 0.2, rng.random(lead) > 0.2)]

    if old.has["hamming_top2.cu"]:
        args = descriptors(N_KP)
        uva = rng.uniform(0, 100, (N_KP, 2)).astype(np.float32)
        uvb = rng.uniform(0, 100, (N_KP, 2)).astype(np.float32)
        uva[:, 1], uvb[:, 1] = np.round(uva[:, 1]), np.round(uvb[:, 1])
        uva, uvb = torch.as_tensor(uva).to(dev), torch.as_tensor(uvb).to(dev)
        for gate, kw in GATES.items():
            kw = dict(uv_a=uva, uv_b=uvb, **kw) if kw else {}
            both(times, f"hamming_top2 {N_KP}x{N_KP} {gate}",
                 lambda kw=kw: old.hamming(*args, **kw),
                 lambda kw=kw: ck.hamming_top2_cuda(*args, **kw), equal)
        bargs = descriptors(*SLATE)
        both(times, f"hamming_top2_batched {SLATE[0]}x{SLATE[1]}x{SLATE[1]}",
             lambda: old.hamming(*bargs),
             lambda: ck.hamming_top2_batched_cuda(*bargs), equal)
    for n_live in (601, CHAIN_F) if old.has["chain_sweep.cu"] else ():
        ops = [x.to(dev) for x in synthetic.chain_inputs(CHAIN_F, n_live, 1)]
        prep = ck.chain_prepare_cuda(ops[0], ops[1], n_live)
        both(times, f"chain_sweep F={CHAIN_F} n_live={n_live}",
             lambda: old.chain(*ops, n_live),
             lambda: ck.chain_sweep_cuda(*ops, n_live, prep=prep), rel)

        def prepare():
            return ck.chain_prepare_cuda(ops[0], ops[1], n_live)

        name = f"chain_prepare F={CHAIN_F} n_live={n_live}"
        times[name] = dict(new_device_ms=graph_ms(prepare),
                           new_eager_ms=event_ms(prepare))
        print(f"[time] {name}: {times[name]}", flush=True)
    return times


def time_fast(dev, old):
    """`fast_score` per frame and per level, old against new; then the
    current source at other tilings, and its scalar path."""
    cfg = SlamConfig()
    thr, arc = cfg.detector.fast_threshold, cfg.detector.fast_arc
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(0, n_frames=4, n_points=6000,
                                 trajectory="arc", speed=1.0, device=dev)
    lefts, rights = synthetic.render_sequence(world, h, w)
    noise = torch.rand((2, h, w), device=dev,
                       generator=torch.Generator(dev).manual_seed(1))
    # Few corners, as in a camera's frame: a low-contrast ramp with a
    # bright square every 64 pixels.
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    sparse = (0.3 + 0.2 * xs / w + 0.1 * ys / h
              + 0.4 * ((ys % 64 < 9) & (xs % 64 < 9))).float()
    frames = {"rendered": torch.stack([lefts[3], rights[3]]),
              "noise": noise, "sparse": torch.stack([sparse, sparse])}
    times = {}
    pyramids = {}
    for what, img in frames.items():
        imgs = [img]
        for _ in range(1, cfg.detector.num_levels):
            imgs.append(_downsample2(imgs[-1]))
        imgs = pyramids[what] = [im.contiguous() for im in imgs]
        corners = [int((x > 0).sum())
                   for x in ck.fast_score_levels_cuda(imgs, thr, arc)]
        print(f"[fast] {what}: corners per level {corners}", flush=True)

        def one_launch(imgs=imgs):
            return ck.fast_score_levels_cuda(imgs, thr, arc)

        def launch_per_level(imgs=imgs):
            return [ck.fast_score_cuda(im, thr, arc) for im in imgs]

        if old.has["fast_score.cu"]:
            both(times, f"fast_score frame {what}",
                 lambda imgs=imgs: old.fast.frame(imgs, thr, arc),
                 one_launch, equal)
            for lvl, im in enumerate(imgs):
                both(times, f"fast_score level {lvl} "
                     f"{tuple(im.shape)} {what}",
                     lambda im=im: [old.fast.level(im, thr, arc)],
                     lambda im=im: [ck.fast_score_cuda(im, thr, arc)], equal)
        name = f"fast_score frame {what}, new: 3 launches against 1"
        times[name] = {k.replace("old", "three").replace("new", "one"): v
                       for k, v in in_turns(launch_per_level,
                                            one_launch).items()}
        print(f"[time] {name}: {times[name]}", flush=True)

    # The current source at other tilings: device ms of a frame, every
    # variant timed once in this order and once in the reverse.
    # (TW, TH, PPT, MIN_BLOCKS, COPY_ONLY): MIN_BLOCKS caps the registers
    # so that so many blocks fit on an SM; COPY_ONLY = 1 leaves the
    # arithmetic out (the tile staged, the centre pixel written: what the
    # memory path and the launch cost alone), COPY_ONLY = 2 stops after
    # the taps' differences (the window loaded into registers; its output
    # is a sum of them and is not compared).
    # (64, 8, 4, 8, 0) is what csrc/fast_score.cu builds by default.
    variants = [(32, 8, 1, 1, 0), (64, 8, 2, 1, 0), (64, 8, 4, 1, 0),
                (64, 16, 4, 1, 0), (128, 8, 4, 1, 0), (32, 16, 4, 1, 0),
                (64, 8, 4, 8, 0), (64, 16, 4, 4, 0), (32, 16, 4, 8, 0),
                (64, 8, 4, 8, 1), (64, 8, 4, 8, 2)]
    flags = ("TW", "TH", "PPT", "MIN_BLOCKS", "COPY_ONLY")
    out_dir = tempfile.mkdtemp(prefix="fast_variants_", dir=ck.BUILD_DIR)
    try:
        libs = {v: FastLib(nvcc_build(
            out_dir, "libfast_" + "_".join(map(str, v)),
            os.path.join(ck.CSRC, "fast_score.cu"),
            ["FAST_%s=%d" % kv for kv in zip(flags, v)]))
            for v in variants}
        for what, imgs in pyramids.items():
            moved = [synthetic.misaligned_copy(im) for im in imgs]
            want = ck.fast_score_levels_cuda(imgs, thr, arc)
            runs = {v: {"vector": [], "scalar": []} for v in variants}
            for order in (variants, variants[::-1]):
                for v in order:
                    for path, src in (("vector", imgs), ("scalar", moved)):
                        got = libs[v].frame(src, thr, arc)
                        if v[4] != 2 and not all(
                                torch.equal(a, b) for a, b in zip(
                                    got, src if v[4] else want)):
                            raise RuntimeError(f"fast_score at tiling {v}, "
                                               f"{path} path: differs")
                        runs[v][path].append(graph_ms(
                            lambda v=v, src=src: libs[v].frame(src, thr,
                                                               arc)))
            name = (f"fast_score frame {what}, tilings TW x TH x PPT "
                    "(/n: registers capped for n blocks per SM; copy1: no "
                    "arithmetic; copy2: the taps' differences only)")
            times[name] = {"%dx%dx%d" % v[:3] + ("/%d" % v[3]) * (v[3] > 1)
                           + (" copy%d" % v[4]) * (v[4] > 0): {
                path + "_device_ms": float(np.mean(t))
                for path, t in runs[v].items()} for v in variants}
            print(f"[time] {name}: {times[name]}", flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return times


def time_pgo(dev, old):
    """Wall ms of one live relaxation with the old chain sweep in the
    preconditioner's place and with the new kernels."""
    graph = synthetic.loop2_graph(device=dev)
    n = graph.poses.shape[0]
    new_prepare, new_sweep = ck.chain_prepare_cuda, ck.chain_sweep_cuda

    def relax(graphs=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses, cost = posegraph.optimize(graph, iters=5, cg_iters=64,
                                         n_live=n, graphs=graphs)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), poses, float(cost)

    def relax_old():
        ck.chain_prepare_cuda = lambda jj, ji, n_live: None
        ck.chain_sweep_cuda = (lambda jj, ji, winv, v, n_live, prep=None:
                               old.chain(jj, ji, winv, v, n_live))
        try:
            return relax()
        finally:
            ck.chain_prepare_cuda, ck.chain_sweep_cuda = (new_prepare,
                                                          new_sweep)

    relax()                                   # warm-up (jacfwd, build)
    relax_old()
    runs = [("old", relax_old()), ("new", relax()), ("new", relax()),
            ("old", relax_old())]
    out = {"old_ms": [r[0] for w, r in runs if w == "old"],
           "new_ms": [r[0] for w, r in runs if w == "new"],
           "old_vs_new_max_abs_pose_diff": float(
               (runs[0][1][1] - runs[1][1][1]).abs().max()),
           "old_cost": runs[0][1][2], "new_cost": runs[1][1][2]}
    relax(graphs=True)                        # the capture
    graphed = [relax(graphs=True) for _ in range(2)]
    out["graphed_ms"] = [r[0] for r in graphed]
    out["graphed_vs_new_max_abs_pose_diff"] = float(
        (graphed[0][1] - runs[1][1][1]).abs().max())
    GRAPHS.clear("posegraph")
    print(f"[time] live PGO, {n} poses, 5 GN x 64 CG: {out}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_csrc", help="directory with earlier versions of "
                    "hamming_top2.cu, chain_sweep.cu, fast_score.cu (each "
                    "optional)")
    ap.add_argument("--out", help="also write the result JSON here")
    ap.add_argument("--only-fast", action="store_true",
                    help="time fast_score only")
    args = ap.parse_args()
    dev = runtime.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {smi} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    ck.build()
    old = OldKernels(args.old_csrc)
    try:
        times = time_fast(dev, old)
        pgo = None
        if not args.only_fast:
            times.update(time_kernels(dev, old))
            if old.has["chain_sweep.cu"]:
                pgo = time_pgo(dev, old)
        result = {"card": smi, "times": times, "pgo": pgo}
    finally:
        old.close()
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
