"""Time the CUDA kernels of `slam1_tpu_torch` that were redesigned for
the H100 against the sources they replaced, in one process on one card.

    mkdir -p slam1_tpu_torch/build/old
    for f in hamming_top2 chain_sweep; do
      git show e540e2a:slam1_tpu_torch/csrc/$f.cu \\
        > slam1_tpu_torch/build/old/$f.cu
    done
    python3 kernel_bench.py slam1_tpu_torch/build/old [--out FILE]

Run from the repo root on a machine with a CUDA card (sm_90a) and nvcc.
It imports torch, numpy and `slam1_tpu_torch` only. The directory holds
the `hamming_top2.cu` and `chain_sweep.cu` of the commit before the
redesign (their C interface took `splits, part, colkey` and `ji`); they
are built with the current flags beside the current kernels. That the
current kernels are right is `chip_smoke.py`'s business; here the two
sets only have to agree with each other. Steps:

  1. prints the card's name and power limit (nvidia-smi);
  2. at the main paths' shapes (`hamming_top2` 2688 x 2688 ungated,
     epipolar- and window-gated; its batched entry 8 x 1024 x 1024;
     `chain_sweep` at 2048 poses with 601 and 2048 live rows) times old
     and new in turns old, new, new, old on the same inputs, after
     their results are compared. Two times each: `device_ms`, from a
     CUDA graph of 20 calls replayed (what the card needs, no host in
     the way), and `eager_ms`, CUDA events around 20 calls of the
     wrapper (what a caller pays when nothing else is queued);
  3. times one live pose-graph relaxation (`posegraph.optimize`, 5
     Gauss-Newton iterations x 64 CG iterations, chain preconditioner)
     on `synthetic.loop2_graph` (600 poses, four loop edges), host clock
     around a synchronise, with the old chain sweep in the
     preconditioner's place and with the new one, in the same turns.

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
from slam1_tpu_torch.models import posegraph  # noqa: E402
from slam1_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam1_tpu_torch.utils import synthetic  # noqa: E402
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


class OldKernels:
    """The kernels of the commit before the redesign, built from a
    directory with the flags of the current build and called as that
    commit called them."""

    def __init__(self, csrc):
        self.dir = tempfile.mkdtemp(prefix="old_kernels_", dir=ck.BUILD_DIR)
        path = os.path.join(self.dir, "libold.so")
        cmd = [ck._nvcc(), *ck.NVCC_FLAGS, "-o", path,
               os.path.join(csrc, "hamming_top2.cu"),
               os.path.join(csrc, "chain_sweep.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old sources:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.slam_hamming_top2.argtypes = [p, p, p, p, p, p, i, i, i, f, f,
                                          f, i, p, p, p, p, p, p, p]
        lib.slam_hamming_top2_batched.argtypes = [p, p, p, p, i, i, i, i, p,
                                                  p, p, p, p, p, p]
        lib.slam_chain_sweep.argtypes = [p, p, p, p, i, i, p, p]
        for fn in (lib.slam_hamming_top2, lib.slam_hamming_top2_batched,
                   lib.slam_chain_sweep):
            fn.restype = i
        self.lib = lib

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
            err = self.lib.slam_hamming_top2_batched(
                da.data_ptr(), db.data_ptr(), ma.data_ptr(), mb.data_ptr(),
                b, n, m, splits, part.data_ptr(), colkey.data_ptr(),
                d1.data_ptr(), d2.data_ptr(), idx.data_ptr(), cb.data_ptr(),
                st)
        else:
            gated = uv_a is not None
            err = self.lib.slam_hamming_top2(
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
        err = self.lib.slam_chain_sweep(
            jj.data_ptr(), ji.data_ptr(), winv.data_ptr(), v.data_ptr(),
            v.shape[0], int(n_live), x.data_ptr(),
            torch.cuda.current_stream(v.device).cuda_stream)
        if err:
            raise RuntimeError(f"old chain_sweep launch: CUDA error {err}")
        return x

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)


def time_kernels(dev, old):
    times = {}
    rng = np.random.default_rng(2)

    def descriptors(*lead):
        return [torch.as_tensor(x).to(dev) for x in (
            rng.integers(0, 256, (*lead, 32), dtype=np.uint8),
            rng.integers(0, 256, (*lead, 32), dtype=np.uint8),
            rng.random(lead) > 0.2, rng.random(lead) > 0.2)]

    def both(name, prev, new, same):
        times[name] = dict(in_turns(prev, new), **same(prev(), new()))
        print(f"[time] {name}: {times[name]}", flush=True)

    def equal(a, b):
        return {"old_equals_new": all(torch.equal(x, y)
                                      for x, y in zip(a, b))}

    def rel(a, b):
        return {"old_vs_new_rel": ((a - b).abs().max()
                                   / a.abs().max()).item()}

    args = descriptors(N_KP)
    uva = rng.uniform(0, 100, (N_KP, 2)).astype(np.float32)
    uvb = rng.uniform(0, 100, (N_KP, 2)).astype(np.float32)
    uva[:, 1], uvb[:, 1] = np.round(uva[:, 1]), np.round(uvb[:, 1])
    uva, uvb = torch.as_tensor(uva).to(dev), torch.as_tensor(uvb).to(dev)
    for gate, kw in GATES.items():
        kw = dict(uv_a=uva, uv_b=uvb, **kw) if kw else {}
        both(f"hamming_top2 {N_KP}x{N_KP} {gate}",
             lambda kw=kw: old.hamming(*args, **kw),
             lambda kw=kw: ck.hamming_top2_cuda(*args, **kw), equal)
    bargs = descriptors(*SLATE)
    both(f"hamming_top2_batched {SLATE[0]}x{SLATE[1]}x{SLATE[1]}",
         lambda: old.hamming(*bargs),
         lambda: ck.hamming_top2_batched_cuda(*bargs), equal)
    for n_live in (601, CHAIN_F):
        ops = [x.to(dev) for x in synthetic.chain_inputs(CHAIN_F, n_live, 1)]
        prep = ck.chain_prepare_cuda(ops[0], ops[1], n_live)
        both(f"chain_sweep F={CHAIN_F} n_live={n_live}",
             lambda: old.chain(*ops, n_live),
             lambda: ck.chain_sweep_cuda(*ops, n_live, prep=prep), rel)

        def prepare():
            return ck.chain_prepare_cuda(ops[0], ops[1], n_live)

        name = f"chain_prepare F={CHAIN_F} n_live={n_live}"
        times[name] = dict(new_device_ms=graph_ms(prepare),
                           new_eager_ms=event_ms(prepare))
        print(f"[time] {name}: {times[name]}", flush=True)
    return times


def time_pgo(dev, old):
    """Wall ms of one live relaxation with the old chain sweep in the
    preconditioner's place and with the new kernels."""
    graph = synthetic.loop2_graph(device=dev)
    n = graph.poses.shape[0]
    new_prepare, new_sweep = ck.chain_prepare_cuda, ck.chain_sweep_cuda

    def relax():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses, cost = posegraph.optimize(graph, iters=5, cg_iters=64,
                                         n_live=n)
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
    print(f"[time] live PGO, {n} poses, 5 GN x 64 CG: {out}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_csrc", help="directory with the earlier "
                    "hamming_top2.cu and chain_sweep.cu")
    ap.add_argument("--out", help="also write the result JSON here")
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
        result = {"card": smi, "times": time_kernels(dev, old),
                  "pgo": time_pgo(dev, old)}
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
