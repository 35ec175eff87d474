"""Distributed BA of the PyTorch/CUDA port on the large-map problem
(counterpart of tools/dist_ba_scale.py).

Resumes a checkpoint of tools/port_global_ba_scale.py (--ckpt; ~1000
keyframes at 2000 frames), builds the global problem without priors at
the keyframe count's row bucket and its observation bucket, partitions
it with `partition_problem_device` over the ranks of the process group
(every rank a landmark shard), runs `distributed_bundle_adjust`, and on
rank 0 compares it with the single-device `bundle_adjust` on the same
problem:

  - asserts n_dropped == 0 at full per-shard headroom,
  - asserts relative final-cost parity < 5e-2 (final poses are
    reported, not asserted: without pose priors the objective has soft
    modes along which two inexact LM paths can sit metres apart),
  - reports both cost traces side by side.

Both sides run with outlier_px=0 (the graduated outlier cut exists only
in the single-device LM loop): the point is solver parity at scale.

Both solvers run as the reference runs them where they can: on a card
`bundle_adjust` replays its captured CUDA graphs (`ba_lm`, `ba_cost`)
and, under NCCL, `distributed_bundle_adjust` its own (`dba_lm`,
`dba_cost`), each captured by an untimed first call with the same
arguments; on the CPU, and the sharded solver under gloo, they run op
by op. The record's `single_mode` and `dist_mode` say which ("graphed"
or "eager").

Ranks (see `parallel/mesh.py` for the backend rule): `--ranks 1` (the
default) is a world of one in this process (NCCL on a card); `--ranks N`
spawns N ranks on this host with a file:// rendezvous under .scratch/
(N ranks sharing one card run on gloo; N cards, NCCL). Under torchrun
the tool joins torchrun's process group instead. Prints ONE JSON record
as its last line, with the keys of DIST_BA_SCALE.json.

Usage (from the repo root):
  python tools/port_dist_ba_scale.py [--ckpt .scratch/port_gba2000.npz]
      [--ranks N] [--out PATH] [--lm-iters 6] [--cg-iters 32]
      [--device cuda] [--tiny]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402

from slam1_tpu_torch import parallel  # noqa: E402
from tools.port_global_ba_scale import (SCRATCH, default_ckpt,  # noqa: E402
                                        make_scale_world, obs_bucket_for,
                                        row_bucket, scale_config)

JOIN_TIMEOUT_S = 1800.0


def run(ckpt: str, device="cuda", tiny: bool = False, lm_iters: int = 6,
        cg_iters: int = 32):
    """The comparison in the process group that is up (a world of one is
    brought up when none is). Returns the record on rank 0, None on the
    other ranks."""
    import torch.distributed as dist

    from slam1_tpu_torch.bench import sync
    from slam1_tpu_torch.models import pipeline
    from slam1_tpu_torch.models.ba import bundle_adjust
    from slam1_tpu_torch.parallel import mesh as mesh_mod
    from slam1_tpu_torch.parallel.dist_ba import (distributed_bundle_adjust,
                                                  partition_problem_device)
    from slam1_tpu_torch.utils.graphs import graphed

    if not dist.is_initialized():
        mesh_mod.init_multihost(device=device)
    shards = dist.get_world_size()
    mesh = mesh_mod.make_mesh(lm_axis=shards, device=device)
    dev = mesh.device

    cfg = scale_config(tiny)
    ba_cfg = dataclasses.replace(cfg.ba, lm_iters=lm_iters,
                                 cg_iters=cg_iters, outlier_px=0.0)
    sys_ = pipeline.SlamSystem.resume(
        ckpt, make_scale_world(8, cfg, dev).cam, cfg, device=dev)
    st = sys_.state
    n_kf = int(st.kf.n)
    bucket = row_bucket(n_kf, st.kf.xyz.shape[0])
    obs_bucket = obs_bucket_for(st, bucket)
    prob, _frames = pipeline.build_global_problem(st, bucket, obs_bucket)
    n_obs = int(torch.sum(prob.w > 0))
    print(f"problem: {n_kf} keyframes, {n_obs} observations (bucket "
          f"{obs_bucket}), L={prob.points.shape[0]}, {shards} shards",
          file=sys.stderr)

    # Full per-shard headroom: landmark blocks are insertion-ordered and
    # spatially clustered, so per-shard observation counts are far from
    # uniform at SLAM scale.
    t0 = time.perf_counter()
    sharded, _orig, n_dropped = partition_problem_device(
        prob, shards, obs_per_shard=obs_bucket)
    n_dropped = int(n_dropped)
    t_part = time.perf_counter() - t0
    if n_dropped:
        raise RuntimeError(f"partitioner dropped {n_dropped} observations "
                           "at full headroom")

    cam = sys_.cam
    # Graphed, the first call with the timed call's arguments captures
    # the graphs and the timed call only replays them; eager, one LM
    # iteration first keeps the first collectives and the first-call
    # set-up out of the timed run.
    dist_mode = "graphed" if graphed(sharded.uv, mesh) else "eager"
    warm_cfg = (ba_cfg if dist_mode == "graphed"
                else dataclasses.replace(ba_cfg, lm_iters=1))
    distributed_bundle_adjust(sharded, cam, warm_cfg, mesh,
                              return_trace=True)
    sync(dev)
    t0 = time.perf_counter()
    out_d, cost_d, trace_d = distributed_bundle_adjust(
        sharded, cam, ba_cfg, mesh, return_trace=True)
    sync(dev)
    t_dist = time.perf_counter() - t0
    if mesh.rank != 0:
        return None

    # On a card the first call with the timed call's arguments captures
    # the graphs, and the timed call only replays them.
    graphed = dev.type == "cuda"
    bundle_adjust(prob, cam, ba_cfg, return_trace=True)
    sync(dev)
    t0 = time.perf_counter()
    out_s, cost_s, trace_s = bundle_adjust(prob, cam, ba_cfg,
                                           return_trace=True)
    sync(dev)
    t_single = time.perf_counter() - t0
    print(f"single-device baseline: "
          f"{'graphed' if graphed else 'eager'}, {t_single:.3f} s",
          file=sys.stderr)
    trace_d = trace_d.cpu().numpy()
    trace_s = trace_s.cost.cpu().numpy()

    rel = abs(float(cost_d) - float(cost_s)) / max(float(cost_s), 1.0)
    pose_err = float((out_d.poses[:, :3, 3]
                      - out_s.poses[:, :3, 3]).abs().max())
    print(f"dist cost trace:   {[round(float(c), 1) for c in trace_d]}",
          file=sys.stderr)
    print(f"single cost trace: {[round(float(c), 1) for c in trace_s]}",
          file=sys.stderr)
    print(f"final: dist {float(cost_d):.1f} vs single {float(cost_s):.1f} "
          f"(rel {rel:.2e}), max pose t-err {pose_err:.2e} m",
          file=sys.stderr)
    if not rel < 5e-2:
        raise RuntimeError(f"cost parity {rel} >= 5e-2")
    return {
        "keyframes": n_kf,
        "observations": n_obs,
        "landmark_capacity": int(prob.points.shape[0]),
        "shards": shards,
        "n_dropped": n_dropped,
        "partition_wall_s": round(t_part, 3),
        "lm_iters": lm_iters,
        "cg_iters": cg_iters,
        "cost_trace_dist": [round(float(c), 1) for c in trace_d],
        "cost_trace_single": [round(float(c), 1) for c in trace_s],
        "final_cost_dist": round(float(cost_d), 1),
        "final_cost_single": round(float(cost_s), 1),
        "rel_cost_parity": rel,
        "max_pose_t_err_m": pose_err,
        "dist_wall_s": round(t_dist, 2),
        "single_wall_s": round(t_single, 2),
        "single_mode": "graphed" if graphed else "eager",
        "dist_mode": dist_mode,
        "backend": mesh.backend,
        "note": (f"{shards} rank(s), {mesh.backend}, rank 0 on "
                 + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "the CPU")),
    }


def _rank(rank, world, init_file, out_path, kw):
    from slam1_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.init_multihost(f"file://{init_file}", world, rank,
                            device=kw["device"])
    try:
        rec = run(**kw)
    finally:
        parallel.clear_graphs()
        torch.distributed.destroy_process_group()
    if rec is not None:
        with open(out_path, "w") as f:
            json.dump(rec, f)


def spawn(world: int, kw: dict) -> dict:
    """`world` ranks of run() on this host, joined under JOIN_TIMEOUT_S:
    rank 0's record. A failed or late rank raises."""
    import torch.multiprocessing as mp
    os.makedirs(SCRATCH, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=SCRATCH) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        out_path = os.path.join(tmp, "record.json")
        ctx = mp.start_processes(_rank, args=(world, init_file, out_path, kw),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks did not finish in {JOIN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        with open(out_path) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", type=str, default=default_ckpt(2000))
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--lm-iters", type=int, default=6)
    ap.add_argument("--cg-iters", type=int, default=32)
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks to spawn on this host (ignored under "
                         "torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises where there "
                         "is no card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CPU tests)")
    args = ap.parse_args(argv)

    from slam1_tpu_torch import runtime
    runtime.device(args.device)
    kw = dict(ckpt=os.path.abspath(args.ckpt), device=args.device,
              tiny=args.tiny, lm_iters=args.lm_iters,
              cg_iters=args.cg_iters)
    if args.ranks > 1 and "RANK" not in os.environ:
        rec = spawn(args.ranks, kw)
    else:
        rec = run(**kw)
        parallel.clear_graphs()
        torch.distributed.destroy_process_group()
        if rec is None:
            return 0
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
