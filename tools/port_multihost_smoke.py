"""Two-process distributed smoke test of the PyTorch/CUDA port
(counterpart of tools/multihost_smoke.py).

Runs the multi-process path for real: the parent starts two processes
that call the port's `init_multihost` against a rendezvous on a free
localhost port, lay both ranks out on one "lm" axis, and run
`distributed_bundle_adjust` across the process boundary; each child
holds the result to the single-device `bundle_adjust` of the same
problem (final translations within 5e-3 m, finite cost). Two processes
on one card run on gloo, each on a card of its own on NCCL, on the CPU
on gloo (`parallel/mesh.py`).

Usage (from the repo root):
  python tools/port_multihost_smoke.py [--device cuda]   # parent
  python tools/port_multihost_smoke.py --child I --coord H:P  # internal

Prints ONE JSON line (the keys of MULTIHOST_r04.json):
  {"ok": true, "processes": 2, "global_devices": 2, "children": [...]}
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

NUM_PROCS = 2
CHILD_TIMEOUT_S = 600
PARITY_M = 5e-3


def _child(process_id: int, coord: str, device: str) -> int:
    import torch
    import torch.distributed as dist

    from slam1_tpu_torch import parallel
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models.ba import bundle_adjust
    from slam1_tpu_torch.parallel.dist_ba import (distributed_bundle_adjust,
                                                  partition_problem)
    from slam1_tpu_torch.parallel.mesh import init_multihost, make_mesh
    from slam1_tpu_torch.utils.synthetic import ba_problem

    torch.set_num_threads(1)
    backend = init_multihost(coord, num_processes=NUM_PROCS,
                             process_id=process_id, device=device)
    try:
        world = dist.get_world_size()
        if world != NUM_PROCS:
            raise RuntimeError(f"world size {world} != {NUM_PROCS}")
        mesh = make_mesh(lm_axis=world, device=device)  # lm spans both
        # The same seeded problem in every process; each rank keeps its
        # landmark shard.
        prob, _, _, cam = ba_problem(seed=0, n_cams=4, n_pts=64,
                                     device=mesh.device)
        ba_cfg = BAConfig(lm_iters=2, cg_iters=8)
        sharded, _ = partition_problem(prob, world)
        out, cost = distributed_bundle_adjust(sharded, cam, ba_cfg, mesh)
        # The single-device baseline: graphed on a card, eager on the CPU.
        ref_out, _ref_cost = bundle_adjust(prob, cam, ba_cfg)
        terr = float((out.poses[:, :3, 3]
                      - ref_out.poses[:, :3, 3]).abs().max())
        if not math.isfinite(float(cost)):
            raise RuntimeError("distributed BA produced a non-finite cost")
        if not terr < PARITY_M:
            raise RuntimeError(f"multi-process BA diverges: {terr} m")
        print(json.dumps({
            "child": process_id, "processes": world,
            "global_devices": world, "local_devices": 1,
            "mesh": dict(mesh.shape), "backend": backend,
            "device": str(mesh.device),
            "ba_cost": float(cost), "ba_parity_terr": terr,
            "single_device_ba": ("graphed" if mesh.device.type == "cuda"
                                 else "eager")}))
    finally:
        parallel.clear_graphs()
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--coord", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises where there "
                         "is no card)")
    args = ap.parse_args(argv)
    if args.child is not None:
        return _child(args.child, args.coord, args.device)

    from slam1_tpu_torch import runtime
    runtime.device(args.device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    # Each child is one rank of a host with two: the backend rule must
    # see both when it counts the cards.
    env["LOCAL_WORLD_SIZE"] = str(NUM_PROCS)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(i),
         "--coord", coord, "--device", args.device],
        env=env, cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(NUM_PROCS)]
    outs = []
    ok = True
    for i, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            so, se = p.communicate()
            ok = False
        if p.returncode != 0:
            ok = False
            print(f"--- child {i} rc={p.returncode} stderr tail ---\n"
                  + "\n".join(se.splitlines()[-15:]), file=sys.stderr)
        for line in so.splitlines():
            if line.startswith("{"):
                outs.append(json.loads(line))
    ok = ok and len(outs) == NUM_PROCS
    result = {"ok": ok,
              "processes": outs[0]["processes"] if outs else 0,
              "global_devices": outs[0]["global_devices"] if outs else 0,
              "children": outs}
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
