"""Command-line interface of the PyTorch/CUDA port: `slam-torch
run|ba|eval` (counterpart of `slam1_tpu/cli.py`).

  run    — VO or full SLAM over a KITTI sequence dir or --synthetic;
           `--multihost [--coordinator H:P --num-processes N
           --process-id R]` brings up the torch.distributed process
           group first (torchrun's environment when no coordinator is
           given) and prints this process's rank and device
  ba     — offline pose-graph / global bundle-adjustment pass;
           `--state ckpt --distributed [--lm-shards S]` runs the
           landmark-sharded BA of `parallel/dist_ba.py` over the ranks
           of the process group: N ranks under torchrun, or a world of
           one when run plainly; S must divide N
  eval   — ATE/RPE of an estimated trajectory vs ground truth

Every command that computes runs on `--device` (default `cuda`, which
raises where there is no card: a run meant for the card never carries on
silently on the CPU). There is no `bench` command until the port has a
benchmark.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _config(args):
    from slam1_tpu_torch.config import SlamConfig, tiny_config
    return tiny_config() if args.tiny else SlamConfig()


def _launch_line(dev):
    """The hand-written kernels' launch counts of this process, on stderr
    (CUDA only: on the CPU every stage is its plain twin)."""
    if dev.type == "cuda":
        from slam1_tpu_torch.ops import cuda_kernels
        print(json.dumps({"kernel_launches": cuda_kernels.launch_counts()}),
              file=sys.stderr)


def _cmd_run(args):
    import dataclasses

    import torch

    from slam1_tpu_torch import runtime
    from slam1_tpu_torch.models import pipeline, vo
    from slam1_tpu_torch.utils import evalmetrics
    from slam1_tpu_torch.utils.metrics import MetricsLogger, StageTimers

    dev = runtime.device(args.device)
    own_group = False
    if args.multihost:
        import torch.distributed as dist

        from slam1_tpu_torch.parallel import mesh as mesh_mod
        own_group = not dist.is_initialized()
        mesh_mod.init_multihost(args.coordinator, args.num_processes,
                                args.process_id, device=args.device)
        rank, world = dist.get_rank(), dist.get_world_size()
        dev = mesh_mod.rank_device(args.device, rank)
        print(f"multihost: process {rank}/{world}, device {dev}",
              file=sys.stderr, flush=True)
    cfg = _config(args)
    if args.checkpoint_every:
        cfg = cfg.replace(runtime=dataclasses.replace(
            cfg.runtime, checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir))
    # One row per logged frame: the frames are picked below, every
    # --log-every-th (the reference's logger thins them once more).
    log = MetricsLogger(args.metrics,
                        stream=sys.stderr if args.verbose else None)
    timers = StageTimers()
    decoder = None

    if args.synthetic:
        from slam1_tpu_torch.utils.synthetic import make_world, \
            render_sequence
        world = make_world(args.seed, n_frames=args.synthetic,
                           trajectory=args.trajectory,
                           image_hw=(cfg.image.height, cfg.image.width),
                           device=dev)
        cam = world.cam
        lefts, rights = render_sequence(world, cfg.image.height,
                                        cfg.image.width)
        gt = world.poses.cpu().numpy()
        frames = ((lefts[i], rights[i]) for i in range(args.synthetic))
        n_frames = args.synthetic
    else:
        from slam1_tpu_torch.utils.kitti import KittiSequence, decoder_for
        seq = KittiSequence(args.data, (cfg.image.height, cfg.image.width),
                            poses_path=args.poses,
                            max_frames=args.max_frames, device=dev)
        cam, gt, n_frames = seq.cam, seq.gt, len(seq)
        decoder = decoder_for(seq.lefts[0]) if n_frames else None
        print(f"decoder: {decoder}", file=sys.stderr)
        frames = ((torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
                  for l, r in seq.frames())

    if args.vo_only:
        state = None
        poses = []      # device tensors; one host transfer at the end
        last_m = None
        for i, (l, r) in enumerate(frames):
            with timers.stage("frame"):
                if state is None:
                    state = vo.init_state(l, r, cam, cfg, args.seed)
                else:
                    state, last_m = vo.vo_step(state, l, r, cam, cfg)
            poses.append(state.T_w_cam)
            # Read back only at the logging cadence: a per-frame read
            # would wait for the card every frame.
            if last_m is not None and i % args.log_every == 0:
                log.log(frame=i, inliers=int(last_m.num_inliers),
                        err=float(last_m.mean_reproj_err))
        with timers.stage("sync"):
            poses = torch.stack(poses).cpu().numpy()
        system = None
    else:
        if args.resume:
            system = pipeline.SlamSystem.resume(args.resume, cam, cfg,
                                                device=dev)
            skip = system.frame_count + 1
            print(f"resumed at frame {system.frame_count}", file=sys.stderr)
        else:
            system = pipeline.SlamSystem(cam, cfg, seed=args.seed)
            skip = 0
        for i, (l, r) in enumerate(frames):
            if i < skip:
                continue
            with timers.stage("frame"):
                system.process(l, r)
        with timers.stage("sync"):
            poses = system.finalize()
        for m in system.metrics[::args.log_every]:
            log.log(frame=m.frame, inliers=int(m.num_inliers),
                    err=float(m.mean_reproj_err))
    log.close()
    _launch_line(dev)

    if args.out:
        np.save(args.out, poses)
        print(f"saved trajectory: {args.out}", file=sys.stderr)
    if gt is not None:
        ate = evalmetrics.ate_rmse(poses, gt, align=not args.no_align)
        t_rpe, r_rpe = evalmetrics.rpe(poses, gt)
        result = {"frames": n_frames, "ate_rmse_m": ate,
                  "rpe_trans_m": t_rpe, "rpe_rot_deg": r_rpe,
                  "timing": timers.summary()}
        if system is not None:
            result["loop_closures"] = len(system.loop_edges)
        if decoder is not None:
            result["decoder"] = decoder
        print(json.dumps(result, default=float))
    if own_group:
        dist.destroy_process_group()
    return 0


def _cmd_eval(args):
    from slam1_tpu_torch.utils import evalmetrics
    from slam1_tpu_torch.utils.kitti import load_poses
    est = np.load(args.est) if args.est.endswith(".npy") \
        else load_poses(args.est)
    gt = np.load(args.gt) if args.gt.endswith(".npy") else load_poses(args.gt)
    print(json.dumps({
        "ate_rmse_m": evalmetrics.ate_rmse(est, gt, align=not args.no_align),
        "rpe": evalmetrics.rpe(est, gt, delta=args.delta),
        "final_pose_diff": evalmetrics.final_pose_diff(est, gt).tolist(),
    }))
    return 0


def _cmd_ba(args):
    """Offline backend pass. Two modes:
      - trajectory .npy: pose-graph relaxation over odometry edges;
      - --state checkpoint.npz: global bundle adjustment over all
        keyframes and landmarks, the checkpoint's odometry chain and
        loop closures as pose priors; with --distributed the
        landmark-sharded BA (no priors) over the process group's ranks,
        rank 0 writing the result."""
    import torch

    from slam1_tpu_torch import runtime

    dev = runtime.device(args.device)
    if args.state:
        import dataclasses

        from slam1_tpu_torch.models import pipeline
        from slam1_tpu_torch.ops.camera import StereoCamera
        mesh = own_group = None
        if args.distributed:
            import torch.distributed as dist

            from slam1_tpu_torch.parallel import mesh as mesh_mod
            own_group = not dist.is_initialized()
            mesh = mesh_mod.make_mesh(lm_axis=args.lm_shards or None,
                                      device=args.device)
            dev = mesh.device
        cfg = _config(args)
        if args.iters is not None:   # --iters sets the LM iterations
            cfg = dataclasses.replace(
                cfg, ba=dataclasses.replace(cfg.ba, lm_iters=args.iters))
        cam = StereoCamera.for_canvas(cfg.image.height, cfg.image.width,
                                      device=dev) \
            if args.tiny else StereoCamera.kitti_default(device=dev)
        sys_ = pipeline.SlamSystem.resume(args.state, cam, cfg, device=dev)
        st = sys_.state
        n_kf = int(st.kf.n)
        # Bucket the keyframe count to bound the shapes a run sees.
        bucket = next((b for b in (128, 512, 2048, 8192) if b >= n_kf),
                      n_kf)
        bucket = min(bucket, st.kf.xyz.shape[0])
        # Compacted observation bucket (the raw slot layout is mostly
        # padding; see pipeline.build_global_problem).
        n_obs_real = int(torch.sum(st.map.obs_count[:bucket]))
        obs_bucket = 1 << max(int(np.ceil(np.log2(max(n_obs_real, 1)))), 10)
        extra = {}
        if mesh is not None:
            sys_.state, cost, dropped = _distributed_ba(
                st, sys_.cam, cfg, mesh, n_kf, bucket, obs_bucket)
            extra = {"mesh": dict(mesh.shape), "dropped_obs": dropped}
        else:
            loop_rows = sys_.loop_edge_rows() if sys_.loop_edges else None
            sys_.state, cost = pipeline.global_ba_step(
                st, sys_.cam, cfg, n_kf=bucket, obs_bucket=obs_bucket,
                loop_rows=loop_rows)
        if mesh is None or mesh.rank == 0:
            np.save(args.out, sys_.poses())
            _launch_line(dev)
            print(json.dumps({"keyframes": n_kf, "final_cost": float(cost),
                              **extra}))
        if own_group:
            dist.destroy_process_group()
        return 0

    from slam1_tpu_torch.models import posegraph
    from slam1_tpu_torch.ops import se3
    poses = np.load(args.traj)
    f = len(poses)
    rel = se3.log_se3(torch.as_tensor(
        np.linalg.inv(poses[:-1]) @ poses[1:]).to(dev))
    ei = torch.arange(f - 1, device=dev)
    graph = posegraph.PoseGraph(
        poses=torch.as_tensor(poses).to(dev), ei=ei, ej=ei + 1,
        z=se3.exp_se3(rel), w=torch.ones(f - 1, device=dev))
    opt, cost = posegraph.optimize(
        graph, iters=args.iters if args.iters is not None else 10)
    np.save(args.out, opt.cpu().numpy())
    _launch_line(dev)
    print(json.dumps({"frames": f, "final_cost": float(cost)}))
    return 0


def _distributed_ba(st, cam, cfg, mesh, n_kf: int, bucket: int,
                    obs_bucket: int):
    """The landmark-sharded BA of the checkpoint's global problem (no
    pose priors) over the mesh's "lm" ranks, written back into the
    state: (state, final cost, observations the partitioner dropped)."""
    import torch

    from slam1_tpu_torch.models import pipeline
    from slam1_tpu_torch.parallel.dist_ba import (
        distributed_bundle_adjust, partition_problem_device)
    prob, frames = pipeline.build_global_problem(st, bucket, obs_bucket)
    # Every shard may hold the whole observation bucket: landmark
    # blocks are insertion-ordered and spatially clustered, so per-shard
    # counts can be far from uniform.
    sharded, orig, n_dropped = partition_problem_device(
        prob, mesh.shape["lm"], obs_per_shard=obs_bucket)
    out, cost = distributed_bundle_adjust(sharded, cam, cfg.ba, mesh)
    dropped = int(n_dropped)
    if dropped:
        print(f"warning: {dropped} observations dropped by the "
              f"partitioner (raise obs_per_shard)", file=sys.stderr)
    # Row validity: padding keyframe rows' frames are clipped to 0 and
    # must not write traj[0]; partitioner pad rows (orig >= the map's
    # capacity) must not write the last landmark.
    rows = torch.arange(bucket, device=frames.device)
    ok = (rows < n_kf) & (st.kf.frame_of_row[:bucket] >= 0)
    traj = st.traj.clone()
    traj[frames[ok]] = out.poses[ok]
    kf_poses = st.kf.poses.clone()
    kf_poses[rows[ok]] = out.poses[ok]
    lm_rows = orig.reshape(-1).long()
    keep = lm_rows < st.map.xyz.shape[0]
    xyz = st.map.xyz.clone()
    xyz[lm_rows[keep]] = out.points.reshape(-1, 3)[keep]
    return (st._replace(traj=traj, map=st.map._replace(xyz=xyz),
                        kf=st.kf._replace(poses=kf_poses)), cost, dropped)


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; raises "
                        "where there is no card; tests pass cpu)")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="slam-torch",
        description="stereo SLAM, PyTorch/CUDA port (no `bench` command "
                    "yet: it waits for the port's benchmark)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run VO / full SLAM")
    pr.add_argument("--data", help="KITTI sequence dir (image_0/, calib.txt)")
    pr.add_argument("--poses", help="GT poses.txt for evaluation")
    pr.add_argument("--synthetic", type=int, default=0,
                    help="use N synthetic frames instead of --data (the "
                         "port's numpy-seeded world: not the JAX "
                         "package's world of the same seed)")
    pr.add_argument("--trajectory", default="arc",
                    choices=["straight", "arc", "loop", "loop2"])
    pr.add_argument("--vo-only", action="store_true")
    pr.add_argument("--tiny", action="store_true", help="tiny test config")
    pr.add_argument("--max-frames", type=int)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--out", help="save trajectory .npy")
    pr.add_argument("--metrics", help="JSONL metrics path")
    pr.add_argument("--log-every", type=int, default=10)
    pr.add_argument("--no-align", action="store_true")
    pr.add_argument("--verbose", action="store_true")
    pr.add_argument("--resume", help="resume from a checkpoint .npz")
    pr.add_argument("--checkpoint-every", type=int, default=0)
    pr.add_argument("--checkpoint-dir", default="checkpoints")
    _device_arg(pr)
    pr.add_argument("--multihost", action="store_true",
                    help="bring up the torch.distributed process group "
                         "before running (torchrun's environment, or "
                         "--coordinator with --num-processes and "
                         "--process-id)")
    pr.add_argument("--coordinator", default=None,
                    help="rendezvous address host:port (or a tcp:// or "
                         "file:// URL) for --multihost")
    pr.add_argument("--num-processes", type=int, default=None,
                    help="world size for --multihost --coordinator")
    pr.add_argument("--process-id", type=int, default=None,
                    help="this process's rank for --multihost "
                         "--coordinator")
    pr.set_defaults(fn=_cmd_run)

    pe = sub.add_parser("eval", help="ATE/RPE of est vs gt")
    pe.add_argument("est")
    pe.add_argument("gt")
    pe.add_argument("--delta", type=int, default=1)
    pe.add_argument("--no-align", action="store_true")
    pe.set_defaults(fn=_cmd_eval)

    pb = sub.add_parser("ba", help="offline backend pass (pose graph or "
                                   "global bundle adjustment)")
    pb.add_argument("traj", nargs="?", help="trajectory .npy")
    pb.add_argument("--state", help="SlamSystem checkpoint .npz for "
                                    "global BA over keyframes+landmarks")
    pb.add_argument("--tiny", action="store_true")
    pb.add_argument("--out", default="optimized.npy")
    pb.add_argument("--iters", type=int, default=None,
                    help="GN iterations (trajectory mode) / LM iterations "
                         "(--state mode); defaults: 10 / cfg.ba.lm_iters")
    _device_arg(pb)
    pb.add_argument("--distributed", action="store_true",
                    help="landmark-sharded Schur BA over the ranks of "
                         "the process group (--state mode; launch N ranks "
                         "with torchrun, or run plainly for one)")
    pb.add_argument("--lm-shards", type=int, default=0,
                    help="landmark shards for --distributed; must divide "
                         "the world size (default: 4, 2 or 1, the "
                         "largest that divides it)")
    pb.set_defaults(fn=_cmd_ba)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
