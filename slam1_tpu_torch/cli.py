"""Command-line interface of the PyTorch/CUDA port: `slam-torch
run|ba|eval` (counterpart of `slam1_tpu/cli.py`).

  run    — VO or full SLAM over a KITTI sequence dir or --synthetic
  ba     — offline pose-graph / global bundle-adjustment pass
  eval   — ATE/RPE of an estimated trajectory vs ground truth

Every command that computes runs on `--device` (default `cuda`, which
raises where there is no card: a run meant for the card never carries on
silently on the CPU). The distributed options are parsed and raise
NotImplementedError: the distributed layer is not ported yet. There is
no `bench` command until the port has a bench.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

DISTRIBUTED = ("the distributed layer (parallel/: multi-host meshes, "
               "sharded BA) is not ported to slam1_tpu_torch yet")


def _refuse_distributed(args):
    flags = {"--multihost": getattr(args, "multihost", False),
             "--coordinator": getattr(args, "coordinator", None),
             "--num-processes": getattr(args, "num_processes", None),
             "--process-id": getattr(args, "process_id", None),
             "--distributed": getattr(args, "distributed", False),
             "--lm-shards": getattr(args, "lm_shards", 0)}
    given = [k for k, v in flags.items() if v not in (None, False, 0)]
    if given:
        raise NotImplementedError(f"{', '.join(given)}: {DISTRIBUTED}")


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

    _refuse_distributed(args)
    dev = runtime.device(args.device)
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
        loop closures as pose priors."""
    import torch

    from slam1_tpu_torch import runtime

    _refuse_distributed(args)
    dev = runtime.device(args.device)
    if args.state:
        import dataclasses

        from slam1_tpu_torch.models import pipeline
        from slam1_tpu_torch.ops.camera import StereoCamera
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
        loop_rows = sys_.loop_edge_rows() if sys_.loop_edges else None
        sys_.state, cost = pipeline.global_ba_step(
            st, sys_.cam, cfg, n_kf=bucket, obs_bucket=obs_bucket,
            loop_rows=loop_rows)
        np.save(args.out, sys_.poses())
        _launch_line(dev)
        print(json.dumps({"keyframes": n_kf, "final_cost": float(cost)}))
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


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; raises "
                        "where there is no card; tests pass cpu)")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="slam-torch",
        description="stereo SLAM, PyTorch/CUDA port (no `bench` command "
                    "yet: the port has no bench)")
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
                    help="not ported: raises NotImplementedError")
    pr.add_argument("--coordinator", default=None,
                    help="not ported: raises NotImplementedError")
    pr.add_argument("--num-processes", type=int, default=None,
                    help="not ported: raises NotImplementedError")
    pr.add_argument("--process-id", type=int, default=None,
                    help="not ported: raises NotImplementedError")
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
                    help="not ported: raises NotImplementedError")
    pb.add_argument("--lm-shards", type=int, default=0,
                    help="not ported: raises NotImplementedError")
    pb.set_defaults(fn=_cmd_ba)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
