"""Large-map single-card global BA of the PyTorch/CUDA port (counterpart
of tools/global_ba_scale.py).

Runs the port's full pipeline (`SlamSystem` at `SlamConfig()` with
keyframe_every=2) over a synthetic `loop2` clip (default 2000 frames,
so ~1000 keyframes; 15 points per frame, numpy seed 5), then the
offline loop sweep, `finalize`, and one global bundle adjustment over
all keyframes at the keyframe count's row bucket with its compacted
observation bucket and the loop edges as pose priors. Prints ONE JSON
record as its last line (the keys of BENCH_GLOBAL.json, `backend` the
torch device type): keyframes, observations, wall times, cost before /
after, the per-LM-iteration trace, keyframe ATE (VO, before, after) and
loop counts. The global BA is timed as the card runs it (a warm call
captures its graphs, the timed one replays them) and again eagerly
(`graphs=False`): ms per LM iteration of each, and the graphed
trajectory's largest difference from the eager one.

Timing: the renderer runs interleaved with the pipeline in 64-frame
chunks (a 2000-frame stack would hold 7.7 GB), each chunk synchronised
and its time kept apart, so `pipeline_fps` counts pipeline work only and
`pipeline_fps_steady` is the second half's.

Usage (from the repo root):
  python tools/port_global_ba_scale.py [--frames 2000] [--device cuda]
      [--out PATH]           also write the record to PATH
      [--ckpt [PATH]]        save a post-run checkpoint (the port's
                             format; default .scratch/port_gba<N>.npz)
      [--from-ckpt PATH]     skip the pipeline; resume PATH and run the
                             backend stages only
      [--tiny]               tiny config (CPU tests)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SCRATCH = os.path.join(_REPO, ".scratch")
ROW_BUCKETS = (128, 512, 1024, 2048, 8192)


def default_ckpt(n_frames: int) -> str:
    return os.path.join(SCRATCH, f"port_gba{n_frames}.npz")


def scale_config(tiny: bool = False):
    from slam1_tpu_torch.config import SlamConfig, tiny_config
    cfg = tiny_config() if tiny else SlamConfig()
    return cfg.replace(mapping=dataclasses.replace(cfg.mapping,
                                                   keyframe_every=2))


def make_scale_world(n, cfg, device):
    from slam1_tpu_torch.bench import make_clip_world
    return make_clip_world(5, n, 15 * n, "loop2", cfg, device)


def row_bucket(n_kf: int, capacity: int) -> int:
    """The smallest of ROW_BUCKETS holding n_kf rows, within the store."""
    return min(next((b for b in ROW_BUCKETS if b >= n_kf), n_kf), capacity)


def obs_bucket_for(state, bucket: int) -> int:
    """The compacted observation bucket: the next power of two >= the
    real observation count of the first `bucket` rows, at least 1024."""
    n_obs_real = int(torch.sum(state.map.obs_count[:bucket]))
    return 1 << max(int(np.ceil(np.log2(max(n_obs_real, 1)))), 10)


def run_pipeline(n, cfg, world, ckpt_path=None):
    """Feed the full clip; returns (system, timing dict)."""
    from slam1_tpu_torch.bench import BLOCK, CHUNK, render_chunk, sync
    from slam1_tpu_torch.models import pipeline

    dev = world.points.device
    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=30)
    render_s = 0.0
    t_run0 = time.perf_counter()
    t_half = None
    half_render_s = 0.0
    n_half = 0
    done = 0
    while done < n:
        hi = min(done + CHUNK, n)
        sync(dev)                       # the pipeline's queue is its own
        t_r = time.perf_counter()
        L, R = render_chunk(world, done, hi, cfg)
        sync(dev)
        render_s += time.perf_counter() - t_r
        k0 = 0
        if done == 0:
            sys_.process(L[0], R[0])
            k0 = 1
        while k0 < hi - done:
            k = min(BLOCK, hi - done - k0)
            sys_.process_block(L[k0:k0 + k], R[k0:k0 + k])
            k0 += k
        done = hi
        if t_half is None and done >= n // 2:
            sync(dev)
            t_half = time.perf_counter()
            half_render_s = render_s
            n_half = done
        if done % 512 == 0:
            print(f"  {done}/{n} frames", file=sys.stderr, flush=True)
    sync(dev)
    t_end = time.perf_counter()
    pipe_wall = (t_end - t_run0) - render_s
    fps = (n - 1) / pipe_wall                  # first calls included
    # steady-state fps: the second half, renderer excluded
    fps_steady = (n - n_half) / ((t_end - t_half)
                                 - (render_s - half_render_s))
    timing = {
        "pipeline_wall_s": round(pipe_wall, 2),
        "render_wall_s": round(render_s, 2),
        "pipeline_fps": round(fps, 2),
        "pipeline_fps_steady": round(fps_steady, 2),
    }
    if ckpt_path:
        sys_.save_checkpoint(ckpt_path)
        print(f"  checkpoint -> {ckpt_path}", file=sys.stderr)
    return sys_, timing


def backend_stages(sys_, world, cfg, n):
    """Offline loop sweep, finalize (full-strength PGO over all accepted
    edges), then global BA with its convergence trace. Returns the
    result dict."""
    from slam1_tpu_torch.bench import sync
    from slam1_tpu_torch.models import pipeline
    from slam1_tpu_torch.models.ba import _cost
    from slam1_tpu_torch.utils.evalmetrics import ate_rmse

    gt = world.poses.cpu().numpy()
    dev = sys_.state.traj.device
    st = sys_.state
    n_kf = int(st.kf.n)
    kf_frames = st.kf.frame_of_row[:n_kf].cpu().numpy()

    def kf_ate(state):
        return float(ate_rmse(state.traj.cpu().numpy()[kf_frames],
                              gt[kf_frames], align=False))

    ate_vo = kf_ate(st)                   # before the final PGO
    # Offline loop-recovery sweep + finalize: the trajectory must be
    # globally consistent before global BA's local linearisation helps.
    t0 = time.perf_counter()
    added = sys_.detect_loops_offline(stride_kf=8, run_pgo=False)
    sweep_wall = time.perf_counter() - t0
    print(f"  offline loop sweep: +{added} edges ({sweep_wall:.1f}s)",
          file=sys.stderr)
    sys_.finalize()
    st = sys_.state
    ate_pgo = kf_ate(st)

    for e in sys_.loop_events:
        print(f"  loop event f={e.frame} cand={e.candidate} "
              f"inl={e.num_inliers} acc={e.accepted}", file=sys.stderr)
    hits = [(m.frame, m.loop_candidate, round(m.loop_chi2, 3))
            for m in sys_.metrics if m.loop_hit]
    print(f"  {len(hits)} BoW hit rows; last 40: {hits[-40:]}",
          file=sys.stderr)

    bucket = row_bucket(n_kf, st.kf.xyz.shape[0])
    obs_bucket = obs_bucket_for(st, bucket)
    prob, _ = pipeline.build_global_problem(st, bucket, obs_bucket)
    n_obs = int(torch.sum(prob.w > 0))
    cost_before = float(_cost(prob, sys_.cam, cfg.ba.huber_delta)[0])

    # Pose priors (odometry chain + verified closures) ride inside the
    # BA objective; the one-shot global_trim_px gate replaces the
    # graduated in-loop cut (outlier_px=0), and LM starts at lam = 1,
    # where the first accepted step lands.
    loop_rows = sys_.loop_edge_rows()
    cfg = dataclasses.replace(
        cfg, ba=dataclasses.replace(cfg.ba, outlier_px=0.0,
                                    lm_lambda0=1.0))
    # How many observations the pre-solve association gate removes (the
    # solve itself recomputes the mask).
    r0 = _cost(prob, sys_.cam, cfg.ba.huber_delta)[1]
    rn0 = torch.linalg.norm(r0[:, :2], dim=-1)
    w0 = prob.w > 0
    n_trim = int((w0 & (rn0 >= cfg.ba.global_trim_px)).sum()) \
        if cfg.ba.global_trim_px > 0 else 0
    def global_ba(graphs=True):
        sync(dev)
        t0 = time.perf_counter()
        res = pipeline.global_ba_step(
            st, sys_.cam, cfg, n_kf=bucket, obs_bucket=obs_bucket,
            return_trace=True, loop_rows=loop_rows, graphs=graphs)
        sync(dev)
        return res, time.perf_counter() - t0

    # A warm call out of the timed run: first-call set-up of the solvers
    # and the allocator, and on a card the capture of the graphs, which
    # the timed call replays. Then the same call eagerly (graphs=False;
    # on the CPU both are eager).
    global_ba()
    (st2, cost, trace), ba_wall = global_ba()
    (st3, _, _), eager_wall = global_ba(graphs=False)

    ate_after = kf_ate(st2)
    n_acc = sum(1 for e in sys_.loop_events if e.accepted)
    n_rej = sum(1 for e in sys_.loop_events if not e.accepted)
    tr = {k: getattr(trace, k).cpu().numpy() for k in trace._fields}
    return {
        "keyframes": n_kf,
        "bucket": bucket,
        "global_ba_observations": n_obs,
        "global_ba_trimmed": n_trim,
        "global_trim_px": cfg.ba.global_trim_px,
        "global_ba_wall_s": round(ba_wall, 3),
        "global_ba_eager_wall_s": round(eager_wall, 3),
        "ms_per_lm_iteration": round(1e3 * ba_wall / cfg.ba.lm_iters, 2),
        "eager_ms_per_lm_iteration": round(
            1e3 * eager_wall / cfg.ba.lm_iters, 2),
        "graphed_traj_max_abs_diff_from_eager": float(
            (st2.traj - st3.traj).abs().max()),
        "lm_iters": cfg.ba.lm_iters,
        "cg_iters": cfg.ba.cg_iters,
        "cost_before": round(cost_before, 2),
        "cost_after": round(float(cost), 2),
        # Accepted cost after each LM iteration and the observations
        # surviving the IRLS cut: a weak reduction is attributable.
        "ba_cost_trace": [round(float(c), 1) for c in tr["cost"]],
        "ba_obs_surviving": [int(v) for v in tr["n_obs"]],
        "ba_lam_trace": [float(f"{float(v):.2e}") for v in tr["lam"]],
        "ba_accept_trace": [bool(v) for v in tr["accept"]],
        "ba_dc_norm_trace": [float(f"{float(v):.3e}")
                             for v in tr["dc_norm"]],
        "kf_ate_vo_m": round(ate_vo, 4),
        "kf_ate_before_m": round(ate_pgo, 4),
        "kf_ate_after_m": round(ate_after, 4),
        "loop_closures": len(sys_.loop_edges),
        "loop_rejected": n_rej,
        "loop_accepted_events": n_acc,
        "loop_sweep_added": added,
        "loop_sweep_wall_s": round(sweep_wall, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--out", type=str, default=None,
                    help="also write the record here")
    ap.add_argument("--ckpt", nargs="?", const="", default=None,
                    help="save a post-run checkpoint here (default "
                         ".scratch/port_gba<frames>.npz)")
    ap.add_argument("--from-ckpt", type=str, default=None,
                    help="skip the pipeline; resume this checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises where there "
                         "is no card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CPU tests)")
    args = ap.parse_args(argv)

    from slam1_tpu_torch import runtime
    from slam1_tpu_torch.models import pipeline

    dev = runtime.device(args.device)
    n = args.frames
    cfg = scale_config(args.tiny)
    world = make_scale_world(n, cfg, dev)

    if args.from_ckpt:
        sys_ = pipeline.SlamSystem.resume(args.from_ckpt, world.cam, cfg,
                                          device=dev)
        timing = {}
        if sys_.frame_count != n - 1:
            print(f"  note: checkpoint holds {sys_.frame_count + 1} "
                  f"frames, --frames {n}", file=sys.stderr)
    else:
        ckpt = default_ckpt(n) if args.ckpt == "" else args.ckpt
        sys_, timing = run_pipeline(n, cfg, world, ckpt_path=ckpt)

    out = {"frames": n, "data": f"synthetic-loop2-{n}", **timing,
           **backend_stages(sys_, world, cfg, n),
           "backend": dev.type,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
