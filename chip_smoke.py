"""Drive the PyTorch/CUDA port's main paths once on one GPU: the stereo
VO step, then the full SLAM system (mapping, BoW, place recognition,
loop verification, pose-graph optimisation) with local BA off.

    python3 chip_smoke.py

Run from the repo root on a machine with one CUDA card (sm_90a: H100).
It imports torch, numpy and `slam1_tpu_torch` only — never jax. Phases,
each printed as it finishes; any failed check raises, so the script
exits non-zero and never prints the final `ok` line:

  1. device  — CUDA must be available; prints the card's name and power
               limit as nvidia-smi reports them.
  2. build   — compiles the CUDA kernels from `slam1_tpu_torch/csrc/`.
  3. kernels — each kernel against its plain PyTorch twin on the card,
               at the main paths' shapes: fast_score on a rendered and
               a random image at the three pyramid levels (batch 2),
               hamming_top2 at 2688 x 2688 ungated / epipolar-gated /
               window-gated / with duplicated descriptors (ties); the
               batched hamming_top2 at 8 x 1024 x 1024 (a verification
               slate, with two padded all-invalid pairs and ties) and
               chain_sweep at 2048 poses (full sweep and 601 live rows).
  4. slice   — renders the 24-frame arc clip (6000 points) at the
               default config, runs VO `run_sequence` on CUDA tensors
               with the launch counters reset just before, checks the
               counts, pnp_ok and ATE; then runs the first 6 frames on
               CPU tensors (the plain path) and on CUDA with the same
               RANSAC draws and compares them.
  5. slam    — renders bench.measure_slam's clip with the port's
               renderer (loop2, 600 frames, 20 points per frame, speed
               1.0, numpy seed 11) at the default config with
               ba.local_every=0 and bow.poll_lag_s=0; runs
               `SlamSystem.process` on frame 0, `process_block` on
               blocks of 32, then `finalize`, with the launch counters
               reset just before and read just after; checks the launch
               counts (fast_score 3F, hamming_top2 2F-1, one batched
               hamming_top2 per slate, chain_sweep > 0), >= 2 accepted
               loop edges each within 0.5 m of the ground-truth relative
               translation, the pose-graph cost after finalize <= before
               it, ATE after finalize <= the odometry-only ATE (the ATE
               before finalize is printed: the reference's final
               relaxation can raise it by centimetres), and pnp_ok >=
               0.8. Then the first 6 frames of `slam_step` on
               CPU and on CUDA with the same draws (num_stereo, kf.n and
               map.cursor within 2%, poses within 1e-2 m), and the host
               syncs of one warm vo_step and one warm slam_step under
               torch.cuda.set_sync_debug_mode("warn") (slam_step may not
               add any).
  6. times   — CUDA-event times of each kernel and its plain twin, the VO
               frames/s of the per-frame loop, the SLAM frames/s of the
               process loop, and ms per place_query, per slate and per
               PGO.

The last four lines are: a JSON object of the end-to-end numbers, the
nvidia-smi line (name, power limit), {"kernels": [...]} and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from slam1_tpu_torch import runtime  # noqa: E402
from slam1_tpu_torch.config import SlamConfig  # noqa: E402
from slam1_tpu_torch.models import pipeline, posegraph, vo  # noqa: E402
from slam1_tpu_torch.models.loop_closure import place_query, \
    verify_loop_slate  # noqa: E402
from slam1_tpu_torch.ops import cuda_kernels, fast, se3  # noqa: E402
from slam1_tpu_torch.ops.detector import _downsample2  # noqa: E402
from slam1_tpu_torch.ops.pnp import draw_uniform  # noqa: E402
from slam1_tpu_torch.utils import synthetic  # noqa: E402
from slam1_tpu_torch.utils.evalmetrics import ate_rmse  # noqa: E402

N_FRAMES = 24
N_POINTS = 6000
CPU_FRAMES = 6
SEED = 0
FAST_TOL = 1e-5
SLAM_FRAMES = 600
SLAM_SEED = 11
SLAM_BLOCK = 32
SLATE_B = 8
CHAIN_F, CHAIN_LIVE = 2048, 601
CHAIN_TOL = 1e-4             # max |kernel - twin| / max |twin|
KERNELS = {
    "fast_score": ("slam1_tpu_torch/csrc/fast_score.cu",
                   "slam1_tpu/ops/pallas_kernels.py:229"),
    "hamming_top2": ("slam1_tpu_torch/csrc/hamming_top2.cu",
                     "slam1_tpu/ops/pallas_kernels.py:100"),
    "hamming_top2_batched": ("slam1_tpu_torch/csrc/hamming_top2.cu",
                             "slam1_tpu/ops/pallas_kernels.py:100"),
    # not a TPU kernel: the XLA scans of the reference's chain solve
    "chain_sweep": ("slam1_tpu_torch/csrc/chain_sweep.cu",
                    "slam1_tpu/models/posegraph.py:74"),
}


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def cuda_ms(fn, reps=20, warm=3):
    """Mean device time of fn() in ms, by CUDA events over `reps` runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    say("build", seconds=f"{time.perf_counter() - t0:.3f}",
        nvcc_seconds=cuda_kernels.build_seconds,
        library=os.path.basename(cuda_kernels.library_path()))


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
    for name, img in (("rendered", rendered), ("random", noise)):
        for lvl, im in enumerate(pyramid(img, cfg.detector.num_levels)):
            im = im.contiguous()
            k = cuda_kernels.fast_score_cuda(im, thr, arc)
            p = fast.fast_score(im, thr, arc)
            torch.cuda.synchronize()
            err = (k - p).abs().max().item()
            same_mask = bool(torch.equal(k > 0, p > 0))
            say("kernels", kernel="fast_score", image=name, level=lvl,
                shape=tuple(im.shape), max_abs_err=err,
                corners=int((p > 0).sum()), masks_equal=same_mask)
            check(same_mask and err <= FAST_TOL,
                  f"fast_score {name} level {lvl}: err {err}, masks "
                  f"equal {same_mask}")
            errs["fast_score"] = max(errs["fast_score"], err)

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
    cases = {
        "ungated": (da, db, {}),
        "epipolar": (da, db, dict(uv_a=uva, uv_b=uvb, dy_tol=mm.epipolar_dy,
                                  dx_lo=mm.min_disparity,
                                  dx_hi=mm.max_disparity)),
        "window": (da, db, dict(uv_a=uva, uv_b=uvb, dy_tol=r, dx_lo=-r,
                                dx_hi=r)),
        "ties": (dup, dup_b, {}),
    }
    for name, (a, b, kw) in cases.items():
        outk = cuda_kernels.hamming_top2_cuda(a, b, ma, mb, **kw)
        outp = cuda_kernels.hamming_top2_plain(a, b, ma, mb, **kw)
        torch.cuda.synchronize()
        equal = [bool(torch.equal(x, y)) for x, y in zip(outk, outp)]
        err = max((x.long() - y.long()).abs().max().item()
                  for x, y in zip(outk, outp))
        ties = int((outp[0] == outp[1]).sum())
        say("kernels", kernel="hamming_top2", case=name, n=n,
            equal_d1_d2_idx_colbest=equal, max_abs_err=err, row_ties=ties)
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
    want = {"fast_score": cfg.detector.num_levels * f,
            "hamming_top2": 2 * f - 1}
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


def chain_inputs(f, n_live, seed):
    """Chain-sweep operands shaped like a pose graph's: Ji = -(rotation
    blocks) of the chain adjoints, JjInv = I + 1e-4 noise, unit-weight
    edges; rows from n_live on decoupled (Ji = 0, JjInv = I)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    R = se3.exp_so3(0.05 * torch.randn(f, 3, generator=g))
    ji = torch.zeros(f, 6, 6)
    ji[:, :3, :3] = -R
    ji[:, 3:, 3:] = -R
    ji[:, :3, 3:] = -0.3 * R
    jj = torch.eye(6) + 1e-4 * torch.randn(f, 6, 6, generator=g)
    winv = torch.full((f,), 1.0 / (1.0 + 1e-4))
    ji[n_live:] = 0.0
    jj[n_live:] = torch.eye(6)
    winv[n_live:] = 1e4
    v = torch.randn(f, 6, generator=g)
    return jj, ji, winv, v


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

    worst = 0.0
    for n_live in (CHAIN_F, CHAIN_LIVE):
        ops = [x.to(dev) for x in chain_inputs(CHAIN_F, n_live, n_live)]
        xk = cuda_kernels.chain_sweep_cuda(*ops, n_live)
        xp = cuda_kernels.chain_sweep_plain(*ops, n_live)
        torch.cuda.synchronize()
        err = (xk - xp).abs().max().item()
        scale = xp.abs().max().item()
        say("kernels", kernel="chain_sweep", poses=CHAIN_F, n_live=n_live,
            max_abs_err=err, max_abs_x=scale, rel_err=err / scale)
        check(bool(torch.isfinite(xk).all()) and err <= CHAIN_TOL * scale,
              f"chain_sweep n_live={n_live}: |err| {err} vs scale {scale}")
        worst = max(worst, err)
    errs["chain_sweep"] = worst
    return errs


def slam_config():
    """The default config with the two parts the port lacks switched off
    as the JAX package documents: local BA and the asynchronous drain."""
    cfg = SlamConfig()
    return cfg.replace(ba=dataclasses.replace(cfg.ba, local_every=0),
                       bow=dataclasses.replace(cfg.bow, poll_lag_s=0.0))


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
    """The weighted pose-graph cost (odometry + loop edges, as _run_pgo
    builds the graph) of the (F,4,4) trajectory `poses`."""
    st = sys_.state
    f = poses.shape[0]
    ei = torch.arange(f - 1)
    le = sys_.loop_edges
    graph = posegraph.PoseGraph(
        poses=torch.as_tensor(poses, dtype=torch.float32),
        ei=torch.cat([ei, torch.tensor([i for i, _, _, _ in le])]),
        ej=torch.cat([ei + 1, torch.tensor([j for _, j, _, _ in le])]),
        z=torch.cat([se3.exp_se3(-st.rel[1:f].cpu()),
                     torch.as_tensor(np.stack([z for _, _, z, _ in le]),
                                     dtype=torch.float32)]),
        w=torch.cat([st.rel_mask[1:f].cpu().float(),
                     torch.tensor([w for _, _, _, w in le])]))
    return float(posegraph.optimize(graph, iters=0)[1])


def phase_slam(cfg, dev):
    h, w = cfg.image.height, cfg.image.width
    t0 = time.perf_counter()
    world = synthetic.make_world(SLAM_SEED, n_frames=SLAM_FRAMES,
                                 n_points=20 * SLAM_FRAMES,
                                 trajectory="loop2", speed=1.0, device=dev)
    lefts, rights = synthetic.render_sequence(world, h, w)
    torch.cuda.synchronize()
    say("slam-render", frames=SLAM_FRAMES, points=20 * SLAM_FRAMES,
        seconds=f"{time.perf_counter() - t0:.3f}")
    f = SLAM_FRAMES
    sys_ = pipeline.SlamSystem(world.cam, cfg, seed=SEED, bow_train_frame=30)
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_.process(lefts[0], rights[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for s in range(1, f, SLAM_BLOCK):
        sys_.process_block(lefts[s:s + SLAM_BLOCK], rights[s:s + SLAM_BLOCK])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pre = sys_.poses()
    post = sys_.finalize()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = cuda_kernels.launch_counts()
    gt = world.poses.cpu().numpy()
    ate_pre = ate_rmse(pre, gt, align=False)
    ate_post = ate_rmse(post, gt, align=False)
    odo = odometry_poses(sys_)
    ate_odo = ate_rmse(odo, gt, align=False)
    cost_pre, cost_post = (graph_cost(sys_, p) for p in (pre, post))
    ok_share = float(np.mean([m.pnp_ok for m in sys_.metrics]))
    fps = (f - 1) / (t2 - t1)
    edges = []
    for i, j, Z, _ in sys_.loop_edges:
        Z_true = np.linalg.inv(gt[i]) @ gt[j]
        edges.append((i, j, float(np.linalg.norm(Z[:3, 3] - Z_true[:3, 3]))))
    want = {"fast_score": cfg.detector.num_levels * f,
            "hamming_top2": 2 * f - 1,
            "hamming_top2_batched": sys_.n_slates}
    n_acc = sum(e.accepted for e in sys_.loop_events)
    say("slam", frames=f, bootstrap_seconds=f"{t1 - t0:.3f}",
        loop_seconds=f"{t2 - t1:.3f}", finalize_seconds=f"{t3 - t2:.3f}",
        slam_frames_per_s=fps, launches=counts, expected=want,
        slates=sys_.n_slates, verifications=len(sys_.loop_events),
        accepted=n_acc, loop_edges=edges, ate_odometry_only_m=ate_odo,
        ate_before_finalize_m=ate_pre, ate_after_finalize_m=ate_post,
        pose_graph_cost_before_finalize=cost_pre,
        pose_graph_cost_after_finalize=cost_post, pnp_ok_share=ok_share,
        keyframes=int(sys_.state.kf.n), landmarks=int(sys_.state.map.cursor))
    for name, n in want.items():
        check(counts[name] == n, f"{name} launches {counts[name]} != {n}")
    check(counts["chain_sweep"] > 0, "chain_sweep never launched")
    check(bool(np.isfinite(post).all()) and post.shape == (f, 4, 4),
          "poses not finite / wrong shape")
    check(len(edges) >= 2, f"{len(edges)} loop edges < 2")
    check(all(d < 0.5 for _, _, d in edges),
          f"loop edge off the ground truth by >= 0.5 m: {edges}")
    # finalize's 25-iteration relaxation must lower the pose-graph cost,
    # and the loop-closed trajectory must beat odometry alone. (Its ATE
    # against the live-relaxed trajectory before finalize is printed, not
    # bounded: the reference's own PGO, after 5 live iterations, lowers
    # the cost and can raise ATE by centimetres — see PERF.md.)
    check(cost_post <= cost_pre,
          f"pose-graph cost after finalize {cost_post} > {cost_pre}")
    check(ate_post <= ate_odo,
          f"ATE after finalize {ate_post} > odometry-only {ate_odo}")
    check(ok_share >= 0.8, f"pnp_ok share {ok_share} < 0.8")
    return sys_, world, lefts, rights, counts, dict(
        slam_frames_per_s=fps, slam_ate_odometry_m=ate_odo,
        slam_ate_before_m=ate_pre,
        slam_ate_after_m=ate_post, slam_pnp_ok_share=ok_share,
        slam_loop_edges=len(edges), slam_slates=sys_.n_slates)


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


def phase_times_slam(cfg, sys_, world):
    """ms per place_query, slate and PGO on the final SLAM state, the
    new kernels against their plain twins, and the per-stage host times
    of the SLAM run."""
    st = sys_.state
    kf_n = int(st.kf.n)
    q_row = kf_n - 1
    q_frame = int(st.kf.frame_of_row[q_row])
    n_rows = next(b for b in (128, 512, 1024, 2048, 8192) if b >= kf_n)
    bcfg = cfg.bow
    pq_ms = cuda_ms(lambda: place_query(
        st.kf, q_row, q_frame - bcfg.query_exclude, n_rows,
        k=bcfg.place_topk, thresh=bcfg.place_thresh,
        nms_frames=bcfg.place_nms_frames), reps=5, warm=1)
    pairs = [(j, i) for i, j, _, _ in sys_.loop_edges][:SLATE_B]
    hfs = [a for a, _ in pairs] + [0] * (SLATE_B - len(pairs))
    cs = [c for _, c in pairs] + [-1] * (SLATE_B - len(pairs))
    dev = st.kf.xyz.device
    u = sys_.draws.slate(hfs, cs, 0, pipeline.LOOP_RANSAC_ITERS,
                         pipeline.KF_FEATURES)
    slate_ms = cuda_ms(lambda: verify_loop_slate(
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
    cargs = [x.to(dev) for x in chain_inputs(CHAIN_F, CHAIN_LIVE, 1)]
    cases = {
        "hamming_top2_batched": (
            lambda: cuda_kernels.hamming_top2_batched_plain(*hargs),
            lambda: cuda_kernels.hamming_top2_batched_cuda(*hargs)),
        "chain_sweep": (
            lambda: cuda_kernels.chain_sweep_plain(*cargs, CHAIN_LIVE),
            lambda: cuda_kernels.chain_sweep_cuda(*cargs, CHAIN_LIVE)),
    }
    for name, (plain, kern) in cases.items():
        order = []
        for which, fn in (("plain", plain), ("cuda", kern), ("cuda", kern),
                          ("plain", plain)):
            order.append((which, cuda_ms(fn, reps=10, warm=2)))
        times[name] = {w: float(np.mean([m for x, m in order if x == w]))
                       for w in ("cuda", "plain")}
    stage = {k: (1e3 * float(np.median(v)) if v else None, len(v))
             for k, v in sys_.stage_seconds.items()}
    say("times-slam", place_query_ms=pq_ms, place_query_rows=n_rows,
        slate_ms=slate_ms, slate_pairs=len(pairs),
        pgo_ms_median_live=stage["pgo"][0], pgo_runs=stage["pgo"][1],
        pgo_ms_finalize=1e3 * pgo[-1] if pgo else None,
        run_stage_ms_median_and_count=stage,
        hamming_top2_batched_ms=times["hamming_top2_batched"],
        chain_sweep_ms=times["chain_sweep"])
    return times, dict(place_query_ms=pq_ms, slate_ms=slate_ms,
                       pgo_ms_finalize=1e3 * pgo[-1] if pgo else None)


def phase_times(cfg, lefts, rights, world, hamming_inputs):
    thr, arc = cfg.detector.fast_threshold, cfg.detector.fast_arc
    imgs = pyramid(torch.stack([lefts[3], rights[3]]),
                   cfg.detector.num_levels)
    imgs = [im.contiguous() for im in imgs]
    times = {}
    # Plain, kernel, kernel, plain; each kernel's time is the mean of
    # its two runs, summed over the three levels of one frame.
    order = []
    for rnd in range(2):
        for which in (("plain", "cuda") if rnd == 0 else ("cuda", "plain")):
            fn = (fast.fast_score if which == "plain"
                  else cuda_kernels.fast_score_cuda)
            ms = sum(cuda_ms(lambda im=im: fn(im, thr, arc)) for im in imgs)
            order.append((which, ms))
    times["fast_score"] = {
        w: float(np.mean([m for x, m in order if x == w]))
        for w in ("cuda", "plain")}

    da, db, ma, mb, uva, uvb = hamming_inputs
    mm = cfg.matcher
    r = cfg.tracking.gate_radius_px
    gates = [dict(uv_a=uva, uv_b=uvb, dy_tol=mm.epipolar_dy,
                  dx_lo=mm.min_disparity, dx_hi=mm.max_disparity),
             dict(uv_a=uva, uv_b=uvb, dy_tol=r, dx_lo=-r, dx_hi=r)]
    order = []
    for rnd in range(2):
        for which in (("plain", "cuda") if rnd == 0 else ("cuda", "plain")):
            fn = (cuda_kernels.hamming_top2_plain if which == "plain"
                  else cuda_kernels.hamming_top2_cuda)
            ms = sum(cuda_ms(lambda kw=kw: fn(da, db, ma, mb, **kw))
                     for kw in gates)
            order.append((which, ms))
    times["hamming_top2"] = {
        w: float(np.mean([m for x, m in order if x == w]))
        for w in ("cuda", "plain")}

    # VO frames/s of the per-frame loop (warm state, frames 1..F-1).
    state = vo.init_state(lefts[0], rights[0], world.cam, cfg, SEED)
    state, _, _ = vo.vo_block(state, lefts[1:4], rights[1:4], world.cam, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, poses, _ = vo.vo_block(state, lefts[1:], rights[1:], world.cam,
                                  cfg)
    torch.cuda.synchronize()
    fps = (lefts.shape[0] - 1) / (time.perf_counter() - t0)
    say("times", fast_score_ms_per_frame=times["fast_score"],
        hamming_top2_ms_per_frame=times["hamming_top2"],
        vo_frames_per_s=fps)
    check(math.isfinite(fps) and fps > 0, "VO fps not measured")
    return times, fps


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    dev = runtime.device("cuda")
    phase_build()
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

    errs, hamming_inputs = phase_kernels(cfg, lefts, rights, dev)
    errs.update(phase_kernels_backend(dev))
    _, ate, ok_share = phase_slice(cfg, world, lefts, rights, dev)
    scfg = slam_config()
    sys_, sworld, slefts, srights, counts, slam = phase_slam(scfg, dev)
    vo_syncs, slam_syncs = phase_slam_cpu_vs_gpu(scfg, sworld, slefts,
                                                 srights, dev)
    times, fps = phase_times(cfg, lefts, rights, world, hamming_inputs)
    new_times, stages = phase_times_slam(scfg, sys_, sworld)
    times.update(new_times)

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": counts[name],
                "max_abs_err": errs[name], "ms": times[name]["cuda"],
                "plain_ms": times[name]["plain"]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"vo_frames_per_s": fps, "ate_m": ate,
                      "pnp_ok_share": ok_share, **slam, **stages,
                      "syncs_per_step": {"vo_step": vo_syncs,
                                         "slam_step": slam_syncs},
                      "seconds": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
