"""Drive the PyTorch/CUDA port's main paths once on one GPU: the stereo
VO step (also at the 1.2 x 8 ORB pyramid), two-view geometry, the flow
VO, the SLAM system with local BA off, the SLAM system at the default
config (local BA on, checkpoints, asynchronous drain) followed by
resume, global BA with pose priors, the reference backend and the
distributed layer, the `slam-torch` command line on a KITTI-layout
sequence, the port's benchmark (`slam-torch bench`) and its measurement
tools (`tools/port_*.py`).

    python3 chip_smoke.py [--phases kernels,slice,flow,...]

With no argument every phase runs; `--phases` runs the named ones and
what they need (slam-ba and graphs need slam; checkpoint, global-ba,
ref-backend, dist and times-slam need slam-ba; times needs kernels;
traj-ba needs nothing), and
leaves null in the last lines what it did not measure. `--phases pyramid,two-view`
runs without the 600-frame clip; `--phases bench,tools` too.

Run from the repo root on a machine with one CUDA card (sm_90a: H100).
It imports torch, numpy, `slam1_tpu_torch` and the benchmark's BAL
generator only — never jax. Phases,
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
               poses (601 live rows, all rows, 1 and 2 live rows; the
               live count a 0-d int32 tensor on the card, as the PGO
               graphs pass it); both halves of BA's reduced-system
               product (ba_schur) on shuffled observations with unseen
               cameras and landmarks, product and right-side forms (the
               global-ba phase holds them on its own system and times
               them); BA's observation pass (ba_obs: cameras, landmarks
               and cost launches) on a shuffled 24-camera problem with a
               bucket's padding and the final cut, against its plain
               twins on the CPU, repeated to the bit, the cost launch
               equal to the cameras launch's costs to the bit; BA's PCG
               vector update (ba_cg: the start and a step) on a CG state
               at the ba-global-2048 cell's 2048 camera rows (1000
               observed) and at 37 rows, against its plain twins on the
               card, repeated to the bit, one launch each counted.
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
  graphs   — the graphed steps against eager ones on the card: vo_block
               (one replay of a CUDA graph of vo_step per frame) against
               a loop of vo_step on the arc clip from the same generator
               seed (poses, metrics, final state and generator equal to
               the bit), and SlamSystem's replays (the step, and the
               backend's local BA, loop slates, place queries and
               pose-graph relaxations, each a graph over the step
               graph's state; the PGO as pgo_build, pgo_gn once per
               Gauss-Newton iteration and pgo_apply per bucket) against
               graphs=False over the 600-frame clip at slam-ba's config
               (BoW training at frame 30, culls every 32 frames, local
               BA write-backs, the ring's wrap at 256, live PGOs,
               finalize: poses, the whole state, metrics rows, loop
               edges and events, BA and PGO costs equal to the bit);
               equal launch counts; one backend replay per local BA
               window and slate after the first, one pgo_gn call per
               Gauss-Newton iteration; 0 host syncs in a warm replay of
               every graph. Prints ms per warm vo_step, slam_step,
               local BA window, slate, place query (at the final
               keyframe count's bucket) and live relaxation (5
               Gauss-Newton iterations at the final bucket), eager and
               graphed (CUDA events and host clock; the device-busy
               shares from torch.profiler, profiled after all phases),
               capture seconds, graph nodes and pool bytes. The other
               phases' VO and SLAM runs replay graphs too (the card's
               default).
  6. slam-ba — the same clip at `SlamConfig()` with only
               bow.poll_lag_s=0 (so two passes can be compared): local
               BA every 5 keyframes, a checkpoint saved at frame 320.
               Checks: one BA cost per cadence window, all finite; the
               launch counts by the same formulas (BA launches no
               hand-written kernel); loop edges, pnp_ok and ATE as in
               `slam`; a second pass from scratch to frame 320 saves a
               snapshot equal to the first pass's, leaf by leaf (and the
               `checkpoint` phase holds the rest of the clip); a warm
               slam_step and a warm local_ba_step make no host sync.
               Prints frames/s, ms per local_ba_step and the ATEs beside
               the BA-off run's.
  7. checkpoint — `SlamSystem.resume` from the frame-320 snapshot, frames
               321-599, finalize: final poses within 1e-3 m of the
               straight run's, ATEs before and after finalize within
               1e-6 m of its.
  8. global-ba — `global_ba_step` on the finished state with the
               keyframe count's bucket, the observation bucket the CLI
               picks, the run's loop edges as priors and the trace: two
               eager calls (`graphs=False`) compared to each other, the
               graphed call that captures `ba_build`, `ba_lm` and
               `ba_apply`, and a second one made only of replays (one,
               lm_iters, one), equal to the first eager call to the bit
               and making no host sync; the graduated cut made on the
               card equal to the host's. Final cost finite and <= the
               first trace entry, at least one accepted step, ATE after
               <= 1.05 x before. Prints the trace, ms per LM iteration
               eager and graphed (CUDA events and host clock), each
               graph's capture s, nodes and pool bytes, and ms per CG
               matvec with its byte bound. The replays launch the
               reduced-system halves (ba_schur) 2 (cg_iters + 1) + 3
               times an LM iteration (counters reset before); both
               halves against their plain twins on the phase's own
               system at its initial point (product and right-side
               forms, pose priors present), and one product of both
               halves and each half timed against their twins and
               bounds (`ba_matvec_work`; each half's own bytes; the
               `kernels` line's ba_schur row and its `halves`), at the
               phase's sizes and at the ba-global-2048 cell's (512 000
               observations, 1000 of 2048 camera rows observed, 79 000
               landmarks seen by ~6.5 neighbouring cameras). The
               replays launch the observation pass (ba_obs) 3 times an
               LM iteration and once for ba_apply's final cost; its
               three launches against their plain twins on the CPU and
               timed, together and one by one, against their twins on
               the card and their bounds (`ba_obs_work`; the `kernels`
               line's ba_obs row and its `by_launch`) on the phase's
               problem and on a synthetic drive at the cell's sizes;
               the observations a landmark has (mean, p99, max: the
               landmarks launch's tail). The replays launch the PCG
               vector update (ba_cg) cg_iters + 1 times an LM iteration
               (its start and one a CG iteration), none in ba_build or
               ba_apply; one step against its twins on the phase's own
               CG state (after one product), and one step timed against
               its twin and its bound (`ba_cg_work`: p, Ap, x, r and
               Minv read, x, r and p written; the `kernels` line's ba_cg
               row) on the phase's system and at the cell's 2048 rows.
  traj-ba  — `slam-torch ba <traj.npy>` in process on float64 files of
               a noisy two-lap trajectory at 4661 poses (KITTI 02's
               length) and 12000 (past the 8533 rows whose chain offsets
               fit in shared memory: the sweep keeps them in device
               memory); posegraph.optimize on the command's graph eager
               (graphs=False) against replays of pg_gn (10 times) and
               pg_cost, equal to the bit and to the command's output,
               no host sync in a warm call, cost not raised. Prints ms
               per Gauss-Newton iteration eager and graphed (host clock,
               turns eager, graph, graph, eager), pg_gn's capture s,
               nodes and pool bytes.
  bal      — BAL's camera model on the CG path at Venice's sizes (1778
               cameras, 993 923 points, 5 001 946 observations; the
               problem of `benchmark/yardstick/bal_synth.py` from seed
               BAL_SEED, made on the card), as `ba.BAL` runs them (no
               outlier cut): csrc/bal_obs.cu's three launches, both
               halves of csrc/ba_schur.cu at D = 9 (product and right
               side) and csrc/ba_cg.cu's start and step at D = 9, each
               against its plain twin on the card within BAL_OBS_TOL,
               BAL_SCHUR_TOL and BAL_CG_TOL of the twin's largest value
               (the costs within BAL_OBS_TOL, the kept rows equal, a
               second launch and the cost launch the cameras launch's
               bits); each timed (graph, eager, twin) with its
               bound (`utils/bounds.bal_*_work`); then one
               `ba.bundle_adjust` pass with the model `ba.BAL` captures
               `bal_lm` and `bal_cost`, and with the counters zeroed
               just before, one warm `bal_lm` replay launches bal_obs 3,
               ba_schur 2 (cg_iters + 1) + 3 = 133 and ba_cg cg_iters +
               1 = 65 times, one `bal_cost` replay bal_obs once and
               nothing else, neither with a host sync.
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
               1.05 x before; the single-device baseline timed as
               replays of its CUDA graphs, equal to the bit to and
               beside its eager run); optimize_sharded on the run's pose graph
               (2048 rows, 601 live, its loop edges, the live
               relaxation's 5 GN x 64 CG)
               against posegraph.optimize (cost, ATE <= odometry-only),
               chain_prepare / chain_sweep launches per rank. At one
               rank both solvers run eagerly twice, then graphed twice
               (`dba_lm` / `dpg_gn` replayed once per LM / GN iteration,
               `dba_cost` / `dpg_cost` once, NCCL collectives inside):
               graphed equal to eager to the bit (or within the eager
               calls' spread where they differ), 0 host syncs in a warm
               graphed call, the same `Mesh.comm` counts and launches;
               the graphed results are the ones checked. Then both at
               two ranks spawned on the one card over gloo (eager, as
               gloo must; joined under a time limit) against one rank.
               Prints ms per LM / GN iteration eager and graphed, the
               graphs' nodes, capture s and pool bytes, and the
               measured all_reduce bytes per CG step.
  9. async   — the first 100 frames at `SlamConfig()` unchanged (the
               bench phase runs all 600 at this config)
               (poll_lag_s=0.05): no metrics row lost, poses finite,
               pnp_ok >= 0.8, the fetch worker gone with the system.
  flow     — the flow VO (`models/vo_flow.py`: FAST corners through the
               kernel's one-level entry, pyramidal LK, dense SGM
               disparity, RANSAC-PnP) over the arc clip on CUDA tensors
               through `run_sequence`, which replays one CUDA graph of
               the step per frame, the launch counters reset just
               before: fast_score once per frame, no other kernel;
               pnp_ok >= 0.6, poses finite, ATE printed beside the VO
               slice's; the graphed run equal to the bit to a loop of
               eager vo_step calls from the same seed (poses, metrics,
               the final state, launch counts; one replay per frame
               after the first); the first 6 frames on CPU and CUDA
               with the same draws (num_tracked and num_stereo within
               2%, poses within 1e-2 m); then ms per warm vo_step eager
               and graphed (CUDA events, host clock; 0 host syncs per
               warm replay), the graph's nodes, capture s and pool
               bytes, flow frames/s graphed and eager (per-frame loops)
               and of the whole run_sequence call (capture included),
               ms per disparity and per lk_track call (CUDA events), and
               device-busy shares and launches (torch.profiler).
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
               them: `slam-torch run` at SlamConfig() with checkpoints
               and metrics, alone (120 frames, ATE < 1 m, fast_score F
               and hamming_top2 2F-1 launches, frames/s); then, started
               together, `run --vo-only` (equal to vo.run_sequence in
               process), `eval` (the same ATE), `ba --state` on its
               checkpoint, `ba --state --distributed --lm-shards 1`
               (finite cost, nothing dropped), `ba` on its trajectory
               and on a float64 copy of it (finite costs, float32
               output within 1e-4 of each other), and `run --synthetic
               8` plainly and with
               `--multihost --coordinator 127.0.0.1:<free port>
               --num-processes 1 --process-id 0` (its rank line, the
               plain run's poses).
  bench    — `slam-torch bench` in a subprocess, as a user runs it (VO
               on the arc clip, then SLAM at `SlamConfig()` unchanged on
               the full 600-frame loop2 clip, a warm and a timed pass):
               its last line has exactly the root bench.py's keys,
               positive SLAM and VO frames/s, data synthetic-loop2-600,
               ATE < 1.1 m and >= 2 loop closures (the JAX package's
               asynchronous spread is 0.53-1.01 m), fast_score 1339 and
               hamming_top2 2675 launches (1 + 138 VO frames + 2 x 600
               SLAM frames, two per frame for Hamming).
  tools    — each `tools/port_*.py` in its own process at a small depth:
               port_global_ba_scale over 200 frames with its checkpoint
               (~100 keyframes, bucket 128); then, started together,
               port_dist_ba_scale on it at 1 rank (NCCL) and 2 ranks
               sharing the card (gloo), port_loop_grid at one hit and
               port_multihost_smoke (two processes); then port_roofline
               and port_profile_stage (5 calls a stage) alone. Each exits 0 with its own
               checks held; the records' keys and backends are checked.
 11. times   — per kernel: its device time (a CUDA graph of 20 calls
               replayed), its eager time (CUDA events around 20 wrapper
               calls), its plain twin's time, in turns plain, kernel,
               kernel, plain; its bound from the function's inputs and
               outputs alone, whatever the kernel's design (the larger
               of bytes / 3.35 TB/s and operations / the H100's
               published peak for their type) and the share of the bound
               reached; chain_sweep also at 12000 poses, its offsets in
               device memory (against its twin; device time of the
               shared-memory path at 8533 poses beside it); ba_schur's
               times are phase global-ba's (one product of both halves),
               and so are ba_obs's (one LM iteration's three launches)
               and ba_cg's (one step of the PCG vector update);
               the VO frames/s of the per-frame loop, the SLAM frames/s
               of the process loop, and ms per place_query, per slate
               and per PGO (the last three: phase times-slam; the PGO's
               are the slam-ba pass's graphed live and final
               relaxations).

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
import contextlib
import dataclasses
import gc
import glob
import io
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

from slam1_tpu_torch import cli, parallel, runtime  # noqa: E402
from slam1_tpu_torch.config import SlamConfig  # noqa: E402
from slam1_tpu_torch.models import ba, pipeline, posegraph, ref_backend, \
    vo, vo_flow  # noqa: E402
from slam1_tpu_torch.models.loop_closure import place_query, \
    verify_loop_slate  # noqa: E402
from slam1_tpu_torch.ops import ba_obs, cuda_kernels, detector, epipolar, \
    fast, hamming, lk, se3, triangulate  # noqa: E402
from slam1_tpu_torch.ops.camera import StereoCamera  # noqa: E402
from slam1_tpu_torch.ops.detector import _downsample2  # noqa: E402
from slam1_tpu_torch.ops.lsq import huber_weights, inv3x3  # noqa: E402
from slam1_tpu_torch.ops.pnp import draw_uniform  # noqa: E402
from slam1_tpu_torch.ops.segment import seg_sum  # noqa: E402
from slam1_tpu_torch.utils import kitti, metrics, native_loader, \
    synthetic  # noqa: E402
from slam1_tpu_torch.utils.bounds import PEAK_F32_FLOPS, ba_obs_work, \
    bound, bound_ba_cg, bound_ba_matvec, bound_chain_prepare, \
    bound_chain_sweep, bound_fast_score, bound_hamming  # noqa: E402
from slam1_tpu_torch.utils.evalmetrics import ate_rmse  # noqa: E402
from slam1_tpu_torch.utils.timing import device_busy_ms, device_launches, \
    event_ms, graph_ms  # noqa: E402
from slam1_tpu_torch.utils import graphs as graph_mod  # noqa: E402
from slam1_tpu_torch.utils.graphs import GRAPHS  # noqa: E402
from slam1_tpu_torch.utils.tree import flatten  # noqa: E402

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
# BA's reduced-system halves: max |kernel - twin| over the terms'
# magnitude (tests/test_torch_kernels_cuda.py's SCHUR_TOL, with its
# reason); observations, camera rows (half of them observed), landmarks.
SCHUR_TOL = 1e-5
SCHUR_SHAPE = (4099, 300, 977)
# The ba-global-2048 cell's sizes: observations, camera rows, cameras
# observed, landmarks (each camera's observations drawn from a window of
# landmarks that moves on by L / observed cameras a camera, so that a
# landmark is seen by ~6.5 neighbouring cameras, as along a drive).
SCHUR_CELL = (512000, 2048, 1000, 79000)
# BA's observation pass (csrc/ba_obs.cu) against its plain twins on the
# CPU: max |kernel - twin| over the twin's largest |value|, block by block
# (each observation's terms are the twin's bits; the float64 sums by
# camera are associated otherwise and rounded once), and the costs'
# relative error (the twins sum them in float32).
OBS_TOL = 1e-6
OBS_COST_TOL = 1e-5
# BA's PCG vector update (csrc/ba_cg.cu) against its plain twins on the
# card: max |kernel - twin| over the terms' magnitude (float64 on
# absolute values); tests/torch_ba_cg_visit.py's CG_TOL, with its reason.
CG_TOL = 1e-5
# The ba-global-2048 cell's camera rows and the rows observed.
CG_CELL = (2048, 1000)
# Phase bal: the seed of its Venice-sized problem, and each launch
# against its plain twin on the card, max |kernel - twin| over the twin's
# largest |value|, at 4x the largest gap measured there (H100, two runs:
# the observation pass 1.0e-4, on W; the halves 5.0e-6; the PCG update
# 3.2e-5). The pass's gap exceeds the card tests' BAL_TOL (1e-5, on 12
# cameras): W's gap is the largest over 5 M rows (not ~1 200) of a
# per-row difference that the card's sines and cosines make.
BAL_SEED = 2147926301
BAL_OBS_TOL = 4e-4
BAL_SCHUR_TOL = 2e-5
BAL_CG_TOL = 1.3e-4
SAME_ATE_TOL = 1e-6          # m, between two runs of the same clip
CKPT_FRAME = 320             # a block boundary of the slam-ba pass
RESUME_TOL = 1e-3            # m, resumed run against the straight run
ASYNC_FRAMES = 100           # the bench runs 600 at the same config
BA_TOL = 1e-4                # m, bundle_adjust on CPU against CUDA
FLOW_PNP_OK = 0.6            # the flow VO's pnp_ok share on the arc clip
FLOW_REPS = 5                # warm flow steps per timing (an eager one ~0.3 s)
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
# The root bench.py's JSON keys, which `slam-torch bench` prints; its
# ATE and loop bounds follow the JAX package's own spread under the
# asynchronous drain, 0.53-1.01 m (PROFILE_r05.md:50).
BENCH_KEYS = ("metric", "value", "unit", "data", "vs_baseline",
              "ate_rmse_m", "ref_ate_rmse_m", "loop_closures",
              "ref_loop_closures", "vo_frames_per_s_per_chip",
              "vo_vs_baseline")
BENCH_ATE_M = 1.1
BENCH_LOOPS = 2
TOOLS_FRAMES = 200           # port_global_ba_scale's clip in phase tools
# `ba <traj.npy>`: KITTI 02's length, and past the 8533 poses whose chain
# offsets fit in shared memory
TRAJ_POSES = (4661, 12000)
TRAJ_ITERS = 10              # the command's Gauss-Newton iterations
TRAJ_CG_ITERS = 50           # and CG iterations in each
REPO = os.path.dirname(os.path.abspath(__file__))
# Phases a run may select (--phases), in the order a full run takes
# them, and what each needs run before it.
PHASES = ("kernels", "slice", "pyramid", "two-view", "flow", "slam",
          "graphs", "slam-ba", "checkpoint", "global-ba", "traj-ba", "bal",
          "ref-backend",
          "dist", "async", "cpu-vs-gpu", "cli", "bench", "tools", "times",
          "times-slam")
NEEDS = {"slam-ba": ("slam",), "graphs": ("slam",),
         "checkpoint": ("slam-ba",), "global-ba": ("slam-ba",), "ref-backend": ("slam-ba",),
         "dist": ("slam-ba",), "times": ("kernels",),
         "times-slam": ("slam-ba",)}
# name: (source, what it replaces, what one "ms" covers)
KERNELS = {
    "fast_score": ("slam1_tpu_torch/csrc/fast_score.cu",
                   "slam1_tpu/ops/pallas_kernels.py:231",
                   "one frame: 1 launch, 2 images x 3 pyramid levels"),
    "hamming_top2": ("slam1_tpu_torch/csrc/hamming_top2.cu",
                     "slam1_tpu/ops/pallas_kernels.py:102",
                     "one frame: 2 gated launches of 2688 x 2688"),
    "hamming_top2_batched": ("slam1_tpu_torch/csrc/hamming_top2.cu",
                             "slam1_tpu/ops/pallas_kernels.py:102",
                             "one slate: 1 launch of 8 x 1024 x 1024"),
    # not TPU kernels: the XLA scans of the reference's chain solve
    "chain_prepare": ("slam1_tpu_torch/csrc/chain_sweep.cu",
                      "slam1_tpu/models/posegraph.py:74",
                      "one launch, 2048 poses, 601 live"),
    "chain_sweep": ("slam1_tpu_torch/csrc/chain_sweep.cu",
                    "slam1_tpu/models/posegraph.py:74",
                    "one launch, 2048 poses, 601 live"),
    # not a TPU kernel: the reference's einsums of the CG product
    "ba_schur": ("slam1_tpu_torch/csrc/ba_schur.cu",
                 "slam1_tpu/models/ba.py:256",
                 "one CG product, both halves, on phase global-ba's "
                 "reduced system"),
    # not a TPU kernel: the reference's cost, Jacobians and normal blocks
    "ba_obs": ("slam1_tpu_torch/csrc/ba_obs.cu",
               "slam1_tpu/models/ba.py:140",
               "one LM iteration's observation pass (cameras, landmarks, "
               "the cost after the step) on phase global-ba's problem"),
    # not a TPU kernel: the reference's CG iteration body (a scan body)
    "ba_cg": ("slam1_tpu_torch/csrc/ba_cg.cu",
              "slam1_tpu/ops/cg.py:36",
              "one PCG step's vector update on phase global-ba's reduced "
              "system"),
    # not a TPU kernel: the reference's jacfwd and einsums of BAL's pass
    "bal_obs": ("slam1_tpu_torch/csrc/bal_obs.cu",
                "slam1_tpu/models/bal.py:93",
                "one LM iteration's BAL observation pass (cameras, "
                "landmarks, the cost after the step) at Venice's sizes"),
}
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
    keep_worst(errs, rel_errs, check_ba_schur(dev))
    keep_worst(errs, rel_errs, check_ba_obs(dev))
    keep_worst(errs, rel_errs, check_ba_cg(dev))
    return errs, rel_errs


def cg_state(c, live, dev, seed=13):
    """A CG state over C camera rows of which the first `live` are
    observed, as global BA's reduced system has them (seeded): blocks H
    = A A^T + I (1e-6 I, the damping alone, on unobserved rows), Minv =
    H^-1, r random (0 on unobserved rows), x random, p = Minv r, Ap = H p
    -> (p, ap, x, r, minv, rz = r.p), float32 on `dev`."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((c, 6, 6), generator=g, dtype=torch.float64)
    h = a @ a.transpose(1, 2) + torch.eye(6, dtype=torch.float64)
    h[live:] = 1e-6 * torch.eye(6, dtype=torch.float64)
    r = torch.randn((c, 6), generator=g, dtype=torch.float64)
    r[live:] = 0.0
    minv = torch.linalg.inv(h)
    p = torch.einsum("cij,cj->ci", minv, r)
    x = torch.randn((c, 6), generator=g, dtype=torch.float64)
    return tuple(t.float().contiguous().to(dev) for t in (
        p, torch.einsum("cij,cj->ci", h, p), x, r, minv, torch.sum(r * p)))


def cg_errors(case, state):
    """BA's PCG vector update (csrc/ba_cg.cu), the start and one step,
    against its plain twins on the card, each launch repeated to the bit
    and counted once -> (max abs error, the same over the terms'
    magnitude); the latter is what CG_TOL bounds."""
    p, ap, x, r, minv, rz = state
    cuda_kernels.reset_launch_counts()
    start = cuda_kernels.ba_cg_start_cuda(r, minv)
    step = cuda_kernels.ba_cg_step_cuda(p, ap, x, r, minv, rz)
    counted = cuda_kernels.launch_counts()["ba_cg"]
    again = (cuda_kernels.ba_cg_start_cuda(r, minv),
             cuda_kernels.ba_cg_step_cuda(p, ap, x, r, minv, rz))
    same = not tree_diff((start, step), again, "ba_cg")
    twin_start = cuda_kernels.ba_cg_start_plain(r, minv)
    twin = cuda_kernels.ba_cg_step_plain(p, ap, x, r, minv, rz)
    am = minv.double().abs()
    alpha = abs(float(rz / torch.sum(p * ap)))
    beta = abs(float(twin[3] / rz))
    m_r = r.double().abs() + alpha * ap.double().abs()
    m_z = torch.einsum("cij,cj->ci", am, m_r)
    m_z0 = torch.einsum("cij,cj->ci", am, r.double().abs())
    mags = {"start p": m_z0, "start rz": torch.sum(r.double().abs() * m_z0),
            "x": x.double().abs() + alpha * p.double().abs(), "r": m_r,
            "p": m_z + beta * p.double().abs(), "rz": torch.sum(m_r * m_z)}
    worst = (0.0, 0.0)
    for name, k, t in zip(mags, (*start, *step), (*twin_start, *twin)):
        diff = (k.double() - t.double()).abs()
        err = float(diff.max())
        rel = float((diff / (mags[name] + 1e-30)).max())
        say("kernels", kernel="ba_cg", case=case, output=name,
            shape=tuple(r.shape), max_abs_err=err, rel_err=rel)
        check(bool(torch.isfinite(k).all()) and rel <= CG_TOL,
              f"ba_cg {name} ({case}): error {rel} of the terms")
        worst = (max(worst[0], err), max(worst[1], rel))
    check(same, f"ba_cg ({case}): a second launch gave other bits")
    check(counted == 2, f"ba_cg ({case}): {counted} launches counted, not 2")
    return worst


def check_ba_cg(dev):
    """BA's PCG vector update at the ba-global-2048 cell's camera rows
    (CG_CELL) and at 37 rows: {"ba_cg": worst cg_errors}."""
    worst = (0.0, 0.0)
    for case, (c, live) in (("cell", CG_CELL), ("37 rows", (37, 37))):
        err = cg_errors(case, cg_state(c, live, dev))
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
    return {"ba_cg": worst}


def time_ba_cg(state, sizes):
    """time_kernel of one step of the PCG vector update against its twin,
    bound by `ba_cg_work`."""
    return time_kernel(
        "ba_cg", lambda: cuda_kernels.ba_cg_step_plain(*state),
        lambda: cuda_kernels.ba_cg_step_cuda(*state),
        *bound_ba_cg(state[0].shape[0]),
        per=f"one PCG step's vector update: {sizes}")


def check_ba_obs(dev):
    """BA's observation pass on a shuffled 24-camera CG-path problem with
    a bucket's padding (weight zero, on camera 0 and landmark 0) and the
    graduated cut: {"ba_obs": ba_obs_errors(...)}."""
    p, _, _, cam = synthetic.ba_problem(5, n_cams=24, n_pts=400,
                                        n_outliers=30, device="cpu")
    g = torch.Generator().manual_seed(5)
    perm = torch.randperm(p.uv.shape[0], generator=g)
    pad = 500
    zero = torch.zeros(pad, dtype=torch.int64)
    p = p._replace(
        cam_idx=torch.cat([p.cam_idx[perm].long(), zero]),
        lm_idx=torch.cat([p.lm_idx[perm].long(), zero]),
        uv=torch.cat([p.uv[perm], torch.zeros(pad, 2)]),
        ur=torch.cat([p.ur[perm], torch.zeros(pad)]),
        wr=torch.cat([p.wr[perm], torch.ones(pad)]),
        w=torch.cat([p.w[perm], torch.zeros(pad)]))
    prob = ba.BAProblem(*[x.to(dev) for x in p])
    return {"ba_obs": ba_obs_errors("shuffled-padded", prob, cam.to(dev),
                                    *obs_cut(SlamConfig().ba, 2, dev))}


def obs_cut(bcfg, t, dev):
    """(cut2, cap) of LM iteration t, on `dev`, as `ba.lm_step` makes
    them."""
    cut = ba.graduated_cut(bcfg.outlier_px, torch.tensor(t, device=dev),
                           torch.float32)
    cut2 = cut * cut
    return cut2, huber_weights(cut2, bcfg.huber_delta) * cut2


def ba_obs_errors(case, prob, cam, cut2, cap, delta=2.0):
    """The observation pass's three launches (csrc/ba_obs.cu) against
    their plain twins on the CPU (the problem copied there) -> (max abs
    error, the same over the twin's largest |value|), the worst block;
    every block within OBS_TOL of its largest |value|, the costs within
    OBS_COST_TOL, the kept rows equal, a second launch equal to the first
    and the cost launch equal to the cameras launch, to the bit."""
    order = cuda_kernels.schur_order(prob.cam_idx, prob.lm_idx,
                                     prob.poses.shape[0],
                                     prob.points.shape[0], kernels=True,
                                     w=prob.w)

    def launch():
        obs = cuda_kernels.ba_obs_cameras_cuda(prob, cam, order, cut2, cap,
                                               delta)
        return obs, cuda_kernels.ba_obs_landmarks_cuda(prob, cam, order,
                                                       cut2, delta)
    (obs, (hll, bl)), again = launch(), launch()
    cost = cuda_kernels.ba_obs_cost_cuda(prob, cam, order, cap, delta)
    torch.cuda.synchronize()
    same = all(torch.equal(bits(a), bits(b)) for a, b in
               zip(flatten((obs, hll, bl)), flatten(again)))
    cost_same = bool(torch.equal(bits(cost[0]), bits(obs.full))
                     and torch.equal(bits(cost[1]), bits(obs.trunc)))
    cpu = ba.BAProblem(*[x.cpu() for x in prob])
    ccam = cam.to("cpu")
    c2, cp = [None if x is None else x.cpu() for x in (cut2, cap)]
    plain = cuda_kernels.SchurOrder(cpu.cam_idx.long(), cpu.lm_idx.long())
    twin = ba_obs.cameras_plain(cpu, ccam, plain, c2, cp, delta)
    twin_l = ba_obs.landmarks_plain(cpu, ccam, plain, c2, delta)
    worst = (0.0, 0.0)
    for name, k, t in zip(("W", "Hcc", "bc", "Hll", "bl"),
                          (obs.W, obs.hcc, obs.bc, hll, bl),
                          (twin.W, twin.hcc, twin.bc, *twin_l)):
        diff = (k.cpu().double() - t.double()).abs()
        err = diff.max().item()
        rel = err / max(t.abs().max().item(), 1e-30)
        say("kernels", kernel="ba_obs", case=case, block=name,
            shape=tuple(t.shape), max_abs_err=err, rel_err=rel,
            differing=int((diff > 0).sum()))
        check(bool(torch.isfinite(k).all()) and rel <= OBS_TOL,
              f"ba_obs {name} ({case}): error {rel} of its largest value")
        worst = (max(worst[0], err), max(worst[1], rel))
    cost_rel = [abs(float(k) - float(t)) / max(abs(float(t)), 1e-30)
                for k, t in ((obs.full, twin.full), (obs.trunc, twin.trunc))]
    say("kernels", kernel="ba_obs", case=case, costs=[float(obs.full),
        float(obs.trunc)], cost_rel_err=cost_rel, kept=int(obs.n_kept),
        twin_kept=int(twin.n_kept), repeat_same_bits=same,
        cost_launch_same_bits=cost_same)
    check(max(cost_rel) <= OBS_COST_TOL and int(obs.n_kept) ==
          int(twin.n_kept), f"ba_obs costs ({case}): {cost_rel}, kept "
          f"{int(obs.n_kept)} against {int(twin.n_kept)}")
    check(same and cost_same, f"ba_obs ({case}): a second launch or the "
          f"cost launch gave other bits ({same}, {cost_same})")
    return worst


def time_ba_obs(prob, cam, cut2, cap, sizes, delta=2.0):
    """time_kernel of one LM iteration's observation pass (the cameras,
    landmarks and cost launches) against the plain twins on the card,
    bound by the sum of `ba_obs_work`'s three launches, with each
    launch's own times under "by_launch", each bound by its own work."""
    o, c, n_l = (prob.uv.shape[0], prob.poses.shape[0],
                 prob.points.shape[0])
    order = cuda_kernels.schur_order(prob.cam_idx, prob.lm_idx, c, n_l,
                                     kernels=True, w=prob.w)
    plain = cuda_kernels.SchurOrder(order.cam_idx, order.lm_idx)
    calls = {
        "cameras": (
            lambda: ba_obs.cameras_plain(prob, cam, plain, cut2, cap, delta),
            lambda: cuda_kernels.ba_obs_cameras_cuda(prob, cam, order, cut2,
                                                     cap, delta)),
        "landmarks": (
            lambda: ba_obs.landmarks_plain(prob, cam, plain, cut2, delta),
            lambda: cuda_kernels.ba_obs_landmarks_cuda(prob, cam, order,
                                                       cut2, delta)),
        "cost": (
            lambda: ba_obs.cost_plain(prob, cam, plain, cap, delta),
            lambda: cuda_kernels.ba_obs_cost_cuda(prob, cam, order, cap,
                                                  delta))}
    works = {k: ba_obs_work(o, c, n_l, k) for k in calls}
    total = [sum(w[i] for w in works.values()) for i in (0, 1)]
    out = time_kernel(
        "ba_obs", lambda: [pl() for pl, _ in calls.values()],
        lambda: [kern() for _, kern in calls.values()],
        *bound(*total, PEAK_F32_FLOPS),
        per=f"one LM iteration's observation pass, three launches: {sizes}")
    out["by_launch"] = {
        k: time_kernel("ba_obs", pl, kern,
                       *bound(*works[k], PEAK_F32_FLOPS),
                       per=f"the {k} launch: {sizes}")
        for k, (pl, kern) in calls.items()}
    return out


def obs_cell_inputs(dev):
    """A BA problem at SCHUR_CELL's sizes (seeded), as the benchmark's
    drive makes it: the observed cameras 2 m apart along a straight
    drive (rows ascending, the other rows identity poses nothing
    observes), landmarks 12-55 m ahead of an anchor camera, each camera's
    observations drawn from the landmarks anchored at it and the 3
    cameras before it (so ~6.5 cameras see a landmark), 0.5 px of noise
    and 2% outliers thrown 30-80 px; the problem and the camera on the
    card."""
    o, c, live, n_l = SCHUR_CELL
    g = torch.Generator().manual_seed(7)
    cam = StereoCamera.kitti_default(device="cpu")
    poses = torch.eye(4).repeat(c, 1, 1)
    poses[:live, 2, 3] = 2.0 * torch.arange(live, dtype=torch.float32)
    anchor = torch.sort(torch.randint(0, live, (n_l,), generator=g)).values
    points = torch.stack([
        torch.rand(n_l, generator=g) * 30 - 15,
        torch.rand(n_l, generator=g) * 7 - 4,
        poses[anchor, 2, 3] + 12 + torch.rand(n_l, generator=g) * 43], -1)
    ci = torch.sort(torch.randint(0, live, (o,), generator=g)).values
    off = torch.searchsorted(anchor, torch.arange(live + 1))
    lo, hi = off[torch.clamp(ci - 3, min=0)], off[ci + 1]
    li = lo + (torch.rand(o, generator=g) * (hi - lo)).long()
    Xc = points[li] - poses[ci, :3, 3]
    z = Xc[:, 2]
    uv = torch.stack([cam.fx * Xc[:, 0] / z + cam.cx,
                      cam.fy * Xc[:, 1] / z + cam.cy], -1)
    ur = cam.fx * (Xc[:, 0] - cam.baseline) / z + cam.cx
    uv = uv + torch.randn(o, 2, generator=g) * 0.5
    ur = ur + torch.randn(o, generator=g) * 0.5
    out = torch.rand(o, generator=g) < 0.02
    throw = 30 + torch.rand(o, generator=g) * 50
    uv = uv + out[:, None] * throw[:, None]
    ur = ur + out * throw
    prob = ba.make_problem(poses, points, ci, li, uv, torch.ones(o), ur=ur,
                           wr=torch.ones(o))
    return ba.BAProblem(*[x.to(dev) for x in prob]), cam.to(dev)


def check_ba_schur(dev):
    """Both halves of BA's reduced-system product on shuffled
    observations over cameras and landmarks some of which nothing
    observes: {"ba_schur": schur_errors(...)}."""
    o, c, n_l = SCHUR_SHAPE
    g = torch.Generator().manual_seed(5)
    ci = torch.randperm(c, generator=g)[:c // 2][
        torch.randint(0, c // 2, (o,), generator=g)].to(dev)
    li = torch.randint(0, n_l, (o,), generator=g).to(dev)
    W, hinv, hcc, x, a, b = [torch.randn(s, generator=g).to(dev) for s in (
        (o, 6, 3), (n_l, 3, 3), (c, 6, 6), (c, 6), (n_l, 3), (c, 6))]
    order = cuda_kernels.schur_order(ci, li, c, n_l, kernels=True)
    return {"ba_schur": schur_errors("shuffled", W, hinv, hcc, order, x, a,
                                     b)}


def schur_errors(case, W, hinv, hcc, order, x, a, b):
    """Both halves of BA's reduced-system product (csrc/ba_schur.cu) on
    the kernels' ordering `order` against their plain twins, in the
    product's form (x) and the right side's (a, then b) -> (max abs
    error, the same over the terms' magnitude); the latter is what
    SCHUR_TOL bounds."""
    ci, li = order.cam_idx, order.lm_idx
    o, c, n_l = W.shape[0], hcc.shape[0], hinv.shape[0]
    plain = cuda_kernels.SchurOrder(ci, li)
    absW = W.double().abs()
    worst = (0.0, 0.0)
    for form, lm_kw, cam_kw in (("product", dict(x=x), dict(hcc=hcc, x=x)),
                                ("right side", dict(a=a), dict(b=b))):
        v = cuda_kernels.ba_schur_landmarks_plain(W, hinv, plain, **lm_kw)
        outs = [cuda_kernels.ba_schur_landmarks_cuda(W, hinv, order, **lm_kw),
                cuda_kernels.ba_schur_cameras_cuda(W, v, order, **cam_kw)]
        twins = [v, cuda_kernels.ba_schur_cameras_plain(W, v, plain,
                                                        **cam_kw)]
        if "x" in lm_kw:
            m_t = seg_sum(n_l, li, torch.einsum(
                "oij,oi->oj", absW, x.double().abs()[ci]))
            m_h = torch.einsum("cij,cj->ci", hcc.double().abs(),
                               x.double().abs())
        else:
            m_t, m_h = a.double().abs(), b.double().abs()
        m_v = torch.einsum("lij,lj->li", hinv.double().abs(), m_t)
        mags = [m_v, m_h + seg_sum(c, ci, torch.einsum(
            "oij,oj->oi", absW, m_v[li]))]
        torch.cuda.synchronize()
        for half, k, p, m in zip(("landmarks", "cameras"), outs, twins, mags):
            diff = (k.double() - p.double()).abs()
            err = diff.max().item()
            rel = (diff / m.clamp_min(1e-30)).max().item()
            say("kernels", kernel="ba_schur", case=case, half=half,
                form=form, shape=(o, c, n_l), max_abs_err=err, rel_err=rel)
            check(bool(torch.isfinite(k).all()) and rel <= SCHUR_TOL,
                  f"ba_schur {half} ({form}, {case}): error {rel} of the "
                  f"terms")
            worst = (max(worst[0], err), max(worst[1], rel))
    return worst


def time_ba_schur(W, hinv, hcc, order, x, sizes):
    """time_kernel of one product (the landmark half, then the camera
    half) against its plain twins, bound by `ba_matvec_work` without
    priors, with each half's own times under "halves", each bound by the
    bytes it moves (`schur_half_bytes`)."""
    o, c, n_l = W.shape[0], hcc.shape[0], hinv.shape[0]
    plain = cuda_kernels.SchurOrder(order.cam_idx, order.lm_idx)
    v = cuda_kernels.ba_schur_landmarks_plain(W, hinv, plain, x=x)

    def product(landmarks, cameras, ordering):
        return lambda: cameras(W, landmarks(W, hinv, ordering, x=x),
                               ordering, hcc=hcc, x=x)
    out = time_kernel(
        "ba_schur",
        product(cuda_kernels.ba_schur_landmarks_plain,
                cuda_kernels.ba_schur_cameras_plain, plain),
        product(cuda_kernels.ba_schur_landmarks_cuda,
                cuda_kernels.ba_schur_cameras_cuda, order),
        *bound_ba_matvec(o, c, n_l, 0),
        per=f"one CG product, both halves: {sizes}")
    lm_bytes, cam_bytes = schur_half_bytes(o, c, n_l)
    out["halves"] = {
        "landmarks": time_kernel(
            "ba_schur",
            lambda: cuda_kernels.ba_schur_landmarks_plain(W, hinv, plain,
                                                          x=x),
            lambda: cuda_kernels.ba_schur_landmarks_cuda(W, hinv, order,
                                                         x=x),
            *bound(lm_bytes, 0, PEAK_F32_FLOPS),
            per=f"the landmark half of one CG product: {sizes}"),
        "cameras": time_kernel(
            "ba_schur",
            lambda: cuda_kernels.ba_schur_cameras_plain(W, v, plain, hcc=hcc,
                                                        x=x),
            lambda: cuda_kernels.ba_schur_cameras_cuda(W, v, order, hcc=hcc,
                                                       x=x),
            *bound(cam_bytes, 0, PEAK_F32_FLOPS),
            per=f"the camera half of one CG product: {sizes}")}
    return out


def schur_half_bytes(o: int, c: int, n_l: int):
    """(landmark half, camera half) bytes of one call each: W and its
    ordering's two int32 vectors read once, the offsets, Hll_inv (L,3,3)
    and x read and v written (landmark half); v, Hcc_d (C,6,6) and x read
    and the result written (camera half). Rows the orderings leave out
    are counted too."""
    lm = o * (72 + 8) + (n_l + 1) * 4 + n_l * (36 + 12) + c * 24
    cam = o * (72 + 8) + (c + 1) * 4 + n_l * 12 + c * (144 + 24 + 24)
    return lm, cam


def schur_cell_inputs(dev):
    """Operands of the reduced-system product at SCHUR_CELL's sizes
    (seeded): W, Hll_inv, Hcc_d, the kernels' ordering and x."""
    o, c, live, n_l = SCHUR_CELL
    g = torch.Generator().manual_seed(7)
    rank = torch.sort(torch.randint(0, live, (o,), generator=g)).values
    cams = torch.sort(torch.randperm(c, generator=g)[:live]).values
    step = n_l // live
    li = (rank * step + torch.randint(0, int(6.5 * step), (o,),
                                      generator=g)) % n_l
    W, hinv, hcc, x = [torch.randn(s, generator=g).to(dev) for s in (
        (o, 6, 3), (n_l, 3, 3), (c, 6, 6), (c, 6))]
    order = cuda_kernels.schur_order(cams[rank].to(dev), li.to(dev), c, n_l,
                                     kernels=True)
    return W, hinv, hcc, order, x


def keep_worst(errs, rel_errs, new):
    """Fold check_chain's {kernel: (abs, rel)} into the running maxima."""
    for name, (err, rel) in new.items():
        errs[name] = max(errs.get(name, 0.0), err)
        rel_errs[name] = max(rel_errs.get(name, 0.0), rel)


def device_live(n_live, dev):
    """The live count as the chain kernels take it in a graph: a 0-d
    int32 tensor on the card."""
    return torch.full((), n_live, dtype=torch.int32, device=dev)


def check_chain(ops, n_live, what):
    """chain_prepare and chain_sweep, with the live count a device
    scalar, against their plain twins on the operands (JjInv, Ji, winv,
    v): {kernel: (max abs error, the same over max |twin|)}; the
    relative one is what CHAIN_TOL bounds."""
    live = device_live(n_live, ops[0].device)
    prep_k = cuda_kernels.chain_prepare_cuda(ops[0], ops[1], live)
    prep_p = cuda_kernels.chain_prepare_plain(ops[0], ops[1], n_live)
    xk = cuda_kernels.chain_sweep_cuda(*ops, live, prep=prep_k)
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


def _span_ms(spans):
    """span name -> host ms of each; a relaxation's (`host:slam.pgo`)
    less its uploads (`host:wait.pgo_inputs`), which wait for every step
    queued before it."""
    inputs = {}
    for sp in spans:
        if sp.name == "host:wait.pgo_inputs":
            inputs[sp.parent] = inputs.get(sp.parent, 0.0) + sp.ms
    out = {}
    for sp in spans:
        out.setdefault(sp.name, []).append(sp.ms - inputs.get(sp.id, 0.0))
    return out


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
    # of pgo_costs, which is finalize's.
    pgo_runs = len(sys_.pgo_costs)
    gn_iters = ((pgo_runs - 1) * max(cfg.ba.pg_iters // 5, 3)
                + cfg.ba.pg_iters)
    # No pass reaches BA's CG-path kernels: finalize relaxes the pose
    # graph, and local BA's windows take the dense path.
    want = {"fast_score": f, "hamming_top2": 2 * f - 1,
            "hamming_top2_batched": sys_.n_slates,
            "chain_prepare": gn_iters,
            "chain_sweep": gn_iters * (cfg.ba.cg_iters + 1), "ba_schur": 0,
            "ba_obs": 0, "ba_cg": 0}
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
    """This slice's path: the clip at the default config (local BA on)
    with a checkpoint at CKPT_FRAME (a checkpoint consumes its poll's
    verification at once, so it is part of the run), then a second pass
    to the checkpoint, whose snapshot must equal the first's. Its
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

    # Every scatter-add of BA sums in float64: a second pass from scratch
    # reaches the snapshot of frame CKPT_FRAME with the same state, to
    # the bit; the checkpoint phase resumes from it and holds the rest
    # of the clip to this pass's ATEs.
    path2 = os.path.join(tmp, "ckpt2.npz")
    k = CKPT_FRAME + 1
    sys2, _, _, _, (_, t_loop2, _, _) = run_slam(
        cfg, world, lefts[:k], rights[:k], ckpt_path=path2)
    costs2 = torch.stack(sys2.ba_costs).cpu().numpy()
    moved = np.nonzero(costs2 != costs[:len(costs2)])[0]
    with np.load(path) as a, np.load(path2) as b:
        leaves = sorted(a.files)
        differ = (["the leaf names"] if leaves != sorted(b.files) else
                  [x for x in leaves if not np.array_equal(a[x], b[x])])
    say("slam-ba-repeat", frames=k, slam_frames_per_s=(k - 1) / t_loop2,
        windows=len(costs2), first_window_with_another_cost=(
            int(moved[0]) if len(moved) else None),
        snapshot_leaves=len(leaves), snapshot_leaves_differing=differ)
    check(not differ and not len(moved),
          f"two passes differ at the frame-{CKPT_FRAME} snapshot: leaves "
          f"{differ}, BA windows {moved.tolist()}")
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
        slam_ba_frames_per_s_second_run=(k - 1) / t_loop2,
        slam_ba_ate_odometry_m=n["ate_odo"], slam_ba_ate_before_m=n["ate_pre"],
        slam_ba_ate_after_m=n["ate_post"], slam_ba_loop_edges=len(n["edges"]),
        slam_ba_windows=len(costs), local_ba_step_ms=ba_ms,
        local_ba_step_syncs=syncs, checkpoint_save_s=t_ckpt)


def phase_checkpoint(cfg, world, lefts, rights, path, straight,
                     straight_ates):
    """Resume from the snapshot of frame CKPT_FRAME and run the rest of
    the clip: the final poses against the straight run's, and the ATEs
    before and after finalize equal to its (`straight_ates`)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_ = pipeline.SlamSystem.resume(path, world.cam.to("cpu"), cfg)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(sys_.state.traj.is_cuda and sys_.frame_count == CKPT_FRAME,
          "resume: the state is not on the card or not at the snapshot")
    run_blocks(sys_, lefts, rights, CKPT_FRAME + 1)
    pre = sys_.poses()
    post = sys_.finalize()
    gt = world.poses.cpu().numpy()
    ates = (ate_rmse(pre, gt, align=False), ate_rmse(post, gt, align=False))
    diff = float(np.abs(post[:, :3, 3] - straight[:, :3, 3]).max())
    say("checkpoint", resumed_at=CKPT_FRAME, load_seconds=f"{t_load:.3f}",
        frames_after=lefts.shape[0] - 1 - CKPT_FRAME,
        max_abs_position_diff_m=diff, loop_edges=len(sys_.loop_edges),
        local_ba_windows_after=len(sys_.ba_costs),
        ate_before_after_finalize_m=ates,
        straight_ate_before_after_finalize_m=straight_ates)
    check(post.shape == straight.shape and diff <= RESUME_TOL,
          f"resumed run is {diff} m off the straight run")
    check(all(abs(a - b) <= SAME_ATE_TOL
              for a, b in zip(ates, straight_ates)),
          f"resumed run's ATEs {ates} differ from the straight run's "
          f"{straight_ates}")
    return dict(checkpoint_load_s=t_load, resume_max_diff_m=diff)


def max_abs_diff(a, b) -> float:
    """The largest |a - b| over the float leaves of two trees of
    tensors (0 where they are equal)."""
    return max([float((x.double() - y.double()).abs().max())
                for x, y in zip(flatten(a), flatten(b), strict=True)
                if x.is_floating_point() and x.numel()] + [0.0])


def phase_global_ba(cfg, sys_, world, smi):
    """Global BA with pose priors on the finished state, as the CLI's
    offline pass drives it: two eager calls (`graphs=False`) held to each
    other, the graphed call that captures `ba_build`, `ba_lm` and
    `ba_apply`, a second graphed call made only of replays held to the
    eager one (and its ba_schur launches counted), the calls timed eager
    against graphed and the graphs' stats; then one CG matvec timed
    against its bound, the reduced-system halves held to their twins
    and timed on the same system and at the offline cell's sizes, and
    the observation pass (csrc/ba_obs.cu) held to its twins and timed on
    the same problem and on a synthetic drive at the cell's sizes, and
    the PCG vector update (csrc/ba_cg.cu) held to its twins on the same
    system and timed there and at the cell's sizes.
    -> (launch counts of the replayed call, {"ba_schur": times,
    "ba_schur_cell": times, "ba_obs": times, "ba_obs_cell": times,
    "ba_cg": times, "ba_cg_cell": times}, {"ba_schur": errors, "ba_obs":
    errors, "ba_cg": errors}, numbers)."""
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
    iters = cfg.ba.lm_iters
    dev = st.traj.device
    steps = torch.arange(iters, device=dev)
    cut_bits = [ba.graduated_cut(cfg.ba.outlier_px, steps[t],
                                 torch.float32).cpu().view(torch.int32)
                for t in range(iters)]
    host_bits = [torch.full((), cfg.ba.outlier_px * max(1.0, 8.0 * 0.5 ** t),
                            dtype=torch.float32).view(torch.int32)
                 for t in range(iters)]
    check(all(torch.equal(a, b) for a, b in zip(cut_bits, host_bits)),
          "the graduated cut made on the card differs from the host's")

    def call(graphs):
        return pipeline.global_ba_step(
            st, sys_.cam, cfg, n_kf=bucket, obs_bucket=obs_bucket,
            return_trace=True, loop_rows=loop_rows, graphs=graphs)

    def timed(graphs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call(graphs)
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0)

    GRAPHS.clear()
    eager, eager_ms = timed(False)
    eager2, eager2_ms = timed(False)
    eager_diff = tree_diff(eager, eager2, "eager")
    eager_spread = max_abs_diff(eager, eager2)
    captured, capture_call_ms = timed(True)
    names = ("ba_build", "ba_lm", "ba_apply")
    graphs = solver_graphs("global-ba", names, "global_ba", "ba")
    replays = [graphs[n].replays for n in names]
    cuda_kernels.reset_launch_counts()
    graphed, graphed_ms = timed(True)
    counts = cuda_kernels.launch_counts()
    check([graphs[n].replays - r for n, r in zip(names, replays)]
          == [1, iters, 1] and solver_graphs(
              "global-ba", names, "global_ba", "ba") == graphs,
          f"the second graphed call was not one replay of ba_build, "
          f"{iters} of ba_lm and one of ba_apply")
    # The CG path (more than DIRECT_MAX_CAMS rows) launches both halves
    # for each product, twice for the right side and the landmark half
    # once for the back-substitution, in every LM iteration, and the
    # observation pass three times an iteration (cameras, landmarks, the
    # cost after the step) and once for ba_apply's final cost, and the
    # PCG vector update once to start and once a CG iteration.
    cg_path = bucket > ba.DIRECT_MAX_CAMS
    per_iter = 2 * (cfg.ba.cg_iters + 1) + 3 if cg_path else 0
    want = {**{k: 0 for k in counts}, "ba_schur": iters * per_iter,
            "ba_obs": 3 * iters + 1 if cg_path else 0,
            "ba_cg": iters * (cfg.ba.cg_iters + 1) if cg_path else 0}
    check(counts == want, f"the replayed global BA launched {counts}, "
          f"not {want}")
    graph_diff = tree_diff(eager, graphed, "global_ba")
    graph_spread = max_abs_diff(eager, graphed)
    capture_diff = tree_diff(captured, graphed, "global_ba")
    times = {}
    for which, graphs_on in (("eager", False), ("graph", True),
                             ("graph", True), ("eager", False)):
        times.setdefault(f"{which}_events_ms", []).append(
            event_ms(lambda g=graphs_on: call(g), reps=1, warm=0))
        times.setdefault(f"{which}_host_ms", []).append(
            host_ms(lambda g=graphs_on: call(g), reps=1, warm=0))
    times = {k: float(np.mean(v)) for k, v in times.items()}
    syncs, where = count_syncs(lambda: call(True))
    stats = {n: graphs[n].stats() for n in names}
    new, cost, trace = graphed
    poses = new.traj[:f].cpu().numpy()
    ate_after = ate_rmse(poses, gt, align=False)
    tr = {k: getattr(trace, k).cpu().numpy().tolist() for k in trace._fields}
    cost = float(cost)
    say("global-ba-graphs", card=smi, eager_call_ms=[eager_ms, eager2_ms],
        eager_vs_eager_differing=eager_diff,
        eager_vs_eager_max_abs=eager_spread,
        capture_call_ms=capture_call_ms, graph_call_ms=graphed_ms,
        graph_vs_eager_differing=graph_diff,
        graph_vs_eager_max_abs=graph_spread,
        capture_vs_replay_differing=capture_diff,
        ms_per_lm_iteration={k: v / iters for k, v in times.items()},
        call_ms=times, graph_replay_syncs=syncs,
        **{f"{n}_{k}": v for n, st_ in stats.items()
           for k, v in st_.items()})
    check(syncs == 0, f"a warm graphed global BA made host syncs: {where}")
    check(not capture_diff, f"the capturing call and the replays differ: "
          f"{capture_diff}")
    check(not graph_diff, f"graphed global BA differs from eager "
          f"({graph_spread} at most; eager against eager "
          f"{eager_spread}): {graph_diff}")

    # One CG matvec of the reduced system at the initial point.
    prob, _ = pipeline.build_global_problem(
        st, bucket, obs_bucket, loop_rows=loop_rows,
        prior_odo_weight=cfg.ba.prior_odo_weight,
        prior_loop_weight=cfg.ba.prior_loop_weight)
    _, r0, hw = ba._cost(prob, sys_.cam, cfg.ba.huber_delta)
    r, Jc, Jl, w = ba._linearize(prob, sys_.cam, prob.w * hw)
    lam = torch.full((), cfg.ba.lm_lambda0, device=r.device)
    blocks = ba._normal_blocks(prob, r, Jc, Jl, w)
    matvec, btil, Minv, _ = ba._reduced_system(prob, blocks, lam,
                                               ba._obs_order(prob))
    Hcc, Hll, W, bc, bl, _ = blocks
    Hcc_d = ba._damped(Hcc, lam)
    Hll_inv = inv3x3(ba._damped(Hll, lam))
    order = cuda_kernels.schur_order(prob.cam_idx, prob.lm_idx,
                                     prob.poses.shape[0],
                                     prob.points.shape[0], kernels=True,
                                     w=prob.w)
    schur_err = schur_errors("global-ba", W, Hll_inv, Hcc_d, order, btil,
                             bl, bc)
    o, c, l, e = (prob.uv.shape[0], prob.poses.shape[0],
                  prob.points.shape[0], prob.pe_i.shape[0])
    schur_times = {"ba_schur": time_ba_schur(
        W, Hll_inv, Hcc_d, order, btil,
        f"{o} observations, {c} camera rows, {l} landmarks (phase "
        f"global-ba)")}
    schur_times["ba_schur_cell"] = time_ba_schur(
        *schur_cell_inputs(r.device),
        "{} observations, {} camera rows of which {} observed, {} "
        "landmarks (ba-global-2048's sizes, synthetic operands)".format(
            *SCHUR_CELL))
    cut2, cap = obs_cut(cfg.ba, iters - 1, r.device)
    obs_err = ba_obs_errors("global-ba", prob, sys_.cam, cut2, cap,
                            cfg.ba.huber_delta)
    schur_times["ba_obs"] = time_ba_obs(
        prob, sys_.cam, cut2, cap,
        f"{o} observations, {c} camera rows, {l} landmarks (phase "
        f"global-ba)", cfg.ba.huber_delta)
    # The PCG vector update on the phase's own system: the start from
    # r = btil (x = 0), then one step after one product.
    Minv = Minv.contiguous()
    p0, rz0 = cuda_kernels.ba_cg_start_cuda(btil, Minv)
    cg_own = (p0, matvec(p0), torch.zeros_like(btil), btil, Minv, rz0)
    cg_err = cg_errors("global-ba", cg_own)
    schur_times["ba_cg"] = time_ba_cg(
        cg_own, f"{c} camera rows (phase global-ba)")
    schur_times["ba_cg_cell"] = time_ba_cg(
        cg_state(*CG_CELL, r.device),
        "{} camera rows of which {} observed (ba-global-2048's sizes, "
        "synthetic operands)".format(*CG_CELL))
    cell, cell_cam = obs_cell_inputs(r.device)
    ba_obs_errors("cell", cell, cell_cam, cut2, cap, cfg.ba.huber_delta)
    schur_times["ba_obs_cell"] = time_ba_obs(
        cell, cell_cam, cut2, cap,
        "{} observations, {} camera rows of which {} observed, {} "
        "landmarks (ba-global-2048's sizes, a synthetic drive)".format(
            *SCHUR_CELL), cfg.ba.huber_delta)
    del cell
    # The landmarks launch's tail: a thread walks each landmark's rows.
    per_lm = torch.bincount(prob.lm_idx.long()[prob.w != 0],
                            minlength=l).float()
    lm_rows = {"mean": float(per_lm[per_lm > 0].mean()),
               "p99": float(torch.quantile(per_lm[per_lm > 0], 0.99)),
               "max": int(per_lm.max())}
    mv_ms = event_ms(lambda: matvec(btil), reps=20, warm=3)
    mv_device_ms = graph_ms(lambda: matvec(btil))
    lin_ms = event_ms(lambda: ba._linearize(prob, sys_.cam, prob.w * hw),
                      reps=10, warm=2)
    mv_bound_ms, mv_by = bound_ba_matvec(o, c, l, e)
    say("global-ba", keyframes=n_kf, camera_rows=bucket,
        observations=n_obs_real, observation_bucket=obs_bucket,
        weighted_observations=int(prob.w.sum()), landmark_rows=l,
        prior_edges=e, lm_iters=iters, cg_iters=cfg.ba.cg_iters,
        call_ms=graphed_ms, ms_per_lm_iteration=graphed_ms / iters,
        eager_ms_per_lm_iteration=eager_ms / iters,
        matvecs_per_call=iters * (cfg.ba.cg_iters + 1),
        matvec_ms=mv_ms, matvec_device_ms=mv_device_ms,
        matvec_bound_ms=mv_bound_ms, matvec_bound_by=mv_by,
        matvec_share_of_bound=mv_bound_ms / mv_device_ms,
        linearize_ms=lin_ms, rows_per_landmark=lm_rows,
        launches=counts, expected=want,
        final_cost=cost, trace=tr, ate_before_m=ate_before,
        ate_after_m=ate_after)
    check(math.isfinite(cost) and cost <= tr["cost"][0],
          f"global BA cost {cost} not finite or above the first trace "
          f"entry {tr['cost'][0]}")
    check(any(tr["accept"]), "global BA accepted no step")
    check(bool(np.isfinite(poses).all()) and ate_after <= 1.05 * ate_before,
          f"global BA moved keyframe ATE {ate_before} -> {ate_after}")
    out = dict(global_ba_ms_per_lm_iteration=graphed_ms / iters,
               global_ba_eager_ms_per_lm_iteration=eager_ms / iters,
               global_ba_eager_vs_eager_max_abs=eager_spread,
               global_ba_graph_vs_eager_max_abs=graph_spread,
               global_ba_capture_call_ms=capture_call_ms,
               global_ba_graph_replay_syncs=syncs,
               global_ba_observations=n_obs_real,
               global_ba_matvec_ms=mv_ms,
               global_ba_matvec_device_ms=mv_device_ms,
               global_ba_matvec_bound_ms=mv_bound_ms,
               global_ba_linearize_ms=lin_ms,
               global_ba_rows_per_landmark=lm_rows,
               global_ba_accepted=int(sum(tr["accept"])),
               global_ba_cost_first_last=[tr["cost"][0], cost],
               global_ba_ate_before_m=ate_before,
               global_ba_ate_after_m=ate_after)
    out.update({f"global_ba_{k}_per_lm_iteration": v / iters
                for k, v in times.items()})
    out.update({f"global_{n}_graph_{k}": stats[n][k] for n in names
                for k in ("capture_seconds", "nodes", "pool_bytes")})
    # The graphs' pools are not needed by the later phases.
    GRAPHS.clear()
    return counts, schur_times, {"ba_schur": schur_err,
                                 "ba_obs": obs_err, "ba_cg": cg_err}, out


def bal_errors(tag, tol, got, want):
    """{name: (max abs error, the same over the twin's largest |value|)}
    of kernel outputs against their twins, each checked within `tol`."""
    out = {}
    for name, k, t in zip(want, got, want.values()):
        diff = (k.double() - t.double()).abs()
        err = float(diff.max())
        rel = err / max(float(t.abs().max()), 1e-30)
        say("bal", kernel=tag, block=name, max_abs_err=err, rel_err=rel)
        check(bool(torch.isfinite(k).all()) and rel <= tol,
              f"{tag} {name}: error {rel} of its largest value (> {tol})")
        out[name] = (err, rel)
    return out


def phase_bal(dev):
    """BAL at Venice's sizes (see the module docstring) -> (times {name +
    "_bal": time_kernel rows}, errors {kernel: (max abs, max rel)},
    numbers)."""
    from benchmark.yardstick import bal_synth
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models import bal
    from slam1_tpu_torch.ops import bal_obs
    from slam1_tpu_torch.utils import bounds
    with open(os.path.join(REPO, "benchmark", "configs",
                           "bal-venice.json")) as f:
        conf = json.load(f)
    p = bal.BalProblem(*bal_synth.make(BAL_SEED, conf, dev)[:6])
    o, c, n_l = p.uv.shape[0], p.cams.shape[0], p.points.shape[0]
    sizes = f"{c} cameras, {n_l} points, {o} observations"
    cfg = BAConfig()
    delta = cfg.huber_delta
    cut2 = cap = None                    # BAL's model cuts no observation
    order = ba._obs_order(p, ba.BAL)
    plain = cuda_kernels.SchurOrder(order.cam_idx, order.lm_idx)

    def launches():
        obs = cuda_kernels.bal_obs_cameras_cuda(p, (), order, cut2, cap,
                                                delta)
        return obs, cuda_kernels.bal_obs_landmarks_cuda(
            p, (), order, cut2, delta)
    obs, (hll, bl) = launches()
    again = launches()
    cost = cuda_kernels.bal_obs_cost_cuda(p, (), order, cap, delta)
    twin = bal_obs.cameras_plain(p, (), plain, cut2, cap, delta)
    twin_l = bal_obs.landmarks_plain(p, (), plain, cut2, delta)
    errs = {"bal_obs": bal_errors(
        "bal_obs", BAL_OBS_TOL, (obs.W, obs.hcc, obs.bc, hll, bl),
        dict(W=twin.W, Hcc=twin.hcc, bc=twin.bc, Hll=twin_l[0],
             bl=twin_l[1]))}
    same = all(torch.equal(bits(a), bits(b)) for a, b in
               zip(flatten((obs, hll, bl)), flatten(again)))
    cost_same = bool(torch.equal(bits(cost[0]), bits(obs.full))
                     and torch.equal(bits(cost[1]), bits(obs.trunc)))
    cost_rel = [abs(float(k) - float(t)) / abs(float(t))
                for k, t in ((obs.full, twin.full), (obs.trunc, twin.trunc))]
    say("bal", kernel="bal_obs", sizes=sizes, cost_rel_err=cost_rel,
        kept=int(obs.n_kept), twin_kept=int(twin.n_kept),
        repeat_same_bits=same, cost_launch_same_bits=cost_same)
    check(max(cost_rel) <= BAL_OBS_TOL
          and int(obs.n_kept) == int(twin.n_kept),
          f"bal_obs costs: {cost_rel}, kept {int(obs.n_kept)} against "
          f"{int(twin.n_kept)}")
    check(same and cost_same, f"bal_obs: a second launch or the cost "
          f"launch gave other bits ({same}, {cost_same})")
    del twin, twin_l, again

    # The reduced system of this pass at lm_lambda0, both halves at D = 9.
    lam = torch.tensor(cfg.lm_lambda0, device=dev)
    hinv = inv3x3(ba._damped(hll, lam))
    hcc = ba._damped(obs.hcc, lam)
    minv = ba._inv_lu(hcc)
    W = obs.W
    va = cuda_kernels.ba_schur_landmarks_cuda(W, hinv, order, a=bl)
    btil = cuda_kernels.ba_schur_cameras_cuda(W, va, order, b=obs.bc)
    x = torch.einsum("cij,cj->ci", minv, btil).contiguous()
    v = cuda_kernels.ba_schur_landmarks_cuda(W, hinv, order, x=x)
    ax = cuda_kernels.ba_schur_cameras_cuda(W, v, order, hcc=hcc, x=x)
    errs["ba_schur"] = bal_errors(
        "ba_schur D=9", BAL_SCHUR_TOL,
        (va, btil, v, ax,
         cuda_kernels.ba_schur_landmarks_cuda(W, hinv, order, x=x, a=bl)),
        {"landmarks a": cuda_kernels.ba_schur_landmarks_plain(
            W, hinv, plain, a=bl),
         "cameras b": cuda_kernels.ba_schur_cameras_plain(
             W, va, plain, b=obs.bc),
         "landmarks x": cuda_kernels.ba_schur_landmarks_plain(
             W, hinv, plain, x=x),
         "cameras hcc x": cuda_kernels.ba_schur_cameras_plain(
             W, v, plain, hcc=hcc, x=x),
         "landmarks x a": cuda_kernels.ba_schur_landmarks_plain(
             W, hinv, plain, x=x, a=bl)})
    pz, rz = cuda_kernels.ba_cg_start_cuda(btil, minv)
    step = cuda_kernels.ba_cg_step_cuda(pz, ax, x, btil, minv, rz)
    twin_start = cuda_kernels.ba_cg_start_plain(btil, minv)
    errs["ba_cg"] = bal_errors(
        "ba_cg D=9", BAL_CG_TOL, (pz, rz) + tuple(step),
        dict(zip(("start p", "start rz", "x", "r", "p", "rz"),
                 twin_start + tuple(cuda_kernels.ba_cg_step_plain(
                     pz, ax, x, btil, minv, rz)))))

    times = {"bal_obs_bal": time_kernel(
        "bal_obs",
        lambda: (bal_obs.cameras_plain(p, (), plain, cut2, cap, delta),
                 bal_obs.cost_plain(p, (), plain, cap, delta)),
        lambda: (launches(), cuda_kernels.bal_obs_cost_cuda(
            p, (), order, cap, delta)),
        *bound(*[sum(bounds.bal_obs_work(o, c, n_l, k)[i] for k in (
            "cameras", "landmarks", "cost")) for i in (0, 1)],
            PEAK_F32_FLOPS), plain_reps=2,
        per=f"one LM iteration's BAL observation pass: {sizes}")}
    times["bal_obs_bal"]["by_launch"] = {
        "cameras": time_kernel(
            "bal_obs",
            lambda: bal_obs.cameras_plain(p, (), plain, cut2, cap, delta),
            lambda: cuda_kernels.bal_obs_cameras_cuda(p, (), order, cut2,
                                                      cap, delta),
            *bounds.bound_bal_obs(o, c, n_l, "cameras"), plain_reps=2,
            per=f"the cameras launch: {sizes}"),
        "landmarks": time_kernel(
            "bal_obs",
            lambda: bal_obs.landmarks_plain(p, (), plain, cut2, delta),
            lambda: cuda_kernels.bal_obs_landmarks_cuda(p, (), order, cut2,
                                                        delta),
            *bounds.bound_bal_obs(o, c, n_l, "landmarks"), plain_reps=2,
            per=f"the landmarks launch: {sizes}"),
        "cost": time_kernel(
            "bal_obs",
            lambda: bal_obs.cost_plain(p, (), plain, cap, delta),
            lambda: cuda_kernels.bal_obs_cost_cuda(p, (), order, cap, delta),
            *bounds.bound_bal_obs(o, c, n_l, "cost"), plain_reps=2,
            per=f"the cost launch: {sizes}")}
    times["ba_schur_bal"] = {
        "landmarks": time_kernel(
            "ba_schur",
            lambda: cuda_kernels.ba_schur_landmarks_plain(W, hinv, plain,
                                                          x=x),
            lambda: cuda_kernels.ba_schur_landmarks_cuda(W, hinv, order, x=x),
            *bounds.bound_bal_schur(o, c, n_l, "landmarks"), plain_reps=3,
            per=f"the landmark half at D = 9: {sizes}"),
        "cameras": time_kernel(
            "ba_schur",
            lambda: cuda_kernels.ba_schur_cameras_plain(W, v, plain, hcc=hcc,
                                                        x=x),
            lambda: cuda_kernels.ba_schur_cameras_cuda(W, v, order, hcc=hcc,
                                                       x=x),
            *bounds.bound_bal_schur(o, c, n_l, "cameras"), plain_reps=3,
            per=f"the camera half at D = 9: {sizes}")}
    times["ba_cg_bal"] = time_kernel(
        "ba_cg",
        lambda: cuda_kernels.ba_cg_step_plain(pz, ax, x, btil, minv, rz),
        lambda: cuda_kernels.ba_cg_step_cuda(pz, ax, x, btil, minv, rz),
        *bound(*bounds.bal_cg_work(c), PEAK_F32_FLOPS),
        per=f"one PCG step's vector update at D = 9: {c} cameras")
    del obs, hll, bl, W, hinv, hcc, minv, va, btil, x, v, ax, pz, rz, step

    # One pass captures bal_lm and bal_cost; then each replay's launches.
    ba.BA_GRAPHS.clear()
    t0 = time.perf_counter()
    ba.bundle_adjust(p, (), cfg, model=ba.BAL)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graphs = solver_graphs("bal", ("bal_lm", "bal_cost"), "ba")
    carry = ba._lm_carry(p, (), cfg, False, ba.BAL)
    counts, syncs = {}, {}
    for name in ("bal_lm", "bal_cost"):
        graphs[name](carry)                               # warm
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        graphs[name](carry)
        torch.cuda.synchronize()
        counts[name] = {k: n for k, n in cuda_kernels.launch_counts().items()
                        if n}
        syncs[name] = count_syncs(lambda g=graphs[name]: g(carry))[0]
    per_lm = cfg.cg_iters + 1
    say("bal", first_pass_s=first_s, replay_launches=counts,
        replay_host_syncs=syncs)
    check(counts["bal_lm"] == {"bal_obs": 3, "ba_schur": 2 * per_lm + 3,
                               "ba_cg": per_lm}
          and counts["bal_cost"] == {"bal_obs": 1},
          f"bal: a replay's launches {counts}")
    check(syncs == {"bal_lm": 0, "bal_cost": 0},
          f"bal: host syncs in a warm replay {syncs}")
    ba.BA_GRAPHS.clear()
    torch.cuda.empty_cache()
    return times, {k: (max(e[0] for e in v.values()),
                       max(e[1] for e in v.values()))
                   for k, v in errs.items()}, {
        "bal_replay_launches": counts,
        "bal_rel_err": {k: max(e[1] for e in v.values())
                        for k, v in errs.items()}}


def traj_file(n, path):
    """A drifting trajectory of `n` poses (the two-lap loop with 5 cm of
    noise on each position) saved as float64, as np.save writes one."""
    poses = synthetic.make_trajectory(n, "loop2", 1.0, dtype=torch.float64,
                                      device="cpu").numpy()
    poses[:, :3, 3] += np.random.default_rng(n).normal(0, 0.05, (n, 3))
    np.save(path, poses)
    return path


def phase_traj_ba(smi, dev, tmp):
    """`slam-torch ba <traj.npy>` at KITTI 02's length (4661 poses) and
    at TRAJ_POSES[-1], past the 8533 rows whose chain offsets fit in
    shared memory: the command in process on a float64 file, the launch
    counters reset just before and read just after (one chain_prepare
    per Gauss-Newton iteration, one chain_sweep per preconditioner
    application), then posegraph.optimize on the command's graph eager
    (`graphs=False`) against replays of its graphs, to the bit, timed in
    turns eager, graph, graph, eager; the host syncs of a warm call and
    pg_gn's stats. -> (launches by path, numbers)."""
    out, by_path = {}, {}
    for n in TRAJ_POSES:
        path = traj_file(n, os.path.join(tmp, f"traj{n}.npy"))
        opt_path = os.path.join(tmp, f"opt{n}.npy")
        GRAPHS.clear("posegraph")
        buf = io.StringIO()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["ba", path, "--out", opt_path])
        cli_s = time.perf_counter() - t0
        counts = by_path[f"traj_ba_{n}"] = cuda_kernels.launch_counts()
        want = {**{k: 0 for k in counts}, "chain_prepare": TRAJ_ITERS,
                "chain_sweep": TRAJ_ITERS * (TRAJ_CG_ITERS + 1)}
        check(counts == want, f"`ba` on {n} poses launched {counts}, "
              f"not {want}")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0 and line["frames"] == n
              and math.isfinite(line["final_cost"]),
              f"`ba` on {n} poses: rc {rc}, line {line}")
        graph = cli.trajectory_graph(np.load(path), dev)

        def call(graphs, graph=graph):
            return posegraph.optimize(graph, TRAJ_ITERS, graphs=graphs)

        eager = call(False)
        graphed = call(True)
        diff = tree_diff(eager, graphed, f"optimize[{n}]")
        cli_diff = tree_diff(eager[0].cpu().numpy(), np.load(opt_path),
                             f"ba[{n}]")
        times = {}
        for which, graphs_on in (("eager", False), ("graph", True),
                                 ("graph", True), ("eager", False)):
            times.setdefault(which, []).append(
                host_ms(lambda g=graphs_on: call(g), reps=1, warm=0))
        ms = {k: float(np.mean(v)) / TRAJ_ITERS for k, v in times.items()}
        syncs, where = count_syncs(lambda: call(True))
        gn = solver_graphs("traj-ba", ("pg_gn", "pg_cost"),
                           "posegraph")["pg_gn"]
        cost0 = float(posegraph.optimize(graph, iters=0)[1])
        staged = cuda_kernels.chain_sweep_staged(n)
        say("traj-ba", card=smi, poses=n, gn_iters=TRAJ_ITERS,
            cg_iters=TRAJ_CG_ITERS, launches=counts,
            chain_offsets="device memory" if staged
            else "shared memory", cli_seconds=cli_s, cli_result=line,
            graph_vs_eager_differing=diff, cli_vs_eager_differing=cli_diff,
            ms_per_gn_iteration=ms, eager_call_ms=times["eager"],
            graph_call_ms=times["graph"], cost_before=cost0,
            cost_after=float(eager[1]), graph_replay_syncs=syncs,
            **{f"pg_gn_{k}": v for k, v in gn.stats().items()})
        check(not diff, f"graphed optimize at {n} poses differs from "
              f"eager: {diff}")
        check(not cli_diff, f"`ba` at {n} poses differs from optimize")
        check(syncs == 0, f"a warm graphed optimize made host syncs: {where}")
        check(bool(torch.isfinite(eager[0]).all())
              and float(eager[1]) <= cost0 + 1e-3 * max(cost0, 1.0),
              f"optimize at {n} poses: cost {cost0} -> {float(eager[1])}")
        out.update({f"traj_ba_{n}_ms_per_gn_eager": ms["eager"],
                    f"traj_ba_{n}_ms_per_gn_graph": ms["graph"],
                    f"traj_ba_{n}_pg_gn_nodes": gn.nodes,
                    f"traj_ba_{n}_pg_gn_capture_seconds": gn.capture_seconds,
                    f"traj_ba_{n}_pg_gn_pool_bytes": gn.pool_bytes,
                    f"traj_ba_{n}_graph_replay_syncs": syncs})
    GRAPHS.clear("posegraph")
    return by_path, out


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


GRAPH_REPS = 20              # warm steps per timing of a step
PGO_REPS = 3                 # warm relaxations per timing of the PGO


def bits(t):
    """A tensor's bits: float tensors viewed as integers, so that equal
    NaNs compare equal."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.float16: torch.int16, torch.bfloat16: torch.int16}
    return t.contiguous().view(ints[t.dtype]) if t.dtype in ints else t


def tree_diff(a, b, path="state"):
    """The paths of the leaves where two trees (tuples, NamedTuples,
    tensors, numbers, numpy arrays) differ, to the bit."""
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            return [path]
        names = getattr(a, "_fields", range(len(a)))
        return [d for n, x, y in zip(names, a, b)
                for d in tree_diff(x, y, f"{path}.{n}")]
    if isinstance(a, torch.Tensor):
        same = (a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(bits(a), bits(b)))
    elif isinstance(a, np.ndarray):
        same = a.shape == b.shape and a.tobytes() == b.tobytes()
    else:
        same = a == b
    return [] if same else [path]


def host_ms(fn, reps=GRAPH_REPS, warm=2):
    """Mean host-clock ms of fn() over `reps` calls ending in a
    synchronize."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def step_times(tag, eager, graphed, late, reps=GRAPH_REPS):
    """ms per warm step, eager and graphed (CUDA events and host clock,
    `reps` calls each), and the host syncs of one warm graph replay; the
    device-busy shares (torch.profiler) go into `late`."""
    out = {}
    for which, fn in (("eager", eager), ("graph", graphed),
                      ("graph", graphed), ("eager", eager)):
        out.setdefault(f"{which}_events_ms", []).append(
            event_ms(fn, reps=reps, warm=2))
        out.setdefault(f"{which}_host_ms", []).append(host_ms(fn, reps))
    out = {k: float(np.mean(v)) for k, v in out.items()}
    out["graph_replay_syncs"], where = count_syncs(graphed)
    check(out["graph_replay_syncs"] == 0,
          f"a warm {tag} replay made host syncs: {where}")

    def profiled():
        busy = {w: device_busy_ms(fn) for w, fn in (("eager", eager),
                                                     ("graph", graphed))}
        shares = {f"{tag}_{w}_device_busy_ms": b for w, b in busy.items()}
        shares.update({f"{tag}_{w}_device_busy_share":
                       b / out[f"{w}_events_ms"] for w, b in busy.items()})
        say(f"graphs-{tag}-profile", **shares)
        return shares
    late.append(profiled)
    return out


def backend_times(cfg, esys, gsys, late):
    """The backend graphs of the graphed SLAM pass (`gsys`) against
    eager calls of the same functions on the eager pass's state: ms per
    call (CUDA events and host clock), the host syncs of a warm replay
    (0), the device-busy shares (into `late`) and each graph's stats.
    Inputs: local BA's window ending at the middle keyframe, a slate of
    the run's loop edges padded to SLATE_B, the newest keyframe's place
    query at its row bucket, and a live relaxation (its Gauss-Newton
    budget, the run's loop edges) of the finished trajectory, whose
    three programs are timed as one call and reported graph by graph."""
    graphs = gsys.backend_graphs
    st = gsys.state
    dev = st.traj.device
    kf_n = int(st.kf.n)

    def i64(v):
        return torch.full((), v, dtype=torch.int64, device=dev)
    pairs = [(j, i) for i, j, _, _ in gsys.loop_edges][:SLATE_B]
    hfs = [a for a, _ in pairs] + [0] * (SLATE_B - len(pairs))
    cs = [c for _, c in pairs] + [-1] * (SLATE_B - len(pairs))
    u = gsys.draws.slate(hfs, cs, 0, pipeline.LOOP_RANSAC_ITERS,
                         pipeline.KF_FEATURES)
    n_rows = next(b for b in (128, 512, 1024, 2048, 8192) if b >= kf_n)
    q_frame = int(st.kf.frame_of_row[kf_n - 1])
    place = f"place_query[{n_rows}]"
    calls = {
        "local_ba": (pipeline._graphed_local_ba(esys.cam, cfg),
                     (i64(kf_n // 2),)),
        "slate": (pipeline._graphed_slate(esys.cam, cfg),
                  (u, torch.tensor(cs, device=dev),
                   torch.tensor(hfs, device=dev))),
        place: (pipeline._graphed_place_query(cfg, n_rows),
                (i64(kf_n - 1), i64(q_frame - cfg.bow.query_exclude))),
    }
    check(set(calls) <= set(graphs),
          f"the graphed pass made the backend graphs {sorted(graphs)}, "
          f"not {sorted(calls)}")
    replays = {name: g.replays for name, g in graphs.items()}
    out = {}
    for name, (fn, args) in calls.items():
        g, tag = graphs[name], name.split("[")[0]
        t = step_times(
            tag, lambda fn=fn, args=args: fn(esys.state, *args),
            lambda g=g, args=args: g(gsys.state, *args), late)
        stats = g.stats()
        say(f"graphs-{tag}", graph=name, replays_in_pass=replays[name],
            **stats, **t)
        out.update({f"{tag}_{k}": v for k, v in t.items()})
        out.update({f"{tag}_graph_{k}": stats[k]
                    for k in ("capture_seconds", "nodes", "pool_bytes")})

    # The pose-graph relaxation: both systems relax their own (equal)
    # finished state, graphs=False eagerly.
    bucket, n_live, le = gsys._pgo_inputs()
    _, _, le_e = esys._pgo_inputs()
    iters = max(cfg.ba.pg_iters // 5, 3)
    names = {p: f"pgo_{p}[{bucket}]" for p in ("build", "gn", "apply")}
    check(set(names.values()) <= set(graphs),
          f"the graphed pass made no PGO graphs at bucket {bucket}: "
          f"{sorted(graphs)}")
    t = step_times(
        "pgo", lambda: esys._pgo(bucket, iters, n_live, *le_e),
        lambda: gsys._pgo(bucket, iters, n_live, *le), late, reps=PGO_REPS)
    say("graphs-pgo", bucket=bucket, n_live=n_live, gn_iterations=iters,
        replays_in_pass={n: replays[n] for n in names.values()},
        **{f"{p}_{k}": v for p, n in names.items()
           for k, v in graphs[n].stats().items()}, **t)
    out.update({f"pgo_{k}": v for k, v in t.items()})
    for p, n in names.items():
        stats = graphs[n].stats()
        out.update({f"pgo_{p}_graph_{k}": stats[k]
                    for k in ("capture_seconds", "nodes", "pool_bytes")})
    return replays, out


def phase_graphs(cfg, world, lefts, rights, bcfg, sworld, slefts, srights,
                 late):
    """The graphed steps against eager ones on the card: vo_block (one
    graph replay per frame) against a loop of vo_step on the arc clip,
    and SlamSystem's graph replays (the step, and local BA, the slates
    and the place queries over the step graph's state) against
    graphs=False over the 600-frame loop2 clip at `bcfg` (BoW training,
    culls, local BA write-backs, the ring's wrap, live PGOs, finalize).
    Everything must be equal to the bit, launch counts included."""
    cam, f = world.cam, lefts.shape[0]
    n = cfg.detector.max_kp

    # VO: the same generator seed on both sides.
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    es = vo.init_state(lefts[0], rights[0], cam, cfg, SEED)
    poses_e, ms_e = [], []
    for i in range(1, f):
        es, m = vo.vo_step(es, lefts[i], rights[i], cam, cfg)
        poses_e.append(es.T_w_cam)
        ms_e.append(m)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    counts_e = cuda_kernels.launch_counts()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gs = vo.init_state(lefts[0], rights[0], cam, cfg, SEED)
    gs, poses_g, ms_g = vo.vo_block(gs, lefts[1:], rights[1:], cam, cfg)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    counts_g = cuda_kernels.launch_counts()
    eager = (torch.stack(poses_e),
             vo.VOMetrics(*[torch.stack(v) for v in zip(*ms_e)]),
             es.T_w_cam, es.prev_obs, es.xi_vel, es.generator.get_state(),
             es.frame)
    graphed = (poses_g, ms_g, gs.T_w_cam, gs.prev_obs, gs.xi_vel,
               gs.generator.get_state(), gs.frame)
    vo_diff = tree_diff(eager, graphed, "vo")
    graph = gs.graph
    k = cfg.tracking.ransac_iters
    carry = (gs.T_w_cam, gs.prev_obs, gs.xi_vel)
    vo_u = draw_uniform(k, n, gs.generator, lefts.device)
    vo_t = step_times(
        "vo_step",
        lambda: vo.vo_step(es, lefts[5], rights[5], cam, cfg),
        lambda: graph(carry, lefts[5], rights[5], vo_u), late)
    say("graphs-vo", frames=f, differing=vo_diff, launches_eager=counts_e,
        launches_graph=counts_g, eager_loop_frames_per_s=(f - 1) / t_eager,
        vo_block_frames_per_s=(f - 1) / t_graph, **graph.stats(), **vo_t)
    check(not vo_diff, f"vo_block differs from the vo_step loop: {vo_diff}")
    check(counts_e == counts_g,
          f"VO launch counts: eager {counts_e}, graphed {counts_g}")
    vo_stats = graph.stats()

    # SLAM: SlamSystem graphed against graphs=False.
    runs = {}
    for name, graphs in (("graph", True), ("eager", False)):
        sys_ = pipeline.SlamSystem(sworld.cam, bcfg, seed=SEED,
                                   bow_train_frame=30, graphs=graphs)
        cuda_kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sys_.process(slefts[0], srights[0])
        run_blocks(sys_, slefts, srights, 1)
        torch.cuda.synchronize()
        t_loop = time.perf_counter() - t0
        post = sys_.finalize()
        runs[name] = (sys_, post, cuda_kernels.launch_counts(), t_loop)
    (gsys, gpost, gcounts, gt_loop), (esys, epost, ecounts, et_loop) = (
        runs["graph"], runs["eager"])
    check(gsys.step_graph is not None and esys.step_graph is None,
          "graphs=True did not capture, or graphs=False did")
    sf = slefts.shape[0]

    def result(sys_, post):
        return (post, sys_.state, sys_.metrics, sys_.loop_edges,
                torch.stack(sys_.ba_costs), torch.stack(sys_.pgo_costs),
                sys_.n_slates,
                [dataclasses.astuple(e) for e in sys_.loop_events])
    slam_diff = tree_diff(result(esys, epost), result(gsys, gpost), "slam")
    sg = gsys.step_graph
    # Nothing outside the graphs wrote the state after the step's last
    # replay (finalize's relaxation writes back in place): the timed
    # replays copy nothing.
    gsys.state = sg.load(gsys.state)
    d = pipeline.DrawSource(SEED + 2, slefts.device)
    slam_u = d.step(bcfg.tracking.ransac_iters, n)
    slam_t = step_times(
        "slam_step",
        lambda: pipeline.slam_step(esys.state, slefts[7], srights[7],
                                   esys.cam, bcfg, d),
        lambda: sg(gsys.state, slefts[7], srights[7], slam_u), late)
    say("graphs-slam", frames=sf, differing=slam_diff,
        launches_eager=ecounts, launches_graph=gcounts,
        eager_frames_per_s=(sf - 1) / et_loop,
        graph_frames_per_s=(sf - 1) / gt_loop,
        loop_edges=len(gsys.loop_edges), local_ba_windows=len(gsys.ba_costs),
        **sg.stats(), **slam_t)
    check(not slam_diff, f"SlamSystem's graph replays differ from its "
          f"eager steps: {slam_diff}")
    check(ecounts == gcounts,
          f"SLAM launch counts: eager {ecounts}, graphed {gcounts}")
    check(len(gsys.loop_edges) >= 2 and sg.loaded > 0,
          "the graphed pass closed < 2 loops or loaded no write-back")
    replays, backend_t = backend_times(bcfg, esys, gsys, late)
    # Each backend graph's first call is its warm-up: one replay per
    # later local BA window and slate.
    check(replays["local_ba"] == len(gsys.ba_costs) - 1
          and replays["slate"] == gsys.n_slates - 1,
          f"backend replays {replays}, windows {len(gsys.ba_costs)}, "
          f"slates {gsys.n_slates}")
    # Every relaxation (the live ones, finalize's) ran as the PGO
    # programs: one call of pgo_gn per Gauss-Newton iteration, each
    # bucket's first call its capture.
    runs = len(gsys.pgo_costs)
    gn_iters = (runs - 1) * max(bcfg.ba.pg_iters // 5, 3) + bcfg.ba.pg_iters
    calls = {p: sum(n + 1 for name, n in replays.items()
                    if name.startswith(f"pgo_{p}["))
             for p in ("build", "gn", "apply")}
    check(calls == {"build": runs, "gn": gn_iters, "apply": runs},
          f"PGO graph calls {calls}, relaxations {runs}, Gauss-Newton "
          f"iterations {gn_iters}")
    out = dict(backend_t)
    out.update({f"vo_step_{k}": v for k, v in vo_t.items()})
    out.update({f"slam_step_{k}": v for k, v in slam_t.items()})
    for tag, st in (("vo_step", vo_stats), ("slam_step", sg.stats())):
        out.update({f"{tag}_graph_{k}": st[k]
                    for k in ("capture_seconds", "nodes", "pool_bytes")})
    out.update(graphs_vo_frames_per_s=(f - 1) / t_graph,
               graphs_slam_frames_per_s=(sf - 1) / gt_loop,
               graphs_slam_eager_frames_per_s=(sf - 1) / et_loop)
    return out


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


def flow_eager(cfg, cam, lefts, rights):
    """The flow VO as a loop of eager vo_step calls from SEED (the draws
    run_sequence makes from the same seed): (final state, poses (F-1,4,4),
    metrics stacked over F-1, host seconds of the loop after init_state,
    ending in a synchronize)."""
    st = vo_flow.init_state(lefts[0], rights[0], cam, cfg, SEED)
    poses, ms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, lefts.shape[0]):
        st, m = vo_flow.vo_step(st, lefts[i], rights[i], cam, cfg)
        poses.append(st.T_w_cam)
        ms.append(m)
    torch.cuda.synchronize()
    return st, torch.stack(poses), vo_flow.FlowVOMetrics(
        *[torch.stack(v) for v in zip(*ms)]), time.perf_counter() - t0


def phase_flow(cfg, world, lefts, rights, dev, vo_ate, late):
    """The second VO frontend (FAST corners, pyramidal LK, dense SGM
    disparity, RANSAC-PnP) over the arc clip on CUDA tensors, the launch
    counters reset just before: run_sequence replays one CUDA graph of
    the step per frame. Then the graphed run against a loop of eager
    vo_step calls with the same draws (to the bit); the first frames on
    CPU tensors against CUDA with the same draws; its times, eager and
    graphed (its profiler sessions go into `late`)."""
    f, cam = lefts.shape[0], world.cam
    gt = world.poses.cpu().numpy()
    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, metrics = vo_flow.run_sequence(lefts, rights, cam, cfg, seed=SEED)
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

    # Graphed against eager: the same seed, so the same draws. The graph
    # kept for the times below is run_sequence's own path.
    cuda_kernels.reset_launch_counts()
    es, e_poses, e_metrics, t_eager = flow_eager(cfg, cam, lefts, rights)
    counts_e = cuda_kernels.launch_counts()
    cuda_kernels.reset_launch_counts()
    gs, graph, g_poses, g_metrics = vo_flow._run_graphed(
        vo_flow.init_state(lefts[0], rights[0], cam, cfg, SEED), lefts,
        rights, cam, cfg)
    counts_g = cuda_kernels.launch_counts()
    seq = (torch.as_tensor(poses[1:]),
           [torch.as_tensor(np.stack([getattr(m, k) for m in metrics]))
            for k in vo_flow.FlowVOMetrics._fields])
    flow_diff = (tree_diff((e_poses, e_metrics, tuple(es)[:-2],
                            es.generator.get_state(), es.frame),
                           (g_poses, g_metrics, tuple(gs)[:-2],
                            gs.generator.get_state(), gs.frame), "flow")
                 + tree_diff((e_poses.cpu(), [v.cpu() for v in e_metrics]),
                             seq, "run_sequence"))
    say("flow-graph", differing=flow_diff, launches_eager=counts_e,
        launches_graph=counts_g, eager_loop_seconds=f"{t_eager:.3f}",
        **graph.stats())
    check(not flow_diff, f"the graphed flow VO differs from the vo_step "
          f"loop: {flow_diff}")
    check(counts_e == counts_g == want,
          f"flow launch counts: eager {counts_e}, graphed {counts_g}")
    check(graph.replays == f - 2, f"{graph.replays} flow replays, not "
          f"one per frame after the first")

    # CPU (plain path) vs CUDA (kernel) on the first frames, same draws.
    n = vo_flow._detect_corners(lefts[0], cfg)[0].shape[0]
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    draws = [draw_uniform(cfg.tracking.ransac_iters, n, g, "cpu")
             for _ in range(CPU_FRAMES - 1)]
    t0 = time.perf_counter()
    p_cpu, m_cpu = vo_flow.run_sequence(
        lefts[:CPU_FRAMES].cpu(), rights[:CPU_FRAMES].cpu(),
        cam.to("cpu"), cfg, draws=draws)
    cpu_secs = time.perf_counter() - t0
    p_gpu, m_gpu = vo_flow.run_sequence(
        lefts[:CPU_FRAMES], rights[:CPU_FRAMES], cam, cfg,
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

    # Warm times: one step eager and graphed, the graphed per-frame loop
    # (the eager one is flow_eager's), the two dense stages.
    k = cfg.tracking.ransac_iters
    carry = tuple(gs)[:-2]
    flow_u = draw_uniform(k, n, gs.generator, dev)
    step_t = step_times(
        "flow_vo_step",
        lambda: vo_flow.vo_step(es, lefts[5], rights[5], cam, cfg),
        lambda: graph(carry, lefts[5], rights[5], flow_u), late,
        reps=FLOW_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, f):
        u = draw_uniform(k, n, gs.generator, dev)
        carry, _ = graph(carry, lefts[i], rights[i], u)
    torch.cuda.synchronize()
    fps, eager_fps = (f - 1) / (time.perf_counter() - t0), (f - 1) / t_eager
    disp, track = flow_stage(cfg, lefts, rights)
    disp_ms = event_ms(disp, reps=5, warm=1)
    lk_ms = event_ms(track, reps=10, warm=2)
    d = cfg.disparity
    stats = graph.stats()
    say("flow-times", flow_frames_per_s=fps, flow_eager_frames_per_s=eager_fps,
        run_sequence_frames_per_s=(f - 1) / secs, **step_t,
        disparity_ms=disp_ms, lk_track_ms=lk_ms, max_disp=d.max_disp,
        radius=d.radius, sgm_columns=cfg.image.width,
        lk=dataclasses.asdict(cfg.flow))
    check(math.isfinite(fps) and fps > 0, "flow fps not measured")

    def profiled():
        """Device-busy ms and launches of the two dense stages; the
        disparity is timed again after the sessions, against its time
        before any session."""
        out = dict(flow_disparity_device_busy_ms=device_busy_ms(disp, reps=2),
                   flow_disparity_launches=device_launches(disp),
                   flow_lk_track_launches=device_launches(track),
                   flow_disparity_ms_after_profiler=event_ms(disp, reps=5,
                                                             warm=1))
        say("flow-profile", **out)
        return out
    late.append(profiled)
    return counts, dict(
        flow_frames_per_s=fps, flow_eager_frames_per_s=eager_fps,
        flow_run_sequence_frames_per_s=(f - 1) / secs, flow_ate_m=ate,
        flow_pnp_ok_share=ok_share,
        **{f"flow_vo_step_{k}": v for k, v in step_t.items()},
        **{f"flow_vo_step_graph_{k}": stats[k]
           for k in ("capture_seconds", "nodes", "pool_bytes")},
        flow_disparity_ms=disp_ms, flow_lk_track_ms=lk_ms)


def run_together(cmds, timeout=900):
    """`python cmd...` from the repo root for each cmd of `cmds`, all
    started together: (exit code, stdout, stderr, seconds) of each, in
    order. The others are killed when one runs past `timeout`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *cmd], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(
                timeout=max(timeout - (time.perf_counter() - t0), 1.0))
            out.append((p.returncode, so, se, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def slam_torch(*argv, timeout=900):
    """`python -m slam1_tpu_torch.cli argv...` in a subprocess from the
    repo root, as a user runs it: (its last stdout line as JSON, the
    kernel launch counts it printed on stderr, seconds, its stderr)."""
    return slam_torch_together([argv], timeout)[0]


def slam_torch_together(argvs, timeout=900):
    """slam_torch for each argv of `argvs`, all started together (for
    calls whose times are not reported): their results in order."""
    return [_cli_result(argv, *res) for argv, res in zip(argvs, run_together(
        [("-m", "slam1_tpu_torch.cli", *argv) for argv in argvs], timeout))]


def _cli_result(argv, rc, stdout, stderr, secs):
    check(rc == 0, f"slam-torch {' '.join(argv)} exited {rc}: "
          f"{stderr[-3000:]}")
    launches = [json.loads(line)["kernel_launches"]
                for line in stderr.splitlines()
                if line.startswith('{"kernel_launches"')]
    decoder = [line.split(": ", 1)[1] for line in stderr.splitlines()
               if line.startswith("decoder: ")]
    out = json.loads(stdout.strip().splitlines()[-1])
    say("cli-call", args=" ".join(tuple(argv[:1]) + tuple(
        a for a in argv[1:] if a.startswith("--"))),
        seconds=f"{secs:.3f}", launches=launches[-1] if launches else None,
        decoder=decoder[-1] if decoder else None,
        result={k: v for k, v in out.items() if k != "timing"})
    return out, (launches[-1] if launches else None), secs, stderr


def phase_cli(world, lefts, rights, tmp):
    """The user's entry points on a KITTI-layout sequence: the first
    CLI_FRAMES of the loop2 clip cropped to KITTI's image size, written
    as 8-bit grayscale PNG (P5 PGM where the native decoder does not
    build: a machine may have neither cv2 nor PIL), then
    `slam-torch run` (SLAM, checkpoints, metrics) in a subprocess, then
    `run --vo-only`, `eval`, `ba --state`, `ba` (on the run's float32
    trajectory and on a float64 copy, as np.save writes one) and `run
    --multihost` in subprocesses started together."""
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

    # `run` alone (its frames/s is reported), then every other call
    # together (they are checked, not timed).
    traj = os.path.join(tmp, "traj.npy")
    ckdir = os.path.join(tmp, "ckpt")
    mpath = os.path.join(tmp, "metrics.jsonl")
    run, counts, run_s, _ = slam_torch(
        "run", "--data", root, "--poses", poses_txt, "--out", traj,
        "--metrics", mpath, "--checkpoint-every", str(CLI_CKPT_EVERY),
        "--checkpoint-dir", ckdir)
    fps = run["timing"]["frames_per_s"]
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
    ckpts = sorted(glob.glob(os.path.join(ckdir, "*.npz")))
    check(len(ckpts) > 0, "`run --checkpoint-every` wrote no checkpoint")

    vo_npy = os.path.join(tmp, "vo.npy")
    traj64 = os.path.join(tmp, "traj64.npy")
    np.save(traj64, np.load(traj).astype(np.float64))
    # `run --multihost` as one process of a world of one: the plain run.
    plain_npy, multi_npy = (os.path.join(tmp, x) for x in ("p.npy", "m.npy"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ((out, vo_launches, _, _), (ev, _, _, _), (bs, _, _, _),
     (bd, _, _, bd_err), (bt, _, _, _), _, (_, _, _, mh_err),
     (bt64, _, _, _)) = \
        slam_torch_together([
            ("run", "--data", root, "--poses", poses_txt, "--vo-only",
             "--out", vo_npy),
            ("eval", traj, poses_txt),
            ("ba", "--state", ckpts[-1], "--out",
             os.path.join(tmp, "opt_state.npy")),
            ("ba", "--state", ckpts[-1], "--distributed", "--lm-shards", "1",
             "--out", os.path.join(tmp, "opt_dist.npy")),
            ("ba", traj, "--out", os.path.join(tmp, "opt_traj.npy")),
            ("run", "--synthetic", str(MULTIHOST_FRAMES), "--out",
             plain_npy),
            ("run", "--synthetic", str(MULTIHOST_FRAMES), "--out",
             multi_npy, "--multihost", "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", "1",
             "--process-id", "0"),
            ("ba", traj64, "--out", os.path.join(tmp, "opt_traj64.npy"))])
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
    check(ev["ate_rmse_m"] == run["ate_rmse_m"],
          f"`eval` ATE {ev['ate_rmse_m']} != `run`'s {run['ate_rmse_m']}")
    check(bs["keyframes"] > 0 and math.isfinite(bs["final_cost"]),
          f"`ba --state` line {bs}")
    say("cli-ba-distributed", result=bd,
        backend_line=[ln for ln in bd_err.splitlines()
                      if ln.startswith("torch.distributed")])
    check(bd["keyframes"] == bs["keyframes"]
          and math.isfinite(bd["final_cost"]) and bd["dropped_obs"] == 0
          and bd["mesh"] == {"batch": 1, "lm": 1},
          f"`ba --state --distributed` line {bd}")
    check(bt["frames"] == f and math.isfinite(bt["final_cost"]),
          f"`ba` line {bt}")
    opt32, opt64 = (np.load(os.path.join(tmp, x))
                    for x in ("opt_traj.npy", "opt_traj64.npy"))
    d64 = float(np.abs(opt64 - opt32).max())
    say("cli-ba-float64", result=bt64, dtype=str(opt64.dtype),
        max_abs_diff_to_float32_file=d64)
    check(bt64["frames"] == f and math.isfinite(bt64["final_cost"])
          and opt64.dtype == np.float32 and d64 <= BA_TOL,
          f"`ba` on a float64 trajectory: line {bt64}, {opt64.dtype}, "
          f"{d64} off the float32 file's result")
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
                        cli_ba_distributed_final_cost=bd["final_cost"],
                        cli_ba_traj_float64_max_abs_diff=d64)


def phase_bench():
    """`slam-torch bench` as a user runs it: its last line has the root
    bench.py's keys, a positive SLAM and VO rate, the 600-frame loop2
    clip, and at `SlamConfig()` unchanged (asynchronous drain) an ATE
    under BENCH_ATE_M with at least BENCH_LOOPS loop closures. Its
    launches: fast_score once and hamming_top2 twice per VO or SLAM
    frame (one per bootstrap), over the VO clip's warm and timed blocks
    and both SLAM passes."""
    from slam1_tpu_torch import bench
    line, counts, secs, err = slam_torch("bench", timeout=900)
    steps = bench.N_FRAMES - 1
    vo_frames = steps * (max(bench.VO_STEPS // steps, 1) + 1)
    f = bench.SLAM_FRAMES
    want = {"fast_score": 1 + vo_frames + 2 * f,
            "hamming_top2": 1 + 2 * vo_frames + 2 * (2 * f - 1)}
    say("bench", seconds=f"{secs:.3f}", line=line, launches=counts,
        expected=want, stderr=[ln for ln in err.splitlines()
                               if ln.startswith("bench:")])
    check(tuple(line) == BENCH_KEYS, f"bench keys {list(line)}")
    check(line["value"] is not None and line["value"] > 0
          and line["vo_frames_per_s_per_chip"] is not None
          and line["vo_frames_per_s_per_chip"] > 0,
          f"bench rates {line['value']}, {line['vo_frames_per_s_per_chip']}")
    check(line["data"] == f"synthetic-loop2-{f}", f"bench data {line['data']}")
    check(line["ate_rmse_m"] is not None
          and math.isfinite(line["ate_rmse_m"])
          and line["ate_rmse_m"] < BENCH_ATE_M,
          f"bench ATE {line['ate_rmse_m']} m, bound {BENCH_ATE_M}")
    check(line["loop_closures"] >= BENCH_LOOPS,
          f"bench loop closures {line['loop_closures']} < {BENCH_LOOPS}")
    check(counts is not None
          and {k: counts[k] for k in want} == want
          and counts["hamming_top2_batched"] > 0
          and counts["chain_sweep"] > 0,
          f"bench launches {counts}, expected {want}")
    return counts, dict(bench_slam_frames_per_s=line["value"],
                        bench_vo_frames_per_s=line["vo_frames_per_s_per_chip"],
                        bench_ate_m=line["ate_rmse_m"],
                        bench_loop_closures=line["loop_closures"],
                        bench_vs_baseline=line["vs_baseline"],
                        bench_ref_ate_m=line["ref_ate_rmse_m"],
                        bench_seconds=secs)


def run_tools(calls, timeout=600):
    """`python tools/<script> argv...` for each (script, argv) of
    `calls`, all started together: for each its last stdout line as
    JSON and its seconds. Each must exit 0: each tool checks its own
    results."""
    out = []
    for (script, argv), (rc, so, se, secs) in zip(calls, run_together(
            [(os.path.join("tools", script), *argv)
             for script, argv in calls], timeout)):
        check(rc == 0, f"{script} {' '.join(argv)} exited {rc}: "
              f"{se[-3000:]}")
        out.append((json.loads(so.strip().splitlines()[-1]), secs))
    return out


def phase_tools(tmp):
    """Each measurement tool over the port in its own process at a small
    depth: the global-BA scale run on TOOLS_FRAMES frames with its
    checkpoint; then, started together (they check results and time
    nothing that is reported), the distributed BA on it at one rank
    (NCCL) and at two ranks sharing the card (gloo), the loop grid at
    one hit and the two-process smoke; then, one at a time, the roofline
    and the per-stage profile."""
    ckpt = os.path.join(tmp, f"gba{TOOLS_FRAMES}.npz")
    times_s = {}
    ((gba, times_s["global_ba_scale"]),) = run_tools([(
        "port_global_ba_scale.py",
        ["--frames", str(TOOLS_FRAMES), "--ckpt", ckpt])])
    say("tools-global-ba-scale", seconds=f"{times_s['global_ba_scale']:.3f}",
        record=gba)
    check(gba["backend"] == "cuda" and gba["frames"] == TOOLS_FRAMES
          and gba["keyframes"] > 0 and gba["bucket"] >= gba["keyframes"]
          and math.isfinite(gba["cost_after"])
          and gba["cost_after"] <= gba["cost_before"],
          f"port_global_ba_scale record {gba}")
    t0 = time.perf_counter()
    (d1, _), (d2, _), (grid, _), (mh, _) = run_tools([
        ("port_dist_ba_scale.py", ["--ckpt", ckpt, "--ranks", "1"]),
        ("port_dist_ba_scale.py", ["--ckpt", ckpt, "--ranks", "2"]),
        ("port_loop_grid.py", ["--ckpt", ckpt, "--frames", str(TOOLS_FRAMES),
                               "--hits", str(TOOLS_FRAMES - 1),
                               "--span", "2"]),
        ("port_multihost_smoke.py", [])])
    times_s["dist_grid_multihost_together"] = time.perf_counter() - t0
    for ranks, backend, mode, rec in ((1, "nccl", "graphed", d1),
                                      (2, "gloo", "eager", d2)):
        say("tools-dist-ba-scale", ranks=ranks, dist_mode=rec["dist_mode"],
            single_mode=rec["single_mode"], record=rec)
        check(rec["shards"] == ranks and rec["backend"] == backend
              and rec["dist_mode"] == mode
              and rec["n_dropped"] == 0 and rec["rel_cost_parity"] < 5e-2
              and rec["keyframes"] == gba["keyframes"],
              f"port_dist_ba_scale at {ranks} ranks: {rec}")
    say("tools-loop-grid", record=grid)
    check(len(grid["hits"]) == 1 and grid["hits"][0]["cands"],
          f"port_loop_grid record {grid}")
    say("tools-multihost-smoke", record=mh)
    check(mh["ok"] and mh["processes"] == 2 and all(
        c["backend"] == "gloo" and c["ba_parity_terr"] < 5e-3
        for c in mh["children"]), f"port_multihost_smoke record {mh}")
    ((roof, times_s["roofline"]),) = run_tools([("port_roofline.py", [])])
    say("tools-roofline", seconds=f"{times_s['roofline']:.3f}", record=roof)
    check(roof["backend"] == "cuda" and len(roof["kernels"]) == 4 and all(
        math.isfinite(k["time_us"]) and k["time_us"] > 0
        for k in roof["kernels"]), f"port_roofline record {roof}")
    ((prof, times_s["profile_stage"]),) = run_tools([
        ("port_profile_stage.py", ["--reps", "5"])])
    say("tools-profile-stage", seconds=f"{times_s['profile_stage']:.3f}",
        record=prof)
    check(all(math.isfinite(v) and v > 0
              for v in prof["stages_ms"].values()),
          f"port_profile_stage record {prof}")
    return dict(tools_seconds=times_s,
                tools_global_ba_keyframes=gba["keyframes"],
                tools_global_ba_wall_s=gba["global_ba_wall_s"],
                tools_dist_ba_parity_1_2_ranks=[d1["rel_cost_parity"],
                                                d2["rel_cost_parity"]],
                tools_roofline_pct_of_bound={
                    k["kernel"]: k["pct_of_peak"] for k in roof["kernels"]},
                tools_vo_step_ms=prof["stages_ms"]["vo_step (full)"])


def time_kernel(name, plain, kern, bound_ms, bound_by, plain_reps=10,
                per=None):
    """Times of one kernel's unit of work (`per`, by default the
    KERNELS entry's), in turns plain, kernel, kernel, plain: `ms` the
    device time (CUDA graph replay), `eager_ms` the wrapper called
    eagerly, `plain_ms` the plain twin (eager), and the share of the
    bound that `ms` reaches."""
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
    say("times", kernel=name, per=per or KERNELS[name][2],
        kernel_ms=out["ms"], eager_ms=out["eager_ms"],
        plain_ms=out["plain_ms"], bound_us=1e3 * bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / out["ms"])
    return out


def phase_times_slam(cfg, sys_, world, lefts, rights):
    """ms per place_query, slate and PGO on the final SLAM state, the
    backend's kernels against their plain twins, and the per-stage host
    times of a pass of the clip with its spans recorded."""
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
    metrics.clear()
    with metrics.recording():
        run_slam(cfg, world, lefts, rights)
    host = _span_ms(metrics.recorded())
    metrics.clear()
    pgo = host.get("host:slam.pgo", [])

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
    # The kernels as the PGO graphs launch them: the live count a device
    # scalar.
    cargs = [x.to(dev)
             for x in synthetic.chain_inputs(CHAIN_F, CHAIN_LIVE, 1)]
    live = device_live(CHAIN_LIVE, dev)
    prep = cuda_kernels.chain_prepare_cuda(cargs[0], cargs[1], live)
    times["chain_prepare"] = time_kernel(
        "chain_prepare",
        lambda: cuda_kernels.chain_prepare_plain(cargs[0], cargs[1],
                                                 CHAIN_LIVE),
        lambda: cuda_kernels.chain_prepare_cuda(cargs[0], cargs[1], live),
        *bound_chain_prepare(CHAIN_F, CHAIN_LIVE,
                             cuda_kernels.CHAIN_LEVELS))
    times["chain_sweep"] = time_kernel(
        "chain_sweep",
        lambda: cuda_kernels.chain_sweep_plain(*cargs, CHAIN_LIVE),
        lambda: cuda_kernels.chain_sweep_cuda(*cargs, live, prep=prep),
        *bound_chain_sweep(CHAIN_F, CHAIN_LIVE), plain_reps=3)
    stage = {k: (float(np.median(v)) if v else None, len(v))
             for k, v in ((k, host.get(f"host:slam.{k}", []))
                          for k in ("place_query", "pgo"))}
    live = pgo[:-1]
    say("times-slam", place_query_ms=pq_ms, place_query_rows=n_rows,
        slate_ms=slate_ms, slate_pairs=len(pairs),
        pgo_ms_median_live=float(np.median(live)) if live else None,
        pgo_ms_live=live, pgo_runs=len(pgo),
        pgo_ms_finalize=pgo[-1] if pgo else None,
        pgo_graphs=sorted(n for n in sys_.backend_graphs
                          if n.startswith("pgo_")),
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

    # The chain sweep past the rows whose offsets fit in shared memory
    # (the trajectory mode's longest chain, offsets in device memory),
    # beside the shared-memory path at its most rows.
    n, most = TRAJ_POSES[-1], cuda_kernels.build().chain_max_live
    dev = lefts.device
    largs = [x.to(dev) for x in synthetic.chain_inputs(n, n, 1)]
    lprep = cuda_kernels.chain_prepare_cuda(largs[0], largs[1], n)
    row = time_kernel(
        "chain_sweep",
        lambda: cuda_kernels.chain_sweep_plain(*largs, n),
        lambda: cuda_kernels.chain_sweep_cuda(*largs, n, prep=lprep),
        *bound_chain_sweep(n, n), plain_reps=1,
        per=f"one launch, {n} poses, all live, offsets in device memory")
    xk = cuda_kernels.chain_sweep_cuda(*largs, n, prep=lprep)
    xp = cuda_kernels.chain_sweep_plain(*largs, n)
    err = (xk - xp).abs().max().item()
    scale = max(xp.abs().max().item(), 1e-30)
    sargs = [x[:most] for x in largs]
    sprep = cuda_kernels.chain_prepare_cuda(sargs[0], sargs[1], most)
    shared_ms = graph_ms(
        lambda: cuda_kernels.chain_sweep_cuda(*sargs, most, prep=sprep))
    row.update(poses=n, staged=cuda_kernels.chain_sweep_staged(n),
               max_abs_err=err, max_rel_err=err / scale,
               shared_memory_path_ms=shared_ms, shared_memory_poses=most)
    say("times", kernel="chain_sweep", poses=n, staged=row["staged"],
        max_rel_err=err / scale, shared_memory_path_ms=shared_ms,
        shared_memory_poses=most)
    check(row["staged"] and bool(torch.isfinite(xk).all())
          and err <= CHAIN_TOL * scale,
          f"chain_sweep at {n} poses: staged {row['staged']}, |err| {err} "
          f"vs scale {scale}")
    times["chain_sweep_long"] = row

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


def dist_graph_mode(mesh, x):
    """How the sharded solvers run for tensors like x on this mesh:
    "graphed" (a card under NCCL) or "eager (<backend>)"."""
    return ("graphed" if graph_mod.graphed(x, mesh)
            else f"eager ({mesh.backend})")


def solver_graphs(tag, names, *kinds):
    """{base name: StepGraph} of the graph registry's graphs of `kinds`,
    checked to be one graph of each base in `names`."""
    found = {}
    for kind in kinds:
        for g in GRAPHS.of(kind).values():
            found.setdefault(g.name.split("[", 1)[0], []).append(g)
    held = [g.name for v in found.values() for g in v]
    check(sorted(found) == sorted(names)
          and all(len(v) == 1 for v in found.values()),
          f"{tag}: the registry holds {held}, not one graph of each of "
          f"{names}")
    return {n: v[0] for n, v in found.items()}


def dist_graph_runs(tag, call, kind, names, iters, mesh, smi):
    """A sharded solver at one rank, as phase global-ba holds global BA:
    two eager calls (`call(False)`), then two graphed ones (the first
    captures `names`, the second replays them: the iteration graph
    `iters` times, the end graph once); each timed on the host clock
    ending in a synchronize, with its `mesh.comm` and kernel launches;
    then the host syncs of a warm graphed call. Graphed is held to eager
    to the bit where the two eager calls are equal to the bit, else to
    their spread. Returns (graphed result, eager result, what is said)."""
    def run(graphs):
        mesh.comm.update({k: 0 for k in mesh.comm})
        cuda_kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call(graphs)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / iters
        return res, ms, dict(mesh.comm), cuda_kernels.launch_counts()

    GRAPHS.clear(kind)
    eager, eager_ms, comm, launches = run(False)
    eager2, eager2_ms, comm2, launches2 = run(False)
    captured, capture_ms, comm_c, launches_c = run(True)
    graphs = solver_graphs(tag, names, kind)
    replays = [graphs[n].replays for n in names]
    graphed, graph_ms, comm_g, launches_g = run(True)
    check([graphs[n].replays - r for n, r in zip(names, replays)]
          == [iters, 1] and solver_graphs(tag, names, kind) == graphs,
          f"{tag}: the second graphed call was not {iters} replays of "
          f"{names[0]} and one of {names[1]}")
    syncs, where = count_syncs(lambda: call(True))
    eager_diff = tree_diff(eager, eager2, "eager")
    spread = max_abs_diff(eager, eager2)
    graph_diff = tree_diff(eager, graphed, tag) + tree_diff(
        eager, captured, tag)
    graph_spread = max(max_abs_diff(eager, graphed),
                       max_abs_diff(eager, captured))
    said = dict(
        card=smi, dist_mode=dist_graph_mode(mesh, flatten(eager)[0]),
        ms_per_iteration_eager=[eager_ms, eager2_ms],
        ms_per_iteration_graphed=graph_ms,
        ms_per_iteration_capture_call=capture_ms,
        eager_vs_eager_differing=eager_diff, eager_vs_eager_max_abs=spread,
        graph_vs_eager_differing=graph_diff,
        graph_vs_eager_max_abs=graph_spread, graph_warm_call_syncs=syncs,
        comm_eager=comm, comm_eager2=comm2, comm_capture_call=comm_c,
        comm_graphed=comm_g, launches_eager=launches,
        launches_graphed=launches_g,
        **{f"{n}_{k}": v for n in names for k, v in graphs[n].stats().items()
           if k != "launches_per_replay"},
        **{f"{n}_comm_per_replay": graphs[n].counted for n in names})
    say(f"{tag}-graphs", **said)
    check(said["dist_mode"] == "graphed",
          f"{tag}: one rank over NCCL ran {said['dist_mode']}")
    check(syncs == 0, f"{tag}: a warm graphed call made host syncs: {where}")
    check(comm == comm2 == comm_c == comm_g,
          f"{tag}: graphed calls counted other collectives than eager "
          f"ones: {comm} {comm2} {comm_c} {comm_g}")
    check(launches == launches2 == launches_c == launches_g,
          f"{tag}: graphed calls launched other kernels than eager ones: "
          f"{launches} {launches_g}")
    if not eager_diff:
        check(not graph_diff, f"{tag}: graphed differs from eager "
              f"({graph_spread} at most): {graph_diff}")
    else:
        check(graph_spread <= spread, f"{tag}: graphed {graph_spread} off "
              f"eager, beyond the eager calls' spread {spread}")
    return graphed, eager, said


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
        # Ranks sharing the card run gloo, which no graph can hold.
        dist_mode = dist_graph_mode(mesh, sharded.uv)
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
            dist_mode=dist_mode, device=str(dev),
            launches=cuda_kernels.launch_counts()), f"{out_path}.{rank}")
    finally:
        parallel.clear_graphs()
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


def phase_dist(cfg, sys_, world, tmp, smi):
    """The distributed layer on the finished 600-frame state: the
    partitioners, the sharded BA at one rank over NCCL (this process;
    eager twice, then its captured graphs, held to the eager calls)
    against the single-device BA, at two ranks sharing the card over
    gloo (spawned, eager) against one rank, and the sharded pose graph
    likewise at one and two ranks against posegraph.optimize."""
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
        sharded, cam, dataclasses.replace(cfg.ba, lm_iters=1), mesh,
        graphs=False)
    dist_pgo.optimize_sharded(*pargs, mesh=mesh, iters=1, cg_iters=1,
                              n_live=g["n_live"], graphs=False)
    # Eager twice, graphed twice (captured, then replayed): the graphed
    # result is the one checked below.
    (out1, cost1, trace1), _, ba_said = dist_graph_runs(
        "dist-ba-1", lambda graphs: dist_ba.distributed_bundle_adjust(
            sharded, cam, cfg.ba, mesh, return_trace=True, graphs=graphs),
        "dist_ba", ("dba_lm", "dba_cost"), iters, mesh, smi)
    d_ms = ba_said["ms_per_iteration_graphed"]
    d_eager_ms = min(ba_said["ms_per_iteration_eager"])
    ba_comm = ba_said["comm_graphed"]

    # The single-device baseline as the reference runs it (graphs: the
    # first call captures, the second is timed) and op by op.
    def single(graphs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ba.bundle_adjust(prob, cam, cfg.ba, return_trace=True,
                               graphs=graphs)
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0) / iters

    ba.BA_GRAPHS.clear()
    eager_single, s_eager_ms = single(False)
    _, s_capture_ms = single(True)
    (outs, costs, traces), s_ms = single(True)
    single_diff = tree_diff(eager_single, (outs, costs, traces), "single")
    ba.BA_GRAPHS.clear()
    check(not single_diff, f"graphed bundle_adjust differs from eager: "
          f"{single_diff}")
    rows = torch.arange(bucket, device=prob.poses.device) < n_kf
    frames = sys_.state.kf.frame_of_row[:bucket][rows].long().cpu().numpy()

    def kf_ate(poses):
        return ate_rmse(poses[rows].cpu().numpy(), gt[frames], align=False)

    ate0, ate1, ate_s = kf_ate(prob.poses), kf_ate(out1.poses), kf_ate(
        outs.poses)
    t1, ts = trace1.cpu().numpy(), traces.cost.cpu().numpy()
    trace_rel = float(np.max(np.abs(t1 - ts) / np.maximum(np.abs(ts), 1.0)))
    cg_steps = iters * (cfg.ba.cg_iters + 1)
    ba_bytes_per_cg_step = ba_comm["all_reduce_bytes"] / cg_steps
    say("dist-ba-1", backend=backend, keyframes=n_kf, camera_rows=bucket,
        observations=n_obs, lm_iters=iters, cost=float(cost1),
        cost_single=float(costs), trace=t1.tolist(), trace_single=ts.tolist(),
        trace_max_rel_diff=trace_rel, kf_ate_before_m=ate0,
        kf_ate_after_m=ate1, kf_ate_single_m=ate_s,
        dist_mode=ba_said["dist_mode"], ms_per_lm_iteration=d_ms,
        ms_per_lm_iteration_eager=ba_said["ms_per_iteration_eager"],
        ms_per_lm_iteration_single=s_ms,
        single_timed="graphed (CUDA graph replays)",
        ms_per_lm_iteration_single_eager=s_eager_ms,
        ms_per_lm_iteration_single_capture_call=s_capture_ms,
        single_graph_vs_eager_differing=single_diff,
        all_reduce_calls=ba_comm["all_reduce_calls"],
        all_reduce_bytes_per_cg_step=ba_bytes_per_cg_step,
        all_reduce_bytes_total=ba_comm["all_reduce_bytes"],
        cg_steps=cg_steps, launches=ba_said["launches_graphed"])
    check(math.isfinite(float(cost1)) and trace_rel <= DIST_TRACE_TOL,
          f"distributed BA trace {trace_rel} relative off bundle_adjust")
    check(ate1 <= 1.05 * ate0, f"distributed BA keyframe ATE {ate0} -> "
          f"{ate1}")

    # (d) the pose graph at one rank, against posegraph.optimize, at the
    # live relaxation's Gauss-Newton count
    pg_it, pg_cg = max(cfg.ba.pg_iters // 5, 3), cfg.ba.cg_iters
    (p1, pc1), _, pgo_said = dist_graph_runs(
        "dist-pgo-1", lambda graphs: dist_pgo.optimize_sharded(
            *pargs, mesh=mesh, iters=pg_it, cg_iters=pg_cg,
            n_live=g["n_live"], graphs=graphs),
        "dist_pgo", ("dpg_gn", "dpg_cost"), pg_it, mesh, smi)
    p_ms = pgo_said["ms_per_iteration_graphed"]
    counts1 = pgo_said["launches_graphed"]
    pgo_comm = pgo_said["comm_graphed"]
    graph = posegraph.PoseGraph(*[x.to(mesh.device) for x in pgo_graph(g)])
    ps, pcs = posegraph.optimize(graph, iters=pg_it, cg_iters=pg_cg,
                                 n_live=g["n_live"])
    GRAPHS.clear("posegraph")
    parallel.clear_graphs()
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
        dist_mode=pgo_said["dist_mode"], ms_per_gn_iteration=p_ms,
        ms_per_gn_iteration_eager=pgo_said["ms_per_iteration_eager"],
        launches=counts1, expected=want,
        all_reduce_bytes_per_cg_step=pgo_comm["all_reduce_bytes"] / cg_total,
        p2p_calls=pgo_comm["p2p_calls"])
    check({k: counts1[k] for k in want} == want
          and {k: pgo_said["launches_eager"][k] for k in want} == want,
          f"sharded PGO launches {counts1} (eager "
          f"{pgo_said['launches_eager']}) != {want}")
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
        say("dist-rank", rank=r, backend=rr["backend"],
            dist_mode=rr["dist_mode"], device=rr["device"],
            ba_seconds=f"{rr['ba_s']:.3f}", pgo_seconds=f"{rr['pgo_s']:.3f}",
            dropped=rr["dropped"], launches=rr["launches"],
            ba_comm=rr["ba_comm"], pgo_comm=rr["pgo_comm"])
        check(rr["backend"] == "gloo" and rr["dropped"] == 0
              and rr["dist_mode"] == "eager (gloo)",
              f"rank {r}: backend {rr['backend']} ({rr['dist_mode']}), "
              f"dropped {rr['dropped']}")
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
        dist_ba_ms_per_lm_iteration=d_ms,
        dist_ba_ms_per_lm_iteration_eager=d_eager_ms,
        dist_ba_trace_max_rel_diff=trace_rel,
        dist_single_ba_ms_per_lm_iteration_graph=s_ms,
        dist_single_ba_ms_per_lm_iteration_eager=s_eager_ms,
        dist_ba_2_rank_cost_rel_diff=cost_rel,
        dist_ba_all_reduce_bytes_per_cg_step=ba_bytes_per_cg_step,
        dist_pgo_ms_per_gn_iteration=p_ms,
        dist_pgo_ms_per_gn_iteration_eager=min(
            pgo_said["ms_per_iteration_eager"]),
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
    if "graphs" in phases:
        t0 = time.perf_counter()
        numbers.update(phase_graphs(cfg, world, lefts, rights, bcfg, sworld,
                                    slefts, srights, late))
        phase_s["graphs"] = time.perf_counter() - t0
    if "slam-ba" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            sys_, post_ba, by_path["slam_ba"], ckpt, slam_ba = phase_slam_ba(
                bcfg, sworld, slefts, srights, slam, tmp, late)
            numbers.update(slam_ba)
            if "checkpoint" in phases:
                numbers.update(phase_checkpoint(
                    bcfg, sworld, slefts, srights, ckpt, post_ba,
                    (slam_ba["slam_ba_ate_before_m"],
                     slam_ba["slam_ba_ate_after_m"])))
    if "global-ba" in phases:
        by_path["global_ba"], gba_times, gba_errs, gba = phase_global_ba(
            bcfg, sys_, sworld, smi)
        numbers.update(gba)
        times.update(gba_times)
        keep_worst(errs, rel_errs, gba_errs)
    if "traj-ba" in phases:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            traj_paths, traj_numbers = phase_traj_ba(smi, dev, tmp)
        by_path.update(traj_paths)
        numbers.update(traj_numbers)
        phase_s["traj-ba"] = time.perf_counter() - t0
    if "bal" in phases:
        t0 = time.perf_counter()
        bal_times, bal_errs, bal_numbers = phase_bal(dev)
        times.update(bal_times)
        keep_worst(errs, rel_errs, bal_errs)
        numbers.update(bal_numbers)
        phase_s["bal"] = time.perf_counter() - t0
    if "ref-backend" in phases:
        t0 = time.perf_counter()
        numbers.update(phase_ref_backend(sys_, dev))
        phase_s["ref-backend"] = time.perf_counter() - t0
    if "dist" in phases:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            dist_paths, dist_numbers = phase_dist(bcfg, sys_, sworld, tmp,
                                                    smi)
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
    if "bench" in phases:
        t0 = time.perf_counter()
        by_path["bench"], bench_numbers = phase_bench()
        numbers.update(bench_numbers)
        phase_s["bench"] = time.perf_counter() - t0
    if "tools" in phases:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            numbers.update(phase_tools(tmp))
        phase_s["tools"] = time.perf_counter() - t0
    if "times" in phases:
        new_times, fps = phase_times(cfg, lefts, rights, world,
                                     hamming_inputs)
        times.update(new_times)
    if "times-slam" in phases:
        new_times, stages = phase_times_slam(bcfg, sys_, sworld, slefts,
                                             srights)
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
                **({"past_shared_memory": times["chain_sweep_long"]}
                   if name == "chain_sweep" and "chain_sweep_long" in times
                   else {}),
                **({"at_offline_cell_sizes": times[f"{name}_cell"]}
                   if f"{name}_cell" in times else {}),
                **({"at_bal_venice": times[f"{name}_bal"]}
                   if f"{name}_bal" in times else {}),
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
