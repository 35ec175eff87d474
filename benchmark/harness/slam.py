"""The SLAM drivers: `SlamSystem` fed with the drive's rendered frames.

Set-up renders the whole drive onto the card (the generator of
`yardstick/synth.py`, from the seed), builds the system at the
configuration's settings, bootstraps it on frame 0 and drives it
closed-loop in blocks over the first `warm_frames` frames: the kernels
build, the step and backend graphs are captured and BoW trains. The
graphs the session will need later, as its keyframe store and
trajectory grow past the row buckets of the place query and the pose
graph, and the loop slate's, are captured then too (`_prewarm`, which
puts the state back as it was), so that nothing is captured inside the
window.

- `closed`: the window goes on feeding `process_block` in blocks of
  `block` frames, as fast as the system takes them; `frames_per_s` is
  the frames whose step completed over the window's wall time, which
  ends in a synchronize.
- `live`: frames are due at the configuration's frame rate; each goes
  through `process` when due (or at once, when the previous one ran
  late) and its pose is fetched to the host; `live_p95_ms` is the 95th
  percentile over every frame due in the window of the time from its
  due time to its pose on the host. How late the generator started
  each frame, and the host time `process` took to queue it, go to the
  run's info.

After the window the system's pending rows and slates are drained, and
the session's trajectory and loop edges are held to the drive's ground
truth (`reference/slam_check.py`).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.harness import common
from benchmark.harness.trace import HOST, Spans
from benchmark.reference import slam_check
from benchmark.yardstick import synth


class Session:
    """One SlamSystem over the drive's frames from frame 0. The frames
    are held as 8-bit levels and handed over as float32 levels over 255
    (`synth.to_levels`), as the program's image loader makes them."""

    def __init__(self, run, cam, cfg, seed):
        from slam1_tpu_torch.models import pipeline
        self.sys = pipeline.SlamSystem(
            cam, cfg, seed=seed, bow_train_frame=run.config["bow_train_frame"])
        self.next = 0                # next frame of the drive to feed

    def bootstrap(self, lefts, rights):
        self.sys.process(synth.to_levels(lefts[0]),
                         synth.to_levels(rights[0]))
        self.next = 1

    def feed(self, lefts, rights, n: int):
        """Up to n frames closed-loop, one process_block -> frames fed."""
        k = min(n, lefts.shape[0] - self.next)
        s = self.next
        self.sys.process_block(synth.to_levels(lefts[s:s + k]),
                               synth.to_levels(rights[s:s + k]))
        self.next += k
        return k


def _prewarm(sess: Session, cfg, device):
    """Capture now the backend graphs a longer session reaches: the place
    query of every keyframe-row bucket, the slate, and the pose graph's
    three graphs of every trajectory bucket. Their first call captures
    them. The place query, the slate and the pose graph's build and
    Gauss-Newton graphs leave the state as it is; `pgo_apply` writes the
    relaxed trajectory, poses and map into it, so the state's tensors
    are put back afterwards (`_Snapshot`), and the session goes on as if
    no graph had run. These are the program's own backend entries,
    called as `SlamSystem` calls them: if they move, the run fails
    here."""
    from slam1_tpu_torch.models import pipeline
    s = sess.sys
    saved = _Snapshot(s.state, device)
    cap = s.state.kf.desc.shape[0]
    kf_n = int(s.state.kf.n)
    q_row = kf_n - 1
    max_frame = int(s.state.kf.frame_of_row[q_row]) - cfg.bow.query_exclude
    for rows in (128, 512, 1024, 2048, 8192):
        if rows <= cap:
            s._backend(f"place_query[{rows}]",
                       pipeline._graphed_place_query(cfg, rows),
                       s._device_int(q_row), s._device_int(max(max_frame, 1)))
    k = s.SLATE_K
    dev = s.state.kf.xyz.device
    u = s.draws.slate([0] * k, [-1] * k, 0, pipeline.LOOP_RANSAC_ITERS,
                      s.state.kf.xyz.shape[1])
    s._backend("slate", pipeline._graphed_slate(s.cam, cfg), u,
               torch.full((k,), -1, device=dev),
               torch.zeros(k, dtype=torch.int64, device=dev))
    _, n_live, edges = s._pgo_inputs()
    f_cap = s.state.traj.shape[0]
    for bucket in pipeline.PGO_BUCKETS:
        if bucket <= f_cap:
            s._pgo(bucket, max(cfg.ba.pg_iters // 5, 3), min(n_live, bucket),
                   *edges)
    saved.restore(s.state)
    common.sync(device)


class _Snapshot:
    """The state's tensors as they are: a copy of each leaf up to
    `COPY_BYTES`, a byte sum of each larger one (the keyframe store's
    descriptors, the map's tables). `restore` writes the copies back and
    raises where a larger leaf changed."""

    COPY_BYTES = 1 << 24

    def __init__(self, state, device):
        from slam1_tpu_torch.utils.tree import flatten
        common.sync(device)
        self.leaves = [x.clone() if self._small(x) else self._sum(x)
                       for x in flatten(state)]

    @classmethod
    def _small(cls, x):
        return x.numel() * x.element_size() <= cls.COPY_BYTES

    @staticmethod
    def _sum(x):
        return x.detach().contiguous().view(torch.uint8).sum(
            dtype=torch.int64)

    def restore(self, state):
        from slam1_tpu_torch.utils.tree import flatten
        for x, y in zip(flatten(state), self.leaves, strict=True):
            if self._small(x):
                x.copy_(y)
            elif not torch.equal(self._sum(x), y):
                raise RuntimeError(
                    f"the pre-warm changed a state leaf of shape "
                    f"{tuple(x.shape)} it cannot put back")


def _setup(run, device):
    """Frames, the system, its warm-up and the pre-warm -> (truth,
    lefts, rights, session)."""
    cfgj, tr = run.config, run.traffic
    world_seed, program_seed = common.sub_seeds(run.seed, 2)
    d, w = tr["drive"], tr["world"]
    cam = synth.camera(cfgj)
    truth = synth.drive(d["kind"], d["frames"], d["speed"])
    n_points = int(round(w["points_per_m"] * d["frames"] * d["speed"]))
    world = synth.make_world(world_seed, truth, n_points, cam,
                             w["patch_size"], tuple(w["z_range"]), device)
    img = cfgj["image"]
    lefts, rights = synth.render(world, d["frames"], img["height"],
                                 img["width"], dtype=torch.uint8)
    del world
    run.info["frames_bytes"] = 2 * lefts.numel() * lefts.element_size()
    cfg = common.slam_config(cfgj)
    sess = Session(run, common.program_camera(cam, device), cfg,
                   program_seed)
    sess.bootstrap(lefts, rights)
    while sess.next < tr["warm_frames"]:
        sess.feed(lefts, rights, min(tr["block"],
                                     tr["warm_frames"] - sess.next))
    _prewarm(sess, cfg, device)
    return truth, lefts, rights, sess


def _spans(run):
    """Host spans of the SLAM driver, for a traced run."""
    if not run.trace:
        return None
    from slam1_tpu_torch.models import pipeline
    spans = Spans()
    spans.graphs()
    S = pipeline.SlamSystem
    spans.wrap(S, "_after_frames", HOST + "after_frames", timed=True)
    for m in ("_poll", "_train_bow", "_consume_verifications",
              "_dispatch_slate", "_place_pairs", "_run_pgo", "_drain_rows"):
        spans.wrap(S, m, HOST + m.lstrip("_"), timed=True)
    spans.wrap(S, "process_block", HOST + "process_block", timed=True)
    spans.wrap(S, "process", HOST + "process", timed=True)
    return spans


def _finish(run, device, sess, truth, first_frame):
    """Memory peak, drain, then the ground-truth check of the session."""
    run.memory_peak_bytes = common.memory_peak(device)
    run.info["session_peak_bytes"] = (run.memory_peak_bytes
                                      - run.info["frames_bytes"])
    s = sess.sys
    s._poll(force=True)
    s._consume_verifications(force=True)
    common.sync(device)
    traj = s.state.traj[:s.frame_count + 1].cpu().numpy()
    truth = truth[:traj.shape[0]].numpy()
    edges = [(i, j, Z) for i, j, Z, _w in s.loop_edges]
    run.failed = sum(not m.pnp_ok for m in s.metrics
                     if m.frame >= first_frame)
    run.info.update(loop_edges=len(edges), relaxations=len(s.pgo_costs),
                    worst_frames=slam_check.worst_frames(traj, truth))
    run.checks = slam_check.check([(traj, truth, edges)])
    print(f"bench: {run.info}", file=sys.stderr)


def closed(run, device):
    tr = run.traffic
    truth, lefts, rights, sess = _setup(run, device)
    run.spans = _spans(run)
    first = sess.next
    frames = 0
    run.window_opens()
    run.window.start()
    t0 = time.perf_counter()
    # The window ends at --seconds, or sooner where the drive's frames
    # run out (a program faster than the traffic file's frames allow).
    while sess.next < lefts.shape[0]:
        frames += sess.feed(lefts, rights, tr["block"])
        if run.window.due():
            run.window.stop()
        if time.perf_counter() - t0 >= run.seconds:
            break
    common.sync(device)
    wall = time.perf_counter() - t0
    run.window.stop()
    if run.spans:
        run.spans.close()
    run.e2e["frames_per_s"] = frames / wall
    run.attempted = frames
    run.info.update(window_frames=frames, window_s=wall,
                    drive_ran_out=sess.next >= lefts.shape[0])
    run.info["sizes"] = _sizes(sess.sys)
    _finish(run, device, sess, truth, first)


def live(run, device):
    truth, lefts, rights, sess = _setup(run, device)
    run.spans = _spans(run)
    period = 1.0 / run.config["frame_rate_hz"]
    n_due = int(round(run.seconds / period))
    lat, late = [], []
    first = sess.next
    s = sess.sys
    enq = []
    run.window_opens()
    run.window.start()
    t0 = time.perf_counter() + period
    for n in range(n_due):
        due = t0 + n * period
        # Spin to the due time, yielding the GIL to the program's worker
        # thread: a thread woken from sleep on a shared host starts up to
        # milliseconds late, which would count against the program.
        while time.perf_counter() < due:
            time.sleep(0)
        start = time.perf_counter()
        i = sess.next
        if i >= lefts.shape[0]:
            break
        s.process(synth.to_levels(lefts[i]), synth.to_levels(rights[i]))
        queued = time.perf_counter()
        sess.next += 1
        s.state.T_w_cam.cpu()
        done = time.perf_counter()
        lat.append(done - due)
        late.append(start - due)
        enq.append(queued - start)
        if run.window.due():
            run.window.stop()
    run.window.stop()
    if run.spans:
        run.spans.close()
    # A frame due in the window that never went through counts as late
    # without bound.
    lat += [float("inf")] * (n_due - len(lat))
    run.e2e["live_p95_ms"] = 1e3 * float(np.percentile(lat, 95))
    run.attempted = n_due
    run.info.update(window_frames=len(late), window_s=n_due * period,
                    p50_ms=1e3 * float(np.median(lat)),
                    generator_late_p95_ms=1e3 * float(np.percentile(late, 95)),
                    generator_late_max_ms=1e3 * float(np.max(late)),
                    enqueue_p50_ms=1e3 * float(np.median(enq)),
                    enqueue_p95_ms=1e3 * float(np.percentile(enq, 95)))
    run.info["sizes"] = _sizes(s)
    _finish(run, device, sess, truth, first)


def _sizes(s):
    """The shapes the window ran, for the kernels' work formulas."""
    return {"kp": int(s.state.prev_obs.mask.shape[0]),
            "kf_features": int(s.state.kf.desc.shape[1]),
            "levels": int(s.cfg.detector.num_levels)}
