"""Single-card SLAM throughput and accuracy benchmark of the port
(counterpart of the root `bench.py`, with its function names, clips and
JSON keys): `slam-torch bench`.

Prints ONE JSON line as its last line: {"metric", "value", "unit",
"data", "vs_baseline", "ate_rmse_m", "ref_ate_rmse_m", "loop_closures",
"ref_loop_closures", "vo_frames_per_s_per_chip", "vo_vs_baseline"}.
The device, and on a card the nvidia-smi name and power limit, go to
stderr.

Headline: frames/s of the full SLAM pipeline at `SlamConfig()` unchanged
(asynchronous drain, local BA, loop closure, pose-graph relaxation) over
the 600-frame two-lap `loop2` clip at 376x1280, and the trajectory ATE
(RMSE, no alignment) and accepted loop closures after `finalize`. Also
VO frames/s (`vo.vo_block` on the 24-frame `arc` clip). Both clips are
rendered on the device from the port's numpy-seeded world
(`utils/synthetic.py`), so they are not the JAX package's clips of the
same seeds.

vs_baseline: ratio to a reference-equivalent OpenCV / scikit-learn
pipeline on this host's CPU (`measure_reference_slam`,
`measure_reference`, copied from the root `bench.py`); null where cv2 or
sklearn cannot be imported. Its numbers are cached per host and clip.

Divergences from the root `bench.py`, by design:
  (a) no catch around `measure_slam`: a failure exits non-zero, since a
      null headline would hide a device fault;
  (b) the baseline cache is `slam1_tpu_torch/build/bench_baseline.json`
      (git-ignored), never the tracked `.bench_baseline.json`;
  (c) the cache's clip key is the port's own ("port-loop2-600-376x1280"):
      the port's clip is not the JAX clip, and the JAX cache's reference
      ATE does not apply to it.
Timing ends in `torch.cuda.synchronize()` on a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from slam1_tpu_torch import runtime
from slam1_tpu_torch.config import SlamConfig, tiny_config
from slam1_tpu_torch.utils.evalmetrics import ate_rmse

N_FRAMES = 24          # VO clip length (cycled VO_STEPS times)
N_POINTS = 6000
VO_STEPS = 120
SLAM_FRAMES = 600      # full-pipeline clip: TWO laps of a loop — the
                       # second lap continuously revisits the first, so
                       # several independent loop-closure windows exist
SLAM_SEED = 11
CHUNK = 64             # frames rendered per device chunk
BLOCK = 32             # frames per process_block call
# --tiny (CPU tests): tiny_config() and short clips.
TINY_CLIPS = dict(n_frames=8, n_points=1500, vo_steps=14, slam_frames=40)
CACHE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "bench_baseline.json")
_DEFAULT_HW = (SlamConfig().image.height, SlamConfig().image.width)


def make_clip_world(seed: int, n_frames: int, n_points: int,
                    trajectory: str, cfg: SlamConfig, device):
    """bench.py's synthetic world (speed 1.0) on `device`. At the
    default canvas it keeps the KITTI camera and depth band, as the
    root bench's clips do; a smaller canvas (--tiny) gets a camera
    scaled to it."""
    from slam1_tpu_torch.utils.synthetic import make_world
    hw = (cfg.image.height, cfg.image.width)
    kw = {} if hw == _DEFAULT_HW else {"image_hw": hw}
    return make_world(seed, n_frames=n_frames, n_points=n_points,
                      trajectory=trajectory, speed=1.0, device=device, **kw)


def render_chunk(world, first: int, last: int, cfg: SlamConfig):
    """Frames [first, last) of `world` as (K,H,W) left / right stacks on
    the world's device."""
    from slam1_tpu_torch.utils.synthetic import render_frame
    h, w = cfg.image.height, cfg.image.width
    frames = [render_frame(world, i, h, w) for i in range(first, last)]
    return (torch.stack([f[0] for f in frames]),
            torch.stack([f[1] for f in frames]))


def sync(device):
    """Wait for the card (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_vo(lefts, rights, cam, cfg, vo_steps: int = VO_STEPS):
    """VO frames/s over the clip's frames 1.. as `vo.vo_block`s: one
    warm block, then max(vo_steps // (F-1), 1) timed ones."""
    from slam1_tpu_torch.models import vo

    state = vo.init_state(lefts[0], rights[0], cam, cfg)
    Ls, Rs = lefts[1:], rights[1:]
    state, _, _ = vo.vo_block(state, Ls, Rs, cam, cfg)        # warm
    sync(lefts.device)

    reps = max(vo_steps // Ls.shape[0], 1)
    t0 = time.perf_counter()
    for _k in range(reps):
        state, _, _ = vo.vo_block(state, Ls, Rs, cam, cfg)
    sync(lefts.device)
    return reps * Ls.shape[0] / (time.perf_counter() - t0)


def measure_slam(cfg, n_frames=SLAM_FRAMES, device="cuda"):
    """Full pipeline over an n_frames synthetic two-lap loop: returns
    (frames/s of the process loop, ATE RMSE m after finalize, accepted
    loop closures, the rendered chunks, the world). ATE is RMSE vs GT
    without alignment."""
    from slam1_tpu_torch.models import pipeline

    dev = runtime.device(device)
    world = make_clip_world(SLAM_SEED, n_frames, 20 * n_frames, "loop2",
                            cfg, dev)
    # Rendered once into device-resident chunks, so the timed loop
    # measures the pipeline, not rendering or host->device transfer.
    chunks = [render_chunk(world, s, min(s + CHUNK, n_frames), cfg)
              for s in range(0, n_frames, CHUNK)]
    sync(dev)

    def feed(sys_):
        sys_.process(chunks[0][0][0], chunks[0][1][0])   # bootstrap
        i = 1
        while i < n_frames:
            c, off = i // CHUNK, i % CHUNK
            k = min(BLOCK, CHUNK - off, n_frames - i)
            l, r = chunks[c]
            sys_.process_block(l[off:off + k], r[off:off + k])
            i += k

    # Warm pass: builds the kernels and warms every stage the pipeline
    # can reach (BoW train/backfill, local BA, loop verification, PGO),
    # the solver handles and the allocator.
    warm = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=30)
    feed(warm)
    warm.finalize()
    del warm

    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=30)
    sync(dev)
    t0 = time.perf_counter()
    feed(sys_)
    sync(dev)
    fps = (n_frames - 1) / (time.perf_counter() - t0)
    poses = sys_.finalize()
    ate = float(ate_rmse(poses, world.poses.cpu().numpy(), align=False))
    return fps, ate, len(sys_.loop_edges), chunks, world


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def measure_reference_slam(lefts_np, rights_np, world, n_frames):
    """The reference pipeline itself (OpenCV/sklearn re-implementation of
    the original project's main.py:32-146) run END TO END on the same
    loop clip: tiled ORB, FLANN-style LR ratio match + LMedS mask
    (keypoint.py:35-66), triangulation, temporal 2D-3D association
    (Point3D.py:33-53),
    PnP-RANSAC pose CHAINING (transformation.py:5-37, main.py:120-122),
    KD-tree global-map merge (keypoint.py:102-122), full-sequence-trained
    KMeans BoW + raw-count chi^2 scan (bag_of_words.py:10-53), loop
    closure via re-localization + LINEAR translation error distribution
    (loop_closure.py:7-52, main.py:99-118).

    Returns (fps, ate_rmse_m, n_loops) — the reference's own trajectory
    accuracy and speed on this clip. Returns None if cv2/sklearn missing.
    """
    try:
        import cv2
        from sklearn.cluster import KMeans
        from sklearn.neighbors import KDTree
    except ImportError:
        return None

    cam = world.cam
    K = _np(cam.K).astype(np.float64)
    P_l, P_r = (_np(p).astype(np.float64)
                for p in cam.projection_matrices())
    u8_l = [(np.asarray(l) * 255).astype(np.uint8) for l in lefts_np]
    u8_r = [(np.asarray(r) * 255).astype(np.uint8) for r in rights_np]
    n = min(n_frames, len(u8_l))

    # ref orb.py:4-25 exactly: 5x10 grid, tiles 1.5x the grid pitch
    # (50% overlap), stepped by the pitch; ORB(scaleFactor=1.2) with
    # 200 kp per tile (main.py:75 passes max_number_of_kp=200)
    orb = cv2.ORB_create(nfeatures=200, scaleFactor=1.2)

    def detect_tiled(img):
        h, w = img.shape
        th, tw = h // 5, w // 10
        kps, descs = [], []
        for y in range(0, h - th, th):
            for x in range(0, w - tw, tw):
                tile = img[y:y + th + th // 2, x:x + tw + tw // 2]
                kp = orb.detect(tile, None)
                kp, des = orb.compute(tile, kp)
                if des is None:
                    continue
                for k in kp:
                    k.pt = (k.pt[0] + x, k.pt[1] + y)
                kps += list(kp)
                descs.append(des)
        if not descs:
            return [], None
        return kps, np.concatenate(descs)

    bf = cv2.BFMatcher(cv2.NORM_HAMMING)

    def ratio_match(da, db, ratio=0.7):
        # ref keypoint.py:44-51 / Point3D.py:44-49 (0.7 Lowe ratio)
        out = []
        for p in bf.knnMatch(da, db, k=2):
            if len(p) == 2 and p[0].distance < ratio * p[1].distance:
                out.append(p[0])
        return out

    def stereo_3d(kl, dl, kr, dr):
        """LR match + LMedS mask + triangulation -> (X, desc, uv_l)."""
        good = ratio_match(dl, dr)
        if len(good) < 9:
            return None
        uvl = np.float64([kl[m.queryIdx].pt for m in good])
        uvr = np.float64([kr[m.trainIdx].pt for m in good])
        des = np.concatenate([dl[m.queryIdx:m.queryIdx + 1] for m in good])
        _, mask = cv2.findFundamentalMat(uvl, uvr, cv2.FM_LMEDS)
        if mask is not None:                  # ref keypoint.py:59-66
            mb = mask.ravel().astype(bool)
            if mb.sum() >= 6:
                uvl, uvr, des = uvl[mb], uvr[mb], des[mb]
        X = cv2.triangulatePoints(P_l, P_r, uvl.T, uvr.T)
        return (X[:3] / X[3]).T, des, uvl

    def pnp_T(X3, uv2):
        # ref transformation.py:5-19: negate rvec/tvec -> 4x4 increment
        okf, rvec, tvec, _ = cv2.solvePnPRansac(
            np.ascontiguousarray(X3), np.ascontiguousarray(uv2), K,
            np.zeros(5))
        if not okf:
            return None
        R, _ = cv2.Rodrigues(-rvec)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -tvec.ravel()
        return T

    def temporal(X, des, kn, dn):
        # ref Point3D.py:33-53: match + |coord| < 500 gate
        good2 = [m for m in ratio_match(des, dn)
                 if np.all(np.abs(X[m.queryIdx]) < 500.0)]
        if len(good2) <= 4:                   # ref main.py:94 guard
            return None
        X3 = np.float64([X[m.queryIdx] for m in good2])
        uv2 = np.float64([kn[m.trainIdx].pt for m in good2])
        return X3, uv2

    # --- BoW trained on the FULL sequence up front (ref main.py:43-44,
    # bag_of_words.py:16-27): ORB(100) per image, KMeans(50) vocabulary,
    # raw-count histograms.
    orb_full = cv2.ORB_create(nfeatures=100)
    dlist = []
    for img in u8_l[:n]:
        _, d = orb_full.detectAndCompute(img, None)
        dlist.append(d if d is not None else np.zeros((1, 32), np.uint8))
    km = KMeans(50, n_init=4, random_state=0).fit(np.concatenate(dlist))
    db = []
    for d in dlist:
        lab = km.predict(d)
        db.append(np.histogram(lab, bins=50, range=(0, 49))[0]
                  .astype(np.float64))

    def chi2(x, y):                           # ref bag_of_words.py:30-31
        return np.sum(2 * (x - y) ** 2 / np.maximum(1, x + y))

    poses = [np.eye(4)]
    T_prev = np.eye(4)
    bow_threshold = 100                       # ref main.py:40
    n_loops = 0
    map_pts = None
    kl, dl = detect_tiled(u8_l[0])

    t0 = time.perf_counter()
    for i in range(n - 1):
        kr, dr = detect_tiled(u8_r[i])
        kn, dn = detect_tiled(u8_l[i + 1])
        T = None
        tri = None
        if dl is not None and dr is not None and dn is not None:
            tri = stereo_3d(kl, dl, kr, dr)
        if tri is not None:
            tm = temporal(tri[0], tri[1], kn, dn)
            if tm is not None:
                T = pnp_T(*tm)
        if T is None:
            T = T_prev                        # ref main.py:94-98: reuse
        T_prev = T

        # BoW scan vs all frames older than the threshold
        # (ref bag_of_words.py:29-42, main.py:99-100: 0 < val < 45)
        loop_done = False
        if i >= bow_threshold:
            h = db[i]
            dist = [chi2(h, db[j]) for j in range(i + 1 - bow_threshold)]
            idx, val = int(np.argmin(dist)), float(np.min(dist))
            if 0 < val < 45:
                bow_threshold = i + 100       # ref main.py:106 re-arm
                # close_loop: relocalize frame i against candidate idx
                # (ref loop_closure.py:7-36)
                kc, dc = detect_tiled(u8_l[idx])
                kcr, dcr = detect_tiled(u8_r[idx])
                T_loop = None
                if dc is not None and dcr is not None:
                    tri_c = stereo_3d(kc, dc, kcr, dcr)
                    if tri_c is not None:
                        # current frame i's tiled features = kl/dl
                        tm_c = temporal(tri_c[0], tri_c[1], kl, dl)
                        if tm_c is not None:
                            T_loop = pnp_T(*tm_c)
                if T_loop is not None:
                    n_loops += 1
                    corrected = poses[idx] @ T_loop
                    wrong = poses[-1] @ T
                    err = (corrected - wrong) / (i + 1 - idx)
                    # translation-only linear smear over frames idx..i
                    # (ref loop_closure.py:48-52, main.py:113-118)
                    for k2 in range(idx, i + 1):
                        poses[k2][:3, 3] += (k2 - idx) * err[:3, 3]
                    poses.append(corrected)
                    loop_done = True
        if not loop_done:
            poses.append(poses[-1] @ T)       # ref main.py:120-122

        # KD-tree global-map merge, rebuilt per frame
        # (ref keypoint.py:102-122, main.py:124-127)
        if tri is not None:
            Xw = (poses[-1] @ np.concatenate(
                [tri[0], np.ones((len(tri[0]), 1))], 1).T)[:3].T
            if map_pts is None:
                map_pts = Xw
            else:
                tree = KDTree(map_pts)
                dist_m, _ = tree.query(Xw, k=1)
                thr = np.maximum(0.5, 0.01 * np.abs(Xw[:, 2]))
                new = Xw[dist_m[:, 0] > thr]
                if len(new):
                    map_pts = np.vstack([map_pts, new])
        kl, dl = kn, dn
    fps = (n - 1) / (time.perf_counter() - t0)

    gt = _np(world.poses)[:len(poses)]
    ate = float(ate_rmse(np.asarray(poses), gt, align=False))
    return fps, ate, n_loops


def _reference_vo_step(cam):
    """Per-frame step shaped like the reference's VO hot path (detect /
    match / triangulate / temporal-match / PnP, the original
    project's main.py:76-95) — the timed baseline for the VO-only comparison.
    (The FULL reference pipeline incl. mapping/BoW/loop closure is
    measure_reference_slam above.)"""
    import cv2
    K = _np(cam.K).astype(np.float64)
    P_l, P_r = (_np(p).astype(np.float64)
                for p in cam.projection_matrices())

    def detect_tiled(img):
        # ref orb.py:4-25: 5x10 tiles, ORB per tile
        h, w = img.shape
        th, tw = h // 5, w // 10
        kps, descs = [], []
        orb = cv2.ORB_create(nfeatures=40)
        for r in range(5):
            for c in range(10):
                tile = img[r * th:(r + 1) * th, c * tw:(c + 1) * tw]
                kp, des = orb.detectAndCompute(tile, None)
                if des is None:
                    continue
                for k in kp:
                    k.pt = (k.pt[0] + c * tw, k.pt[1] + r * th)
                kps += list(kp)
                descs.append(des)
        if not descs:
            return [], None
        return kps, np.concatenate(descs)

    bf = cv2.BFMatcher(cv2.NORM_HAMMING)

    def step(li, ri, l_next, frame_idx):
        kl, dl = detect_tiled(li)
        kr, dr = detect_tiled(ri)
        kn, dn = detect_tiled(l_next)
        if dl is None or dr is None or dn is None:
            return
        # L-R match + ratio (ref keypoint.py:44-51)
        pairs = bf.knnMatch(dl, dr, k=2)
        good = [m for m, n2 in (p for p in pairs if len(p) == 2)
                if m.distance < 0.8 * n2.distance]
        if len(good) < 9:
            return
        uvl = np.float64([kl[m.queryIdx].pt for m in good])
        uvr = np.float64([kr[m.trainIdx].pt for m in good])
        cv2.findFundamentalMat(uvl, uvr, cv2.FM_LMEDS)  # ref epipolar filter
        X = cv2.triangulatePoints(P_l, P_r, uvl.T, uvr.T)
        X = (X[:3] / X[3]).T
        d_tri = np.concatenate([dl[m.queryIdx:m.queryIdx + 1] for m in good])
        # temporal match (ref Point3D.py:33-53)
        pairs2 = bf.knnMatch(d_tri, dn, k=2)
        good2 = [m for m, n2 in (p for p in pairs2 if len(p) == 2)
                 if m.distance < 0.8 * n2.distance]
        if len(good2) < 6:
            return
        X3 = np.float64([X[m.queryIdx] for m in good2])
        uv2 = np.float64([kn[m.trainIdx].pt for m in good2])
        cv2.solvePnPRansac(X3, uv2, K, None, reprojectionError=3.0)

    return step


def measure_reference(lefts_np, rights_np, cam, with_mapping, n):
    del with_mapping                          # kept for bench.py's signature
    try:
        import cv2  # noqa: F401
    except ImportError:
        return None
    step = _reference_vo_step(cam)
    u8_l = [(np.asarray(l) * 255).astype(np.uint8) for l in lefts_np]
    u8_r = [(np.asarray(r) * 255).astype(np.uint8) for r in rights_np]
    step(u8_l[0], u8_r[0], u8_l[1], 0)       # warm-up
    n = min(n, len(u8_l) - 1)
    t0 = time.perf_counter()
    for i in range(n):
        step(u8_l[i], u8_r[i], u8_l[i + 1], i)
    return n / (time.perf_counter() - t0)


def _host_fingerprint() -> str:
    """CPU model + core count: the validity domain of the cached CPU
    reference baseline."""
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model}/{os.cpu_count()}"


def _describe_device(dev):
    """The device on stderr; on a card also nvidia-smi's name and power
    limit (the rates are only comparable at the same limit)."""
    print(f"bench: device {dev}", file=sys.stderr, flush=True)
    if dev.type != "cuda":
        return
    print(f"bench: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(f"bench: nvidia-smi: {smi}", file=sys.stderr, flush=True)


def _load_cache(path, clip_key, fp):
    """The cached CPU baseline, or {} when it is missing, unreadable, or
    from another host or clip."""
    try:
        with open(path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return {}
    if cache.get("host_fp") != fp or cache.get("clip") != clip_key:
        return {}
    return cache


def main(device="cuda", tiny=False):
    dev = runtime.device(device)
    _describe_device(dev)
    cfg = tiny_config() if tiny else SlamConfig()
    clips = TINY_CLIPS if tiny else dict(
        n_frames=N_FRAMES, n_points=N_POINTS, vo_steps=VO_STEPS,
        slam_frames=SLAM_FRAMES)
    n_slam = clips["slam_frames"]

    world = make_clip_world(0, clips["n_frames"], clips["n_points"], "arc",
                            cfg, dev)
    lefts, rights = render_chunk(world, 0, clips["n_frames"], cfg)
    sync(dev)
    vo_fps = measure_vo(lefts, rights, world.cam, cfg, clips["vo_steps"])
    slam_fps, ate, n_loops, s_chunks, s_world = measure_slam(cfg, n_slam,
                                                             dev)

    # Cached CPU-baseline numbers are only valid on the host and clip
    # that measured them: re-measure on a mismatch.
    fp = _host_fingerprint()
    clip_key = f"port-loop2-{n_slam}-{cfg.image.height}x{cfg.image.width}"
    cache = _load_cache(CACHE_PATH, clip_key, fp)
    ref_vo = cache.get("reference_fps")
    if ref_vo is None:
        ref_vo = measure_reference(lefts[:10].cpu().numpy(),
                                   rights[:10].cpu().numpy(), world.cam,
                                   with_mapping=False, n=8)
    # The reference pipeline run end to end on the same loop clip: its
    # fps, ATE and loop closures (deterministic given the clip and host,
    # so cached).
    ref = cache.get("reference_slam_v2")
    if ref is None:
        s_lefts = np.concatenate([l.cpu().numpy() for l, _ in s_chunks])
        s_rights = np.concatenate([r.cpu().numpy() for _, r in s_chunks])
        ref = measure_reference_slam(s_lefts, s_rights, s_world, n_slam)
    ref_slam, ref_ate, ref_loops = ref if ref else (None, None, None)
    if ref_vo or ref:
        os.makedirs(os.path.dirname(CACHE_PATH), exist_ok=True)
        with open(CACHE_PATH, "w") as f:
            json.dump({"reference_fps": ref_vo, "reference_slam_v2": ref,
                       "clip": clip_key, "host_fp": fp,
                       "host": "cpu-reference-equivalent"}, f)

    vs_slam = (slam_fps / ref_slam) if ref_slam else None
    vs_vo = (vo_fps / ref_vo) if ref_vo else None
    print(json.dumps({
        "metric": "slam_frames_per_s_per_chip",
        "value": round(slam_fps, 3),
        "unit": "frames/s",
        # Both pipelines run on the same synthetic rendered clip; ATE is
        # against the clip's exact ground truth.
        "data": f"synthetic-loop2-{n_slam}",
        "vs_baseline": round(vs_slam, 3) if vs_slam else None,
        "ate_rmse_m": round(ate, 4),
        "ref_ate_rmse_m": round(ref_ate, 4) if ref_ate is not None
        else None,
        "loop_closures": n_loops,
        "ref_loop_closures": ref_loops,
        "vo_frames_per_s_per_chip": round(vo_fps, 3),
        "vo_vs_baseline": round(vs_vo, 3) if vs_vo else None,
    }))
    return 0
