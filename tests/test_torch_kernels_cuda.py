"""The CUDA kernels against their plain PyTorch twins, on the card, and
what else only a card can show (bundle adjustment on CUDA tensors
against the CPU, a windowed BA without a host sync, the backend's
graphs, the pose-graph relaxation's among them, replayed over the step
graph's state, the chain kernels captured once and replayed with
several live counts written into their device scalar, global BA's own
graphs replayed without a sync, the sharded solvers' graphs under
NCCL, collectives inside, the tracer's spans against the CUDA
profiler's annotations, every stream synchronization of the SLAM
driver counted as a wait, and BA's reduced-system halves counted per
LM iteration).

Every test here is marked `cuda` and skips where there is no card (the
kernels have no CPU mode). The file imports torch and the port only,
so it also runs on a machine without jax:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import dataclasses
import threading
import traceback
import warnings

import numpy as np
import pytest
import torch

from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline, vo
from slam1_tpu_torch.ops import cuda_kernels
from slam1_tpu_torch.ops import fast as tfast
from slam1_tpu_torch.ops.segment import seg_sum
from slam1_tpu_torch.utils import synthetic
from slam1_tpu_torch.utils.graphs import StepGraph
from slam1_tpu_torch.utils.tree import flatten, unflatten

pytestmark = pytest.mark.cuda

FAST_TOL = 1e-5
GATES = {
    "ungated": {},
    "epipolar": dict(dy_tol=10.0, dx_lo=0.5, dx_hi=40.0),
    "window": dict(dy_tol=12.0, dx_lo=-12.0, dx_hi=12.0),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _hamming_inputs(seed, n, m, dup):
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    db = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    if dup == "pairs":           # repeated rows and columns force ties
        da[1::2] = da[:-1:2][: n // 2]
        db[1::2] = db[:-1:2][: m // 2]
        db[: min(n, m) // 2] = da[: min(n, m) // 2]
    elif dup == "straddle":
        # Equal columns and equal rows on both sides of the kernel's tile
        # boundaries: MMA tile (8 columns, 16 rows), warp (16 rows), row
        # block (128 rows), column strip (208 columns at 2688).
        for j in (1, 7, 8, 15, 16, 127, 128, 207, 208, 415, 416, m - 1):
            if 0 < j < m:
                db[j] = db[0]
        da[::5] = db[0]
        for i in (1, 7, 8, 15, 16, 31, 32, 127, 128, 129, n - 1):
            if 2 < i < n:
                da[i] = da[2]
    ma = rng.random(n) > 0.2
    mb = rng.random(m) > 0.2
    uva = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    uvb = rng.uniform(0, 100, (m, 2)).astype(np.float32)
    uva[:, 1] = np.round(uva[:, 1])
    uvb[:, 1] = np.round(uvb[:, 1])
    return da, db, ma, mb, uva, uvb


@pytest.mark.parametrize("shape", [(2, 376, 1280), (2, 188, 640),
                                   (2, 94, 320), (1, 70, 129)])
def test_fast_score_cuda_matches_plain(cuda_device, shape):
    img = torch.rand(shape, generator=torch.Generator().manual_seed(9))
    img = img.to(cuda_device)
    k = cuda_kernels.fast_score_cuda(img, 0.08)
    p = tfast.fast_score(img, 0.08)
    assert torch.equal(k > 0, p > 0)
    assert (k - p).abs().max().item() <= FAST_TOL


def _assert_fast_equal(k, p):
    assert k.shape == p.shape
    assert torch.equal(k > 0, p > 0)
    assert (k - p).abs().max().item() <= FAST_TOL


LEVEL_SHAPES = {
    "frame": [(2, 376, 1280), (2, 188, 640), (2, 94, 320)],
    "ragged": [(2, 61, 83), (2, 31, 42), (2, 16, 21)],
    "one-level": [(1, 70, 129)],
    "five-levels": [(3, 97, 130), (3, 49, 65), (3, 25, 33), (3, 13, 17),
                    (3, 7, 9)],
    "too-small-to-score": [(2, 6, 40), (2, 40, 5), (2, 1, 1)],
    "smallest-first": [(1, 8, 12), (1, 33, 64), (1, 64, 128)],
}


@pytest.mark.parametrize("arc", [9, 12, 16])
@pytest.mark.parametrize("moved", [False, True],
                         ids=["aligned", "moved-4-bytes"])
@pytest.mark.parametrize("case", sorted(LEVEL_SHAPES))
def test_fast_score_levels_cuda_matches_plain(cuda_device, case, moved, arc):
    g = torch.Generator().manual_seed(11)
    imgs = [torch.rand(s, generator=g).to(cuda_device)
            for s in LEVEL_SHAPES[case]]
    if moved:                   # contiguous, off the 16-byte boundary
        imgs = [synthetic.misaligned_copy(im) for im in imgs]
        assert all(im.is_contiguous() and im.data_ptr() % 16 for im in imgs)
    before = cuda_kernels.launch_counts()["fast_score"]
    outs = cuda_kernels.fast_score_levels_cuda(imgs, 0.08, arc)
    assert cuda_kernels.launch_counts()["fast_score"] == before + 1
    assert len(outs) == len(imgs)
    for im, k in zip(imgs, outs):
        p = tfast.fast_score(im, 0.08, arc)
        _assert_fast_equal(k, p)
        if min(im.shape[1:]) < 7:
            assert not k.any()
        # The one-level entry on the same image.
        _assert_fast_equal(cuda_kernels.fast_score_cuda(im, 0.08, arc), p)
    if arc == 9 and case == "frame":
        assert all((k > 0).sum() > 100 for k in outs)


@pytest.mark.parametrize("arc", [9, 12, 16])
def test_fast_score_cuda_compares_strictly(cuda_device, arc):
    """Taps exactly threshold above (below) the centre are not brighter
    (darker): with all 16 there the pixel is no corner; with the
    difference one float past the threshold, it is."""
    thr = 0.25                       # 0.5 +- 0.25 are exact in float32
    imgs = []
    # The last two taps are floats whose difference from 0.5 is exact.
    for tap in (0.75, 0.25, 0.75 + 2.0 ** -24, 0.25 - 2.0 ** -25):
        img = torch.full((1, 16, 24), 0.5)
        for dy, dx in tfast.CIRCLE:
            img[0, 8 + dy, 12 + dx] = tap
        imgs.append(img.to(cuda_device))
    outs = cuda_kernels.fast_score_levels_cuda(imgs, thr, arc)
    for im, k in zip(imgs, outs):
        _assert_fast_equal(k, tfast.fast_score(im, thr, arc))
    assert [bool(k[0, 8, 12] > 0) for k in outs] == [False, False, True,
                                                     True]


def test_fast_score_cuda_2d_and_dispatch(cuda_device):
    from slam1_tpu_torch.ops import dispatch
    img = torch.rand(40, 52, generator=torch.Generator().manual_seed(2))
    img = img.to(cuda_device)
    p = tfast.fast_score(img, 0.08)
    _assert_fast_equal(cuda_kernels.fast_score_cuda(img, 0.08), p)
    # The dispatch makes a strided view contiguous; the wrapper refuses it.
    wide = torch.rand(2, 40, 104, generator=torch.Generator().manual_seed(3))
    view = wide.to(cuda_device)[:, :, ::2]
    outs = dispatch.fast_score_levels([view, view[:, ::2]], 0.08)
    _assert_fast_equal(outs[0], tfast.fast_score(view, 0.08))
    _assert_fast_equal(outs[1], tfast.fast_score(view[:, ::2], 0.08))


@pytest.mark.parametrize("dup", [None, "pairs", "straddle"],
                         ids=["random", "ties", "ties-across-tiles"])
@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("n,m", [(256, 128), (2688, 2688), (300, 77),
                                 (1, 2), (130, 257), (129, 1000),
                                 (16, 5000)])
def test_hamming_top2_cuda_matches_plain(cuda_device, gate, dup, n, m):
    arrs = _hamming_inputs(10, n, m, dup)
    da, db, ma, mb, uva, uvb = [torch.as_tensor(x).to(cuda_device)
                                for x in arrs]
    kw = dict(uv_a=uva, uv_b=uvb, **GATES[gate]) if GATES[gate] else {}
    outk = cuda_kernels.hamming_top2_cuda(da, db, ma, mb, **kw)
    outp = cuda_kernels.hamming_top2_plain(da, db, ma, mb, **kw)
    for name, a, b in zip(("d1", "d2", "idx", "col_best"), outk, outp):
        assert torch.equal(a, b), name


def test_wrappers_reject_bad_inputs(cuda_device):
    img = torch.rand(2, 32, 48, device=cuda_device)
    with pytest.raises(TypeError):
        cuda_kernels.fast_score_cuda(img.double(), 0.08)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.fast_score_cuda(img.transpose(1, 2), 0.08)
    levels = cuda_kernels.fast_score_levels_cuda
    with pytest.raises(TypeError, match=r"imgs\[1\]"):
        levels([img, img.double()], 0.08)
    with pytest.raises(ValueError, match=r"imgs\[1\].*contiguous"):
        levels([img, img.transpose(1, 2)], 0.08)
    with pytest.raises(ValueError, match=r"imgs\[1\].*\(B,H,W\)"):
        levels([img, img[0]], 0.08)
    with pytest.raises(ValueError, match=r"imgs\[1\].*batch"):
        levels([img, img[:1]], 0.08)
    with pytest.raises(ValueError, match=r"imgs\[1\].*CUDA"):
        levels([img, img.cpu()], 0.08)
    with pytest.raises(ValueError, match=r"imgs\[0\].*empty"):
        levels([img[:, :0]], 0.08)
    with pytest.raises(ValueError, match="levels"):
        levels([img] * (cuda_kernels.FAST_MAX_LEVELS + 1), 0.08)
    with pytest.raises(ValueError, match="arc"):
        levels([img], 0.08, arc=0)
    d = torch.zeros(8, 32, dtype=torch.uint8, device=cuda_device)
    m = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        cuda_kernels.hamming_top2_cuda(d[:, :16].contiguous(), d, m, m)


def test_vo_slice_launches_both_kernels(cuda_device):
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=5, n_points=1500,
                                 image_hw=(h, w), speed=0.8,
                                 device=cuda_device)
    lefts, rights = synthetic.render_sequence(world, h, w)
    cuda_kernels.reset_launch_counts()
    poses, metrics = vo.run_sequence(lefts, rights, world.cam, cfg)
    # tiny_config has one pyramid level: one FAST launch per frame.
    assert cuda_kernels.launch_counts() == {"fast_score": 5,
                                            "hamming_top2": 9,
                                            "hamming_top2_batched": 0,
                                            "chain_prepare": 0,
                                            "chain_sweep": 0,
                                            "ba_schur": 0}
    assert np.isfinite(poses).all()
    assert np.mean([bool(m.pnp_ok) for m in metrics]) > 0.5


@pytest.mark.parametrize("levels", [1, 3])
def test_detect_pyramid_launches_fast_score_once(cuda_device, levels):
    """Both images and every pyramid level in one launch."""
    from slam1_tpu_torch.ops import detector
    cfg = dataclasses.replace(tiny_config().detector, num_levels=levels)
    img = torch.rand(2, 128, 256, generator=torch.Generator().manual_seed(4))
    cuda_kernels.reset_launch_counts()
    feats = detector.detect_pyramid(img.to(cuda_device), cfg)
    assert cuda_kernels.launch_counts()["fast_score"] == 1
    on_cpu = detector.detect_pyramid(img, cfg)
    assert cuda_kernels.launch_counts()["fast_score"] == 1
    assert torch.equal(feats.mask.cpu(), on_cpu.mask)
    assert torch.equal(feats.score.cpu(), on_cpu.score)
    assert feats.mask.sum() > 100


@pytest.mark.parametrize("invalid", ["last", "all", "none"])
@pytest.mark.parametrize("b,n,m", [(8, 1024, 1024), (3, 300, 77),
                                   (1, 1024, 1024), (2, 130, 257)])
def test_hamming_top2_batched_cuda_matches_plain(cuda_device, b, n, m,
                                                 invalid):
    rng = np.random.default_rng(b * n)
    da = rng.integers(0, 256, (b, n, 32), dtype=np.uint8)
    db = rng.integers(0, 256, (b, m, 32), dtype=np.uint8)
    da[0, 1::2] = da[0, :-1:2][: n // 2]        # ties
    db[0, : min(n, m) // 2] = da[0, : min(n, m) // 2]
    ma = rng.random((b, n)) > 0.2
    mb = rng.random((b, m)) > 0.2
    if invalid == "last":                       # a padded problem
        ma[-1] = mb[-1] = False
    elif invalid == "all":                      # a slate of padding only
        ma[:] = mb[:] = False
    args = [torch.as_tensor(x).to(cuda_device) for x in (da, db, ma, mb)]
    outk = cuda_kernels.hamming_top2_batched_cuda(*args)
    outp = cuda_kernels.hamming_top2_batched_plain(*args)
    for name, a, c in zip(("d1", "d2", "idx", "col_best"), outk, outp):
        assert torch.equal(a, c), name
    if invalid != "none":
        assert (outk[2][-1] == 0).all() and (outk[0][-1] == 1 << 20).all()
        assert (outk[1][-1] == 1 << 20).all() and (outk[3][-1] == 0).all()


@pytest.mark.parametrize("f,n_live", [(64, 64), (64, 20), (2048, 601),
                                      (2048, 1), (2048, 2), (2048, 2048),
                                      (33, 33), (200, 130)])
def test_chain_sweep_cuda_matches_plain(cuda_device, f, n_live):
    g = torch.Generator().manual_seed(f + n_live)
    jj = torch.eye(6) + 1e-2 * torch.randn(f, 6, 6, generator=g)
    ji = 0.3 * torch.randn(f, 6, 6, generator=g)
    winv = torch.rand(f, generator=g) + 0.5
    jj[n_live:] = torch.eye(6)
    ji[n_live:] = 0.0
    v = torch.randn(f, 6, generator=g)
    ops = [x.to(cuda_device) for x in (jj, ji, winv, v)]
    before = cuda_kernels.launch_counts()
    prep = cuda_kernels.chain_prepare_cuda(ops[0], ops[1], n_live)
    assert torch.allclose(
        prep, cuda_kernels.chain_prepare_plain(ops[0], ops[1], n_live),
        rtol=0, atol=1e-5)
    xk = cuda_kernels.chain_sweep_cuda(*ops, n_live, prep=prep)
    xp = cuda_kernels.chain_sweep_plain(*ops, n_live)
    assert torch.isfinite(xk).all()
    scale = xp.abs().max().item()
    assert (xk - xp).abs().max().item() <= 1e-4 * scale
    # Without `prep` the wrapper prepares the blocks itself.
    assert torch.equal(cuda_kernels.chain_sweep_cuda(*ops, n_live), xk)
    after = cuda_kernels.launch_counts()
    assert after["chain_prepare"] - before["chain_prepare"] == 2
    assert after["chain_sweep"] - before["chain_sweep"] == 2


def test_slam_system_launches_the_kernels(cuda_device):
    """A short loop clip through SlamSystem on CUDA tensors: every frame's
    one FAST launch (both images, every level) and Hamming launches, one batched launch per slate, one
    chain_prepare per Gauss-Newton iteration and one chain_sweep per
    application of the preconditioner."""
    cfg = tiny_config()
    cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, local_every=0))
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=24, n_points=1200,
                                 trajectory="loop", image_hw=(h, w),
                                 speed=0.9, device=cuda_device)
    lefts, rights = synthetic.render_sequence(world, h, w)
    cuda_kernels.reset_launch_counts()
    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=8)
    sys_.process(lefts[0], rights[0])
    sys_.process_block(lefts[1:], rights[1:])
    poses = sys_.finalize()
    counts = cuda_kernels.launch_counts()
    assert counts["fast_score"] == 24 and counts["hamming_top2"] == 47
    assert counts["hamming_top2_batched"] == sys_.n_slates
    runs = len(sys_.pgo_costs)
    if runs:
        gn = (runs - 1) * max(cfg.ba.pg_iters // 5, 3) + cfg.ba.pg_iters
        assert counts["chain_prepare"] == gn
        assert counts["chain_sweep"] == gn * (cfg.ba.cg_iters + 1)
    else:
        assert counts["chain_prepare"] == counts["chain_sweep"] == 0
    assert np.isfinite(poses).all()


def test_spans_agree_with_the_cuda_profiler(cuda_device):
    """A clip through SlamSystem on CUDA tensors, its graphs captured
    before a CUDA torch.profiler starts: every `slam_step` replay's
    event pair resolves, every span recorded meanwhile is one of the
    profiler's user annotations of its name, starting and ending within
    20 us of it at the median and 200 us at the 99th percentile, and
    nothing is captured or built inside the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from slam1_tpu_torch.utils import metrics
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    n = 40
    world = synthetic.make_world(3, n_frames=n, n_points=1200,
                                 trajectory="straight", image_hw=(h, w),
                                 speed=0.9, device=cuda_device)
    lefts, rights = synthetic.render_sequence(world, h, w)
    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=8)
    for i in range(12):
        sys_.process(lefts[i], rights[i])
    torch.cuda.synchronize()
    metrics.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(12, n):
            sys_.process(lefts[i], rights[i])
        torch.cuda.synchronize()
    spans = metrics.recorded()
    steps = [s for s in spans if s.name == "host:launch.slam_step"]
    assert len(steps) == n - 12
    assert all(s.device_ms is not None and s.device_ms > 0 for s in steps)
    assert not any(s.name.startswith(("host:capture.", "host:kernels."))
                   for s in spans)
    # The host's annotations (the card's copies of them aside).
    ann = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.device_type() != DeviceType.CUDA
           and e.name().startswith(("host:", "replay:", "graph:"))]
    assert not any(a[0].startswith("graph:") for a in ann)
    assert sorted(a[0] for a in ann) == sorted(s.name for s in spans), (
        len(ann), len(spans))
    gaps = []
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        theirs = sorted((a, b) for m, a, b in ann if m == name)
        for (x, y), (a, b) in zip(mine, theirs):
            gaps += [abs(a - x), abs(b - y)]
    print(f"spans {len(spans)}: start and end to annotation, median "
          f"{np.median(gaps) / 1e3:.2f} us, p99 "
          f"{np.percentile(gaps, 99) / 1e3:.2f} us, max "
          f"{np.max(gaps) / 1e3:.2f} us")
    assert np.median(gaps) <= 20_000, np.median(gaps)
    assert np.percentile(gaps, 99) <= 200_000, np.percentile(gaps, 99)


# Waits whose synchronization the sync debug mode may not report: a
# device-wide `torch.cuda.synchronize` and a worker's future.
UNSEEN_WAITS = ("host:wait.pgo", "host:wait.fetch")


def test_every_stream_sync_of_the_driver_is_a_wait(cuda_device):
    """A loop clip through SlamSystem in the synchronous mode, its graphs
    captured first; then, with the sync debug mode on ("warn"), frames,
    a slate, a relaxation, the loop-edge rows and `finalize`. Every
    synchronization the mode reports on the driver's thread falls inside
    a `host:wait.*` span (or a capture, set-up), one to a span, and
    the waits number the change in `host_syncs`; a wait the mode does
    not report is one it cannot see (`UNSEEN_WAITS`)."""
    from slam1_tpu_torch.utils import metrics
    cfg = tiny_config()
    cfg = cfg.replace(bow=dataclasses.replace(cfg.bow, place_query=True))
    h, w = cfg.image.height, cfg.image.width
    n = 24
    world = synthetic.make_world(3, n_frames=n, n_points=1200,
                                 trajectory="loop", image_hw=(h, w),
                                 speed=0.9, device=cuda_device)
    lefts, rights = synthetic.render_sequence(world, h, w)
    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=8)
    for i in range(12):
        sys_.process(lefts[i], rights[i])
    sys_._dispatch_slate([(11, 2, 0.0)])
    sys_._consume_verifications(force=True)
    sys_._run_pgo()
    torch.cuda.synchronize()

    main = threading.get_ident()
    syncs = []                      # (thread, open spans, where) a report

    def report(message, category, filename, lineno, *args, **kwargs):
        # (the mode's own notice when it is set is no synchronization)
        if "called a synchronizing CUDA operation" in str(message):
            stack = metrics._state.local.stack
            syncs.append((threading.get_ident(),
                          [(s.id, s.name) for s in stack],
                          "".join(traceback.format_stack(limit=12)[:-1])))

    metrics.clear()
    before = metrics.counters()["host_syncs"]
    slates = sys_.n_slates
    with warnings.catch_warnings(), metrics.recording():
        warnings.simplefilter("always")
        warnings.showwarning = report
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(12, n):
                sys_.process(lefts[i], rights[i])
            sys_._dispatch_slate([(n - 1, 3, 0.0)])
            sys_._consume_verifications(force=True)
            sys_._run_pgo()
            sys_.loop_edge_rows()
            sys_.finalize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    delta = metrics.counters()["host_syncs"] - before
    spans = metrics.recorded()
    waits = [s for s in spans if s.name.startswith(metrics.WAIT)]
    assert sys_.n_slates > slates and waits
    assert all(t == main for t, _, _ in syncs)
    hidden = [(names, where) for _, names, where in syncs
              if not any(nm.startswith((metrics.WAIT, "host:capture.",
                                        "host:kernels."))
                         for _, nm in names)]
    assert not hidden, "\n\n".join(f"{n}\n{w}" for n, w in hidden)
    per_wait = {s.id: 0 for s in waits}
    for _, names, _ in syncs:
        for sid, nm in names:
            if sid in per_wait:
                per_wait[sid] += 1
    by_name = {}
    for s in waits:
        by_name.setdefault(s.name, []).append(per_wait[s.id])
    print(f"{len(syncs)} synchronizations reported, {len(waits)} waits, "
          f"host_syncs +{delta}: {by_name}")
    assert all(c <= 1 for c in per_wait.values()), by_name
    assert all(per_wait[s.id] == 1 for s in waits
               if s.name not in UNSEEN_WAITS), by_name
    assert len(waits) == delta
    assert {"host:wait.slate_inputs", "host:wait.pgo_inputs",
            "host:wait.loop_edge_inputs"} <= set(by_name)


def test_bundle_adjust_cuda_matches_cpu(cuda_device):
    """The seeded 6-camera, 120-point problem on CPU and on CUDA tensors:
    equal accept sequences, poses within 1e-4 m, costs within 1e-3
    relative; a second CUDA run gives the same poses bit for bit."""
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models import ba
    cfg = BAConfig(lm_iters=6)
    p, _, _, cam = synthetic.ba_problem(0, px_noise=0.3, n_outliers=40,
                                        device="cpu")
    out_c, cost_c, tr_c = ba.bundle_adjust(p, cam, cfg, return_trace=True)
    pg = ba.BAProblem(*[x.to(cuda_device) for x in p])
    out_g, cost_g, tr_g = ba.bundle_adjust(pg, cam.to(cuda_device), cfg,
                                           return_trace=True)
    assert tr_g.accept.tolist() == tr_c.accept.tolist()
    assert tr_g.n_obs.tolist() == tr_c.n_obs.tolist()
    assert (out_g.poses.cpu() - out_c.poses)[:, :3, 3].abs().max() <= 1e-4
    assert abs(float(cost_g) - float(cost_c)) <= 1e-3 * float(cost_c)
    out_g2, _ = ba.bundle_adjust(pg, cam.to(cuda_device), cfg)
    assert torch.equal(out_g2.poses, out_g.poses)
    assert torch.equal(out_g2.points, out_g.points)


def test_local_ba_step_makes_no_host_sync(cuda_device):
    """A windowed BA on a CUDA state under sync debug mode "error": any
    synchronising call raises. Its cost stays on the device."""
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=12, n_points=1200,
                                 trajectory="loop", image_hw=(h, w),
                                 speed=0.9, device=cuda_device)
    lefts, rights = synthetic.render_sequence(world, h, w)
    draws = pipeline.DrawSource(0, cuda_device)
    st = pipeline._init_state(lefts[0], rights[0], world.cam, cfg, draws)
    for i in range(1, 12):
        st, _, _ = pipeline.slam_step(st, lefts[i], rights[i], world.cam,
                                      cfg, draws)
    pipeline.local_ba_step(st, world.cam, cfg)            # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, cost = pipeline.local_ba_step(st, world.cam, cfg, end_kf=10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cost.is_cuda and cost.dim() == 0 and bool(torch.isfinite(cost))
    assert float((new.traj - st.traj).abs().max()) > 0
    assert torch.equal(new.traj[10:], st.traj[10:])


def _bits(x):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def test_backend_graphs_replay_without_syncs_equal_to_eager(cuda_device):
    """Local BA, a loop slate (with the batched Hamming launch) and a
    place query, each captured as a graph over a SlamSystem's step
    graph: a warm replay makes no host sync (sync debug mode "error")
    and equals one eager call of the same function on a copy of the same
    state to the bit, state and output alike, with the kernel's launch
    counted once per replay."""
    cfg = tiny_config()
    cfg = cfg.replace(bow=dataclasses.replace(cfg.bow, place_query=True))
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=12, n_points=1200,
                                 trajectory="loop", image_hw=(h, w),
                                 speed=0.9, device=cuda_device)
    lefts, rights = synthetic.render_sequence(world, h, w)
    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=8)
    sys_.process(lefts[0], rights[0])
    sys_.process_block(lefts[1:], rights[1:])
    step = sys_.step_graph
    kf_n = int(sys_.state.kf.n)

    def i64(v):
        return torch.full((), v, dtype=torch.int64, device=cuda_device)
    k = pipeline.SlamSystem.SLATE_K
    cs, hfs = [2, 3] + [-1] * (k - 2), [10, 11] + [0] * (k - 2)
    u = sys_.draws.slate(hfs, cs, 0, pipeline.LOOP_RANSAC_ITERS,
                         pipeline.KF_FEATURES)
    programs = {
        "local_ba": (pipeline._graphed_local_ba(world.cam, cfg),
                     (i64(kf_n - 1),), {}),
        "slate": (pipeline._graphed_slate(world.cam, cfg),
                  (u, torch.tensor(cs, device=cuda_device),
                   torch.tensor(hfs, device=cuda_device)),
                  {"hamming_top2_batched": 1}),
        "place_query": (pipeline._graphed_place_query(cfg, 128),
                        (i64(kf_n - 1), i64(6)), {}),
    }
    for name, (fn, args, launches) in programs.items():
        graph = StepGraph(fn, name, over=step)
        sys_.state, _ = graph(sys_.state, *args)     # warm-up + capture
        assert graph.launches == launches, name
        copy = unflatten(sys_.state, iter(
            [x.clone() for x in flatten(sys_.state)]))
        e_state, e_out = fn(copy, *args)
        before = cuda_kernels.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            g_state, g_out = graph(sys_.state, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        after = cuda_kernels.launch_counts()
        assert g_state is step._state_like, name
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == launches, name
        for a, b in zip(flatten((e_state, e_out)), flatten((g_state, g_out)),
                        strict=True):
            assert torch.equal(_bits(a), _bits(b)), name


def test_chain_kernels_captured_once_serve_every_live_count(cuda_device):
    """One chain_prepare + chain_sweep pair captured in a CUDA graph with
    the live count a 0-d int32 device tensor, replayed with three counts
    written into it: each replay equals the plain twins at that count;
    a count outside [1, F] makes x all NaN. The wrappers refuse a live
    count of another dtype or device."""
    f = 2048
    jj, ji, winv, v = [x.to(cuda_device)
                       for x in synthetic.chain_inputs(f, f, 7)]
    live = torch.full((), f, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # build, and the warm-up
        cuda_kernels.chain_sweep_cuda(jj, ji, winv, v, live)
    torch.cuda.current_stream().wait_stream(side)
    before = cuda_kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        prep = cuda_kernels.chain_prepare_cuda(jj, ji, live)
        x = cuda_kernels.chain_sweep_cuda(jj, ji, winv, v, live, prep=prep)
    for n in (601, 1, 2048):
        live.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        prep_p = cuda_kernels.chain_prepare_plain(jj, ji, n)
        assert torch.allclose(prep, prep_p, rtol=0, atol=1e-5), n
        xp = cuda_kernels.chain_sweep_plain(jj, ji, winv, v, n)
        assert torch.isfinite(x).all(), n
        assert (x - xp).abs().max().item() <= 1e-4 * xp.abs().max().item()
    for n in (0, f + 1):
        live.fill_(n)
        graph.replay()
        assert torch.isnan(x).all(), n
    after = cuda_kernels.launch_counts()
    assert after["chain_sweep"] - before["chain_sweep"] == 1
    assert after["chain_prepare"] - before["chain_prepare"] == 1
    with pytest.raises(TypeError):
        cuda_kernels.chain_sweep_cuda(jj, ji, winv, v, live.long())
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.chain_prepare_cuda(jj, ji, live.cpu())
    with pytest.raises(ValueError, match="n_live=0"):
        cuda_kernels.chain_sweep_cuda(jj, ji, winv, v, 0)


def test_pgo_graphs_replay_without_syncs_equal_to_eager(cuda_device):
    """The pose-graph relaxation of a SlamSystem with a step graph, as
    its programs pgo_build, pgo_gn (once per Gauss-Newton iteration) and
    pgo_apply, captured at the first call over the step graph's state: a
    warm relaxation makes no host sync (sync debug mode "error"), counts
    one chain_prepare per iteration and one chain_sweep per
    preconditioner application, and equals one eager `_pgo_step` on a
    copy of the same state to the bit, state and cost alike."""
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=12, n_points=1200,
                                 trajectory="loop", image_hw=(h, w),
                                 speed=0.9, device=cuda_device)
    lefts, rights = synthetic.render_sequence(world, h, w)
    sys_ = pipeline.SlamSystem(world.cam, cfg, bow_train_frame=8)
    sys_.process(lefts[0], rights[0])
    sys_.process_block(lefts[1:], rights[1:])
    step = sys_.step_graph
    cap = pipeline.MAX_LOOP_EDGES
    le = [torch.zeros(cap, dtype=torch.int64),
          torch.zeros(cap, dtype=torch.int64),
          torch.eye(4).repeat(cap, 1, 1), torch.zeros(cap)]
    gt = world.poses.cpu()
    le[1][0], le[3][0] = 11, 100.0               # the loop 0 -> 11
    le[2][0] = torch.linalg.inv(gt[0]) @ gt[11]
    le = [x.to(cuda_device) for x in le]
    bucket, iters, n_live = 512, 3, 12
    sys_._pgo(bucket, iters, n_live, *le)        # warm-ups + captures
    names = [f"pgo_{p}[{bucket}]" for p in ("build", "gn", "apply")]
    graphs = [sys_.backend_graphs[n] for n in names]
    assert all(g.over is step for g in graphs)
    assert graphs[1].launches == {"chain_prepare": 1,
                                  "chain_sweep": cfg.ba.cg_iters + 1}
    st = sys_.state
    copy = unflatten(st, iter([x.clone() for x in flatten(st)]))
    traj, t_w, kf_poses, xyz, e_cost = pipeline._pgo_step(
        copy.traj, copy.rel, copy.rel_mask, copy.kf.frame_of_row, *le,
        copy.frame, copy.map.xyz, copy.map.last_frame, copy.map.valid,
        bucket=bucket, iters=iters, cg_iters=cfg.ba.cg_iters, n_live=n_live)
    kf_sel = torch.where((copy.kf.frame_of_row >= 0)[:, None, None],
                         kf_poses, copy.kf.poses)
    before = cuda_kernels.launch_counts()
    replays = [g.replays for g in graphs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g_cost = sys_._pgo(bucket, iters, n_live, *le)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = cuda_kernels.launch_counts()
    assert sys_.state is step._state_like
    assert [g.replays - r for g, r in zip(graphs, replays)] == [1, iters, 1]
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {
        "chain_prepare": iters, "chain_sweep": iters * (cfg.ba.cg_iters + 1)}
    g = sys_.state
    for a, b in zip((traj, t_w, kf_sel, xyz, e_cost),
                    (g.traj, g.T_w_cam, g.kf.poses, g.map.xyz, g_cost),
                    strict=True):
        assert torch.equal(_bits(a), _bits(b))
    assert float((traj - copy.traj).abs().max()) > 0


@pytest.mark.parametrize("n_kf", [16, 32], ids=["dense", "cg"])
def test_global_ba_graphs_replay_without_syncs_equal_to_eager(cuda_device,
                                                              n_kf):
    """global_ba_step on a CUDA state (12 frames of the loop clip, one
    loop edge as a prior, the trace), on the dense and the CG path: the
    first call captures ba_build, ba_lm and ba_apply; a warm call makes
    no host sync (sync debug mode "error"), replays them once, lm_iters
    times and once, and equals two graphs=False calls, which equal each
    other, to the bit, state, cost and trace alike. The graduated cut
    made on the card equals the host's value."""
    from slam1_tpu_torch.models import ba
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=12, n_points=1200,
                                 trajectory="loop", image_hw=(h, w),
                                 speed=0.9, device=cuda_device)
    lefts, rights = synthetic.render_sequence(world, h, w)
    draws = pipeline.DrawSource(0, cuda_device)
    st = pipeline._init_state(lefts[0], rights[0], world.cam, cfg, draws)
    for i in range(1, 12):
        st, _, _ = pipeline.slam_step(st, lefts[i], rights[i], world.cam,
                                      cfg, draws)
    cap = pipeline.MAX_LOOP_EDGES
    le = [torch.zeros(cap, dtype=torch.int64),
          torch.zeros(cap, dtype=torch.int64),
          torch.eye(4).repeat(cap, 1, 1), torch.zeros(cap)]
    last = int(st.kf.n) - 1                     # the loop 0 -> last row,
    kf_poses = st.kf.poses.cpu()                # its measurement 5 cm off
    le[1][0], le[3][0] = last, 1000.0
    le[2][0] = torch.linalg.inv(kf_poses[0]) @ kf_poses[last]
    le[2][0, 0, 3] += 0.05
    le = tuple(x.to(cuda_device) for x in le)
    n_obs = int(st.map.obs_count[:n_kf].sum())
    bucket = 1 << max(int(np.ceil(np.log2(max(n_obs, 1)))), 10)

    def call(graphs=True):
        return pipeline.global_ba_step(st, world.cam, cfg, n_kf=n_kf,
                                       obs_bucket=bucket, return_trace=True,
                                       loop_rows=le, graphs=graphs)
    pipeline.GLOBAL_BA_GRAPHS.clear()
    eager, eager2 = call(False), call(False)
    captured = call()                           # warm-ups + captures
    (graphs,) = pipeline.GLOBAL_BA_GRAPHS.values()
    names = ("ba_build", "ba_lm", "ba_apply")
    replays = [graphs[n].replays for n in names]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphed = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [graphs[n].replays - r for n, r in zip(names, replays)] == [
        1, cfg.ba.lm_iters, 1]
    for other in (eager2, captured, graphed):
        for a, b in zip(flatten(eager), flatten(other), strict=True):
            assert torch.equal(_bits(a), _bits(b))
    assert bool(eager[2].accept.any())
    assert float((graphed[0].traj - st.traj).abs().max()) > 0
    steps = torch.arange(cfg.ba.lm_iters, device=cuda_device)
    for t in range(cfg.ba.lm_iters):
        cut = ba.graduated_cut(cfg.ba.outlier_px, steps[t], torch.float32)
        host = torch.full((), cfg.ba.outlier_px * max(1.0, 8.0 * 0.5 ** t))
        assert torch.equal(_bits(cut.cpu()), _bits(host)), t
    pipeline.GLOBAL_BA_GRAPHS.clear()


@pytest.mark.parametrize("n_live", [2, 8533, 8534, 12000])
def test_chain_sweep_cuda_past_shared_memory(cuda_device, n_live):
    """At 12000 poses, past the 8533 rows whose offsets one launch holds
    in shared memory, the sweep keeps them in device memory and equals
    its plain twin within 1e-4 of max |x| for every live count; 8533
    rows stay on the shared-memory path, and 8533 live rows give the
    same bits on both paths."""
    f = 12000
    most = cuda_kernels.build().chain_max_live
    assert most == 8533
    assert cuda_kernels.chain_sweep_staged(f)
    assert not cuda_kernels.chain_sweep_staged(most)
    ops = [x.to(cuda_device)
           for x in synthetic.chain_inputs(f, n_live, n_live)]
    before = cuda_kernels.launch_counts()
    xk = cuda_kernels.chain_sweep_cuda(*ops, n_live)
    xp = cuda_kernels.chain_sweep_plain(*ops, n_live)
    torch.cuda.synchronize()
    assert torch.isfinite(xk).all()
    assert (xk - xp).abs().max().item() <= 1e-4 * xp.abs().max().item()
    after = cuda_kernels.launch_counts()
    assert after["chain_sweep"] - before["chain_sweep"] == 1
    if n_live <= most:
        xs = cuda_kernels.chain_sweep_cuda(*[x[:most] for x in ops], n_live)
        assert torch.equal(_bits(xs), _bits(xk[:most]))
    live = torch.full((), f + 1, dtype=torch.int32, device=cuda_device)
    assert torch.isnan(cuda_kernels.chain_sweep_cuda(*ops, live)).all()


def _synced_call(fn):
    """fn() under sync debug mode "error": a host sync raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("live", ["none", "tensor"])
def test_optimize_graphs_replay_without_syncs_equal_to_eager(cuda_device,
                                                             live):
    """posegraph.optimize on the 600-pose two-lap graph: the first call
    captures pg_gn and pg_cost; a warm call makes no host sync, replays
    pg_gn `iters` times and pg_cost once with one chain_prepare per
    iteration and one chain_sweep per preconditioner application, and
    equals graphs=False to the bit, poses and cost."""
    from slam1_tpu_torch.models import posegraph
    graph = synthetic.loop2_graph(device=cuda_device)
    n = graph.poses.shape[0]
    n_live = (torch.full((), n, dtype=torch.int32, device=cuda_device)
              if live == "tensor" else None)
    kw = dict(iters=4, cg_iters=30, n_live=n_live)
    posegraph.POSEGRAPH_GRAPHS.clear()
    eager = posegraph.optimize(graph, graphs=False, **kw)
    captured = posegraph.optimize(graph, **kw)
    assert len(posegraph.POSEGRAPH_GRAPHS) == 2
    gn = next(g for k, g in posegraph.POSEGRAPH_GRAPHS.items()
              if k[0] == "pg_gn")
    assert gn.launches == {"chain_prepare": 1, "chain_sweep": 31}
    replays = gn.replays
    before = cuda_kernels.launch_counts()
    graphed = _synced_call(lambda: posegraph.optimize(graph, **kw))
    after = cuda_kernels.launch_counts()
    assert gn.replays - replays == 4
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"chain_prepare": 4,
                                          "chain_sweep": 4 * 31}
    for other in (captured, graphed):
        for a, b in zip(eager, other, strict=True):
            assert torch.equal(_bits(a), _bits(b))
    assert float((graphed[0] - graph.poses).abs().max()) > 1e-3
    posegraph.POSEGRAPH_GRAPHS.clear()


@pytest.mark.parametrize("n_cams", [6, 24], ids=["dense", "cg"])
def test_bundle_adjust_graphs_replay_without_syncs_equal_to_eager(
        cuda_device, n_cams):
    """ba.bundle_adjust on the seeded problem, dense and CG paths, with
    the trace: the first call captures ba_lm and ba_cost; a warm call
    makes no host sync, replays ba_lm lm_iters times and ba_cost once,
    and equals graphs=False to the bit, problem, cost and trace."""
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models import ba
    cfg = BAConfig(lm_iters=6, cg_iters=30)
    p, _, _, cam = synthetic.ba_problem(0, n_cams=n_cams, px_noise=0.3,
                                        n_outliers=40, device=cuda_device)

    def call(graphs=True):
        return ba.bundle_adjust(p, cam, cfg, return_trace=True,
                                graphs=graphs)
    ba.BA_GRAPHS.clear()
    eager = call(False)
    captured = call()
    (graphs,) = ba.BA_GRAPHS.values()
    replays = [graphs[n].replays for n in ("ba_lm", "ba_cost")]
    graphed = _synced_call(call)
    assert [graphs[n].replays - r for n, r in
            zip(("ba_lm", "ba_cost"), replays)] == [cfg.lm_iters, 1]
    for other in (captured, graphed):
        for a, b in zip(flatten(eager), flatten(other), strict=True):
            assert torch.equal(_bits(a), _bits(b))
    assert bool(eager[2].accept.any())
    ba.BA_GRAPHS.clear()


def _sharded_pgo_args(graph):
    """optimize_sharded's arguments from a synthetic.loop2_graph: its
    first F-1 edges chain the F poses (slot F-1 padding), the rest are
    loop edges."""
    f = graph.poses.shape[0]
    eye = torch.eye(4, device=graph.poses.device)
    return (graph.poses, torch.cat([graph.z[:f - 1], eye[None]]),
            torch.cat([graph.w[:f - 1], graph.w.new_zeros(1)]),
            graph.ei[f - 1:], graph.ej[f - 1:], graph.z[f - 1:],
            graph.w[f - 1:])


def test_dist_solvers_graphs_under_nccl_equal_to_eager(cuda_device):
    """At one rank over NCCL: distributed_bundle_adjust (trace, graduated
    cut) and optimize_sharded (600-pose two-lap graph) capture dba_lm /
    dba_cost and dpg_gn / dpg_cost at their first graphed call; a warm
    call makes no host sync, replays the iteration graph once per
    iteration and the end graph once, counts the same collectives in
    mesh.comm and the same chain launches as graphs=False, and equals
    it to the bit."""
    import torch.distributed as dist

    from slam1_tpu_torch import parallel
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.parallel import dist_ba, dist_pgo
    from slam1_tpu_torch.parallel import mesh as mesh_mod
    assert mesh_mod.init_multihost(device="cuda") == "nccl"
    try:
        mesh = mesh_mod.make_mesh(lm_axis=1, device="cuda")
        p, _, _, cam = synthetic.ba_problem(0, n_cams=24, px_noise=0.3,
                                            n_outliers=40,
                                            device=cuda_device)
        sp, _, _ = dist_ba.partition_problem_device(p, 1)
        cfg = BAConfig(lm_iters=6, cg_iters=30)
        graph = synthetic.loop2_graph(device=cuda_device)
        pargs = _sharded_pgo_args(graph)

        def ba_call(graphs=True):
            return dist_ba.distributed_bundle_adjust(
                sp, cam, cfg, mesh, return_trace=True, graphs=graphs)

        def pgo_call(graphs=True):
            return dist_pgo.optimize_sharded(
                *pargs, mesh=mesh, iters=4, cg_iters=30,
                n_live=graph.poses.shape[0], graphs=graphs)

        for call, cache, names, iters in (
                (ba_call, dist_ba.DIST_BA_GRAPHS, ("dba_lm", "dba_cost"),
                 cfg.lm_iters),
                (pgo_call, dist_pgo.DIST_PGO_GRAPHS, ("dpg_gn", "dpg_cost"),
                 4)):
            def counted(fn):
                mesh.comm.update({k: 0 for k in mesh.comm})
                before = cuda_kernels.launch_counts()
                out = fn()
                after = cuda_kernels.launch_counts()
                return out, dict(mesh.comm), {
                    k: after[k] - before[k] for k in after}
            eager, comm, launches = counted(lambda: call(False))
            captured, comm_c, launches_c = counted(call)
            (graphs,) = cache.values()
            replays = [graphs[n].replays for n in names]
            graphed, comm_g, launches_g = counted(lambda: _synced_call(call))
            assert [graphs[n].replays - r for n, r in
                    zip(names, replays)] == [iters, 1]
            assert comm["all_reduce_calls"] > 0
            assert comm_c == comm and comm_g == comm
            assert launches_c == launches and launches_g == launches
            for other in (captured, graphed):
                for a, b in zip(flatten(eager), flatten(other), strict=True):
                    assert torch.equal(_bits(a), _bits(b))
    finally:
        parallel.clear_graphs()
        dist.destroy_process_group()


def test_dist_solvers_stay_eager_under_gloo(cuda_device, monkeypatch):
    """Under gloo (ranks sharing a card) the sharded solvers on CUDA
    tensors never attempt a capture: both run eagerly and cache no
    graph."""
    import torch.distributed as dist

    from slam1_tpu_torch import parallel
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.parallel import dist_ba, dist_pgo
    from slam1_tpu_torch.parallel import mesh as mesh_mod

    def refuse(*args, **kwargs):
        raise AssertionError("a capture under gloo")
    monkeypatch.setattr(StepGraph, "_capture", refuse)
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = mesh_mod.make_mesh(lm_axis=1, device="cuda")
        assert mesh.backend == "gloo"
        p, _, _, cam = synthetic.ba_problem(0, n_cams=8, device=cuda_device)
        sp, _, _ = dist_ba.partition_problem_device(p, 1)
        _, cost = dist_ba.distributed_bundle_adjust(
            sp, cam, BAConfig(lm_iters=2, cg_iters=8), mesh)
        graph = synthetic.loop2_graph(device=cuda_device)
        _, pcost = dist_pgo.optimize_sharded(
            *_sharded_pgo_args(graph), mesh=mesh, iters=1, cg_iters=8)
        assert bool(torch.isfinite(cost)) and bool(torch.isfinite(pcost))
        assert not dist_ba.DIST_BA_GRAPHS and not dist_pgo.DIST_PGO_GRAPHS
    finally:
        parallel.clear_graphs()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# BA's reduced-system halves (csrc/ba_schur.cu)
# ---------------------------------------------------------------------------

# The kernels against their twins, per element, as a share of the terms'
# magnitude (the same halves in float64 on absolute values): each
# observation's float32 products round in another order (and without
# fused multiply-adds) than cuBLAS's or the CPU's einsum, ~6 roundings
# of 2^-24 each, then the float64 sums are associated in another order
# and rounded once; the landmark half's error carries into the camera
# half through v. ~2e-6 in all; 1e-5 leaves five times that.
SCHUR_TOL = 1e-5
# (observations, camera rows, cameras observed, landmark rows, cameras
# ascending, share of zero-weight rows): the benchmark cell's shape (1000
# of 2048 camera rows observed, 512 observations each) and small odd
# ones.
SCHUR_SHAPES = {"cell": (512000, 2048, 1000, 79000, True, 0.02),
                "odd-shuffled": (1001, 37, 31, 211, False, 0.1),
                "odd-empty-rows": (4099, 300, 157, 977, True, 0.0)}


def _schur_inputs(shape, seed, dev):
    o, c, live, n_l, ascending, zero = shape
    rng = np.random.default_rng(seed)
    cams = np.sort(rng.choice(c, live, replace=False))
    ci = cams[np.sort(rng.integers(0, live, o))]
    if not ascending:
        ci = rng.permutation(ci)
    li = rng.integers(0, n_l, o)
    W = rng.normal(0, 1, (o, 6, 3)).astype(np.float32)
    W[rng.random(o) < zero] = 0.0
    t = {k: torch.as_tensor(v).to(dev) for k, v in dict(
        ci=ci, li=li, W=W,
        hll_inv=rng.normal(0, 1, (n_l, 3, 3)).astype(np.float32),
        hcc=rng.normal(0, 1, (c, 6, 6)).astype(np.float32),
        x=rng.normal(0, 1, (c, 6)).astype(np.float32),
        a=rng.normal(0, 1, (n_l, 3)).astype(np.float32),
        b=rng.normal(0, 1, (c, 6)).astype(np.float32)).items()}
    return t


def _schur_magnitudes(t, order, x, a):
    """|terms| of both halves in float64 -> (m_v (L,3), m_out (C,6))."""
    ci, li = order.cam_idx, order.lm_idx
    n_l, c = t["hll_inv"].shape[0], t["hcc"].shape[0]
    W = t["W"].double().abs()
    m_t = torch.zeros((n_l, 3), dtype=torch.float64, device=W.device)
    if x is not None:
        m_t = seg_sum(n_l, li, torch.einsum(
            "oij,oi->oj", W, x.double().abs()[ci]))
    if a is not None:
        m_t = m_t + a.double().abs()
    m_v = torch.einsum("lij,lj->li", t["hll_inv"].double().abs(), m_t)
    m_y = seg_sum(c, ci, torch.einsum("oij,oj->oi", W,
                                                   m_v[li]))
    return m_v, m_y


@pytest.mark.parametrize("shape", list(SCHUR_SHAPES))
def test_ba_schur_halves_match_plain(cuda_device, shape):
    """Each half against its plain twin on the card, for every form the
    solver uses (the product: x alone, then Hcc and x; the right side: a
    alone, then b; the back-substitution: x and a), within SCHUR_TOL of
    the terms' magnitude; empty camera rows and landmarks give y = 0 and
    s = 0; a second call gives the same bits."""
    t = _schur_inputs(SCHUR_SHAPES[shape], 11, cuda_device)
    c, n_l = t["hcc"].shape[0], t["hll_inv"].shape[0]
    order = cuda_kernels.schur_order(t["ci"], t["li"], c, n_l, kernels=True)
    plain = cuda_kernels.SchurOrder(order.cam_idx, order.lm_idx)
    for x, a in ((t["x"], None), (None, t["a"]), (t["x"], t["a"])):
        args = (t["W"], t["hll_inv"])
        v_k = cuda_kernels.ba_schur_landmarks_cuda(*args, order, x=x, a=a)
        v_p = cuda_kernels.ba_schur_landmarks_plain(*args, plain, x=x, a=a)
        m_v, m_y = _schur_magnitudes(t, order, x, a)
        assert bool(((v_k - v_p).abs() <= SCHUR_TOL * m_v + 1e-30).all()), (
            x is None, a is None, float((v_k - v_p).abs().max()))
        again = cuda_kernels.ba_schur_landmarks_cuda(*args, order, x=x, a=a)
        assert torch.equal(_bits(again), _bits(v_k))
        if x is not None and a is not None:
            continue                      # the back-substitution ends here
        if x is not None:
            kw = dict(hcc=t["hcc"], x=x)
            m_out = torch.einsum("cij,cj->ci", t["hcc"].double().abs(),
                                 x.double().abs()) + m_y
        else:
            kw = dict(b=t["b"])
            m_out = t["b"].double().abs() + m_y
        # Both halves of the twin from the same v, so that the camera
        # half's own error is what is compared.
        out_k = cuda_kernels.ba_schur_cameras_cuda(t["W"], v_p, order, **kw)
        out_p = cuda_kernels.ba_schur_cameras_plain(t["W"], v_p, plain, **kw)
        assert bool(((out_k - out_p).abs() <= SCHUR_TOL * m_out
                     + 1e-30).all()), (
            x is None, float((out_k - out_p).abs().max()))
        gauge = x[0] if x is not None else torch.zeros_like(out_k[0])
        assert torch.equal(out_k[0], gauge)
        again = cuda_kernels.ba_schur_cameras_cuda(t["W"], v_p, order, **kw)
        assert torch.equal(_bits(again), _bits(out_k))
        lone = torch.bincount(t["ci"], minlength=c) == 0
        lone[0] = False
        h = (torch.einsum("cij,cj->ci", t["hcc"], x) if x is not None
             else t["b"])
        assert bool(lone.any())
        assert bool(((out_k[lone] - h[lone]).abs()
                     <= SCHUR_TOL * m_out[lone]).all())
        v_lone = cuda_kernels.ba_schur_landmarks_cuda(t["W"], t["hll_inv"],
                                                      order, x=t["x"])
        lone_l = torch.bincount(t["li"], minlength=n_l) == 0
        assert bool((v_lone[lone_l] == 0).all())


def test_ba_schur_leaves_zero_blocks_out(cuda_device):
    """Orderings made with W leave out the observations whose block is
    zero: here a bucket's 20 000 padded rows, all on camera 0 and
    landmark 0, as `build_global_problem` pads. Both halves give the
    bits they give over every row, in every form."""
    t = _schur_inputs(SCHUR_SHAPES["odd-empty-rows"], 12, cuda_device)
    c, n_l = t["hcc"].shape[0], t["hll_inv"].shape[0]
    pad = 20000
    zeros = torch.zeros(pad, dtype=torch.int64, device=cuda_device)
    W = torch.cat([t["W"], torch.zeros((pad, 6, 3), device=cuda_device)])
    ci, li = torch.cat([t["ci"], zeros]), torch.cat([t["li"], zeros])
    every = cuda_kernels.schur_order(ci, li, c, n_l, kernels=True)
    order = cuda_kernels.schur_order(ci, li, c, n_l, kernels=True, W=W)
    assert int(order.lm_off[-1]) == int(order.cam_off[-1]) <= ci.shape[0] - pad
    for lm_kw, cam_kw in ((dict(x=t["x"]), dict(hcc=t["hcc"], x=t["x"])),
                          (dict(a=t["a"]), dict(b=t["b"])),
                          (dict(x=t["x"], a=t["a"]), None)):
        v = [cuda_kernels.ba_schur_landmarks_cuda(W, t["hll_inv"], o,
                                                  **lm_kw)
             for o in (order, every)]
        assert torch.equal(_bits(v[0]), _bits(v[1]))
        if cam_kw is not None:
            out = [cuda_kernels.ba_schur_cameras_cuda(W, v[1], o, **cam_kw)
                   for o in (order, every)]
            assert torch.equal(_bits(out[0]), _bits(out[1]))


def test_ba_schur_launches_per_ba_lm_replay(cuda_device):
    """One `ba_lm` replay on the CG path launches the halves 2 (cg_iters
    + 1) + 3 times: two per product (cg_iters + 1 products), two for the
    right side, one for the back-substitution; the eager iteration
    launches as many, and the dense path (C <= 16) none."""
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models import ba
    cfg = BAConfig(lm_iters=3, cg_iters=10)
    per_iter = 2 * (cfg.cg_iters + 1) + 3

    def launches(n_cams, graphs):
        p, _, _, cam = synthetic.ba_problem(0, n_cams=n_cams, px_noise=0.3,
                                            n_outliers=10, device=cuda_device)
        ba.bundle_adjust(p, cam, cfg, graphs=graphs)          # warm
        before = cuda_kernels.launch_counts()["ba_schur"]
        ba.bundle_adjust(p, cam, cfg, graphs=graphs)
        torch.cuda.synchronize()
        return cuda_kernels.launch_counts()["ba_schur"] - before
    ba.BA_GRAPHS.clear()
    try:
        assert launches(24, True) == cfg.lm_iters * per_iter
        assert launches(24, False) == cfg.lm_iters * per_iter
        assert launches(6, True) == 0
    finally:
        ba.BA_GRAPHS.clear()


def test_bundle_adjust_cg_cuda_matches_cpu(cuda_device):
    """The seeded 24-camera problem on the CG path, on the CPU (the
    twins) and on CUDA tensors (the halves' kernels), for 4 LM
    iterations: equal accept decisions and surviving observations, poses
    within 1e-4 m, costs within 1e-3 relative. From the 5th iteration on
    the cost ties the one before within 1e-6 (converged), where a strict
    compare of two float32 sums may fall either way, so the run stops
    before; the CPU trace is checked to hold no such tie."""
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.models import ba
    cfg = BAConfig(lm_iters=4)
    p, _, _, cam = synthetic.ba_problem(0, n_cams=24, px_noise=0.3,
                                        n_outliers=40, device="cpu")
    out_c, cost_c, tr_c = ba.bundle_adjust(p, cam, cfg, return_trace=True)
    pg = ba.BAProblem(*[x.to(cuda_device) for x in p])
    out_g, cost_g, tr_g = ba.bundle_adjust(pg, cam.to(cuda_device), cfg,
                                           return_trace=True)
    ba.BA_GRAPHS.clear()
    c = tr_c.cost.double()
    assert not bool(((c[1:] - c[:-1]).abs() <= 1e-6 * c[1:]).any())
    assert tr_g.accept.tolist() == tr_c.accept.tolist()
    assert tr_g.n_obs.tolist() == tr_c.n_obs.tolist()
    assert (out_g.poses.cpu() - out_c.poses)[:, :3, 3].abs().max() <= 1e-4
    assert abs(float(cost_g) - float(cost_c)) <= 1e-3 * float(cost_c)
