"""The algebra of the redesigned CUDA kernels, on the CPU.

The kernels themselves run only on a card (tests/test_torch_kernels_cuda.py
and chip_smoke.py hold them against their plain twins there). What can be
checked here is that their reformulations compute the same function:

  - chain sweep: `chain_sweep_fused_plain` mirrors csrc/chain_sweep.cu
    (6x6 blocks fused and doubled once per Gauss-Newton iteration,
    offsets computed for all rows at once and doubled, then 8
    interleaved chains of one product per row). It is held
    against `chain_sweep_plain` and the JAX `_chain_sqrt_solve` within
    1e-4 of max |x|, the tolerance chip_smoke.py holds the kernel to:
    fusing re-associates float32 products, which moves the result by
    1e-6..1e-5 relative on these operands and not at all in exact
    arithmetic.
  - Hamming top-2: `tiled_top2` below mirrors csrc/hamming_top2.cu's
    epilogue: distances from popc(a) + popc(b) - 2 popc(a & b), an
    invalid row or column carrying 2^21 in its popcount, per-tile
    partials as (distance, index) keys, merged in an arbitrary order.
    Integers only, so it must equal `hamming_top2_plain` exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.models import posegraph as jpg
from slam1_tpu_torch import runtime
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline as tpipe
from slam1_tpu_torch.models import posegraph as tpg
from slam1_tpu_torch.ops import cuda_kernels, dispatch
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.utils import synthetic as tsyn
from slam1_tpu_torch.utils.synthetic import chain_inputs, loop2_graph
from torch_threads import one_torch_thread  # noqa: F401

CHAIN_TOL = 1e-4             # max |a - b| / max |b|, as chip_smoke.py
BIG = 1 << 20


# ----------------------------------------------------------- chain sweep

def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _check_chain(jj, ji, winv, v, n_live):
    plain = cuda_kernels.chain_sweep_plain(jj, ji, winv, v, n_live)
    fused = cuda_kernels.chain_sweep_fused_plain(jj, ji, winv, v, n_live)
    ref = torch.as_tensor(np.array(jpg._chain_sqrt_solve(
        *[jnp.asarray(x.numpy()) for x in (jj, ji, winv, v)])))
    assert torch.isfinite(fused).all()
    assert _rel(fused, plain) <= CHAIN_TOL
    assert _rel(fused, ref) <= CHAIN_TOL
    assert _rel(plain, ref) <= CHAIN_TOL
    return fused


@pytest.mark.parametrize("n_live", [1, 2, 601, 2048])
def test_chain_fused_mirror_on_chain_inputs(n_live):
    ops = chain_inputs(2048, n_live, n_live)
    x = _check_chain(*ops, n_live)
    assert torch.equal(x[0], torch.zeros(6))
    assert torch.equal(x[n_live:], ops[2][n_live:, None] * ops[3][n_live:])


@pytest.mark.parametrize("f,n_live", [
    (40, 3), (40, 4), (40, 5), (40, 6), (40, 8), (40, 9), (40, 10), (40, 16),
    (40, 17), (40, 18), (40, 25), (40, 40), (64, 33), (300, 129), (300, 299),
    (300, 300)])
def test_chain_fused_mirror_around_the_stride(f, n_live):
    """Live rows fewer than, equal to and more than the 8 interleaved
    chains and the strides 1, 2, 4 of the doublings, and ragged last
    turns of the march."""
    ops = chain_inputs(f, n_live, f + n_live)
    x = _check_chain(*ops, n_live)
    assert torch.equal(x[0], torch.zeros(6))
    assert torch.equal(x[n_live:], ops[2][n_live:, None] * ops[3][n_live:])


def test_chain_prepare_plain_blocks():
    jj, ji, _, _ = chain_inputs(40, 25, 7)
    prep = cuda_kernels.chain_prepare_plain(jj, ji, 25)
    assert prep.shape == (cuda_kernels.CHAIN_LEVELS, 2, 40, 6, 6)
    assert not prep[:, :, 0].any() and not prep[:, :, 25:].any()
    back, fwd = prep[0]
    np.testing.assert_allclose(back[10], -jj[10].T @ ji[11].T, atol=1e-6)
    np.testing.assert_allclose(fwd[10], -jj[10] @ ji[10], atol=1e-6)
    assert not back[24].any()              # Ji_{n_live} counts as 0
    assert not fwd[1].any()                # x_0 = 0 takes no block
    np.testing.assert_allclose(fwd[24], -jj[24] @ ji[24], atol=1e-6)
    # Level 1 steps two rows, level 2 four; a step that leaves the live
    # rows has no block.
    np.testing.assert_allclose(prep[1, 0, 10], back[10] @ back[11], atol=1e-6)
    np.testing.assert_allclose(prep[1, 1, 10], fwd[10] @ fwd[9], atol=1e-6)
    np.testing.assert_allclose(prep[2, 1, 10],
                               fwd[10] @ fwd[9] @ fwd[8] @ fwd[7], atol=1e-5)
    assert not prep[1, 0, 24].any() and not prep[2, 0, 21:].any()
    assert not prep[1, 1, 1:3].any() and not prep[2, 1, 1:5].any()
    assert prep[2, 0, 20].any() and prep[2, 1, 5].any()
    np.testing.assert_allclose(prep[3, 0, 10], prep[2, 0, 10] @ prep[2, 0, 14],
                               atol=1e-5)
    assert not prep[3, 0, 17:].any() and not prep[3, 1, 1:9].any()
    assert prep[3, 0, 16].any() and prep[3, 1, 9].any()


def test_chain_fused_mirror_on_loop2_linearisation():
    graph = loop2_graph(device="cpu")
    jj_inv, ji_c, winv = tpg.chain_operands(graph)
    f = graph.poses.shape[0]
    v = torch.as_tensor(np.random.default_rng(1).normal(size=(f, 6)),
                        dtype=torch.float32)
    _check_chain(jj_inv, ji_c, winv, v, f)
    # ... and as the first right-hand side CG hands it: the gradient.
    r0, Ji, Jj = tpg._linearize(graph, graph.poses)
    rw = r0 * graph.w[:, None]
    b = torch.zeros(f, 6).index_add_(
        0, graph.ei, torch.einsum("eab,ea->eb", Ji, rw)).index_add_(
        0, graph.ej, torch.einsum("eab,ea->eb", Jj, rw))
    _check_chain(jj_inv, ji_c, winv, -b, f)


@pytest.fixture(scope="module")
def loop_clip_system():
    """The port's SlamSystem after the 36-frame loop clip (tiny config,
    local BA off), on the CPU."""
    cfg = tiny_config()
    cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, local_every=0))
    h, w = cfg.image.height, cfg.image.width
    world = tsyn.make_world(3, n_frames=36, n_points=1200, trajectory="loop",
                            image_hw=(h, w), speed=0.9, device="cpu")
    lefts, rights = tsyn.render_sequence(world, h, w)
    sys_ = tpipe.SlamSystem(world.cam, cfg, bow_train_frame=8)
    for i in range(36):
        sys_.process(lefts[i], rights[i])
    return sys_


@pytest.mark.parametrize("when", ["before_finalize", "after_finalize"])
def test_chain_fused_mirror_on_loop_clip_linearisation(loop_clip_system,
                                                       when):
    sys_ = loop_clip_system
    poses = sys_.poses() if when == "before_finalize" else sys_.finalize()
    graph = sys_.pose_graph(poses)
    jj_inv, ji_c, winv = tpg.chain_operands(graph)
    f = graph.poses.shape[0]
    v = torch.as_tensor(np.random.default_rng(2).normal(size=(f, 6)),
                        dtype=torch.float32)
    for n_live in (f, f - 7):
        jj, ji, wi = jj_inv.clone(), ji_c.clone(), winv.clone()
        jj[n_live:], ji[n_live:] = torch.eye(6), 0.0
        _check_chain(jj, ji, wi, v, n_live)


def test_chain_prepare_builds_nothing_on_cpu():
    jj, ji, _, _ = chain_inputs(16, 16, 0)
    assert dispatch.chain_prepare(jj, ji, 16) is None


# ---------------------------------------------------------- Hamming top-2

def _popc(x):
    return np.unpackbits(x, axis=-1).sum(-1).astype(np.int64)


def _merge_top2(k1, k2, o1, o2):
    """Two smallest keys of the union of two (k1 <= k2) pairs, as
    merge_top2 in csrc/hamming_top2.cu."""
    return np.minimum(k1, o1), np.minimum(np.maximum(k1, o1),
                                          np.minimum(k2, o2))


def tiled_top2(da, db, ma, mb, rng, uv_a=None, uv_b=None, dy_tol=None,
               dx_lo=0.0, dx_hi=0.0, rows_per_tile=16, cols_per_tile=8):
    """The kernel's epilogue in numpy: (d1, d2, idx, col_best)."""
    n, m = da.shape[0], db.shape[0]
    pa = np.where(ma, _popc(da), 1 << 21)
    pb = np.where(mb, _popc(db), 1 << 21)
    both = _popc(da[:, None, :] & db[None, :, :])
    d = pa[:, None] + pb[None, :] - 2 * both
    if uv_a is not None:
        dy = np.abs(uv_b[None, :, 1] - uv_a[:, 1:2])
        dx = uv_a[:, 0:1] - uv_b[None, :, 0]
        d = np.where((dy > np.float32(dy_tol)) | (dx < np.float32(dx_lo))
                     | (dx > np.float32(dx_hi)), BIG, d)
    dc = np.minimum(d, 511).astype(np.uint32)
    rowkey = (dc << np.uint32(22)) | np.arange(m, dtype=np.uint32)[None, :]
    colkey = (dc << np.uint32(23)) | np.arange(n, dtype=np.uint32)[:, None]
    none = np.uint32(0xffffffff)
    k1 = np.full(n, none)
    k2 = np.full(n, none)
    starts = np.arange(0, m, cols_per_tile)
    for c0 in rng.permutation(starts):
        tile = np.sort(rowkey[:, c0:c0 + cols_per_tile], axis=1)
        o1 = tile[:, 0]
        o2 = tile[:, 1] if tile.shape[1] > 1 else np.full(n, none)
        k1, k2 = _merge_top2(k1, k2, o1, o2)
    ck = np.full(m, none)
    for r0 in rng.permutation(np.arange(0, n, rows_per_tile)):
        ck = np.minimum(ck, colkey[r0:r0 + rows_per_tile].min(axis=0))

    def dist(key, bits):
        dd = (key >> np.uint32(bits)).astype(np.int64)
        return np.where(dd >= 511, BIG, dd)

    return (dist(k1, 22), dist(k2, 22),
            (k1 & np.uint32((1 << 22) - 1)).astype(np.int64),
            (ck & np.uint32((1 << 23) - 1)).astype(np.int64))


def _hamming_inputs(seed, n, m, dup):
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    db = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    if dup:
        # Equal columns on both sides of the tile boundaries (7 | 8,
        # 15 | 16, 127 | 128, 207 | 208), rows that match them exactly,
        # and equal rows across 16- and 128-row boundaries.
        for j in (1, 7, 8, 15, 16, 127, 128, 207, 208, m - 1):
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


def test_popcount_identity_equals_distance_matrix():
    da, db, _, _, _, _ = _hamming_inputs(0, 130, 257, True)
    d = (_popc(da)[:, None] + _popc(db)[None, :]
         - 2 * _popc(da[:, None, :] & db[None, :, :]))
    ref = cuda_kernels.distance_matrix(torch.as_tensor(da),
                                       torch.as_tensor(db))
    np.testing.assert_array_equal(d, ref.numpy())


GATES = {"ungated": {}, "epipolar": dict(dy_tol=10.0, dx_lo=0.5, dx_hi=40.0),
         "window": dict(dy_tol=12.0, dx_lo=-12.0, dx_hi=12.0)}


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("dup", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n,m", [(1, 2), (130, 257), (300, 77), (512, 512)])
def test_tiled_top2_merge_equals_plain(n, m, dup, gate):
    da, db, ma, mb, uva, uvb = _hamming_inputs(n + m, n, m, dup)
    kw = GATES[gate]
    nkw = dict(uv_a=uva, uv_b=uvb, **kw) if kw else {}
    tkw = dict(uv_a=torch.as_tensor(uva), uv_b=torch.as_tensor(uvb),
               **kw) if kw else {}
    ref = cuda_kernels.hamming_top2_plain(
        torch.as_tensor(da), torch.as_tensor(db), torch.as_tensor(ma),
        torch.as_tensor(mb), **tkw)
    for order in range(2):                 # two merge orders
        out = tiled_top2(da, db, ma, mb, np.random.default_rng(order), **nkw)
        for name, o, r in zip(("d1", "d2", "idx", "col_best"), out, ref):
            np.testing.assert_array_equal(o, r.numpy(), err_msg=name)
    if dup and not kw:
        assert (ref[0] == ref[1]).sum() > 0          # ties were exercised


@pytest.mark.parametrize("za,zb", [(True, False), (False, True), (True, True)])
def test_tiled_top2_all_invalid_gives_sentinel_and_index_zero(za, zb):
    da, db, ma, mb, _, _ = _hamming_inputs(3, 40, 50, False)
    ma = np.zeros_like(ma) if za else ma
    mb = np.zeros_like(mb) if zb else mb
    d1, d2, idx, col_best = tiled_top2(da, db, ma, mb,
                                       np.random.default_rng(0))
    ref = cuda_kernels.hamming_top2_plain(*[torch.as_tensor(x) for x in
                                            (da, db, ma, mb)])
    for o, r in zip((d1, d2, idx, col_best), ref):
        np.testing.assert_array_equal(o, r.numpy())
    assert (d1[~ma] == BIG).all() and (idx[~ma] == 0).all()
    if zb:
        assert (d1 == BIG).all() and (d2 == BIG).all() and (idx == 0).all()


@pytest.mark.parametrize("n,m,problems", [(2688, 2688, 1), (1024, 1024, 8),
                                          (1, 2, 1), (16, 5000, 1),
                                          (300, 100000, 1)])
def test_column_strips_fill_the_card_and_fit_the_kernel(n, m, problems):
    cols, words = cuda_kernels._column_strips(n, m, problems)
    splits = -(-m // cols)
    row_blocks = -(-n // 128)
    assert cols % 8 == 0 and 8 <= cols <= 512
    assert cols * (splits - 1) < m <= cols * splits      # no empty strip
    if m >= 8 * 264:                       # a block or more on every SM
        assert row_blocks * splits * problems >= 132
    head = problems * (m + row_blocks + 1)
    assert words == head + head % 2 + 2 * problems * splits * n


# --------------------------------------------------------- default device

def test_constructors_default_to_the_card_when_there_is_one(monkeypatch):
    assert runtime.default_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # No card: device=None raises; nothing falls back to the CPU.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runtime.default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StereoCamera.kitti_default()
    assert StereoCamera.kitti_default(device="cpu").fx.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert runtime.default_device() == torch.device("cuda")
    assert runtime.default_device("cpu") == torch.device("cpu")
    assert StereoCamera.kitti_default(device="cpu").fx.device.type == "cpu"
