"""Loop verification, place recognition, the batched Hamming twin, the
chain-sweep twin and pose-graph optimisation of the port against the
JAX package, on the same numpy inputs and the reference's own draws.

Tolerances: loop verification `ok`, `num_inliers` and anchors
identical, T within 1e-4; place_query identical (its scores are exact
integer counts); the chain sweep within 1e-5 (another summation order
of the 6x6 products); PGO poses within 1e-4 m and 1e-5 rad (float32
Gauss-Newton over 30 poses, jacfwd in two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.config import tiny_config as jtiny
from slam1_tpu.models import loop_closure as jlc
from slam1_tpu.models import mapping as jmap
from slam1_tpu.models import posegraph as jpg
from slam1_tpu.ops import se3 as jse3
from slam1_tpu.ops.camera import StereoCamera as JCam
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import loop_closure as tlc
from slam1_tpu_torch.models import posegraph as tpg
from slam1_tpu_torch.ops import cuda_kernels
from slam1_tpu_torch.utils import interop
from torch_threads import one_torch_thread  # noqa: F401


def t(a):
    return torch.as_tensor(np.array(a))


def rot_angle(Ra, Rb):
    M = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    v = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(v))))


# ------------------------------------------------------- batched Hamming

def test_hamming_top2_batched_plain_equals_single_calls():
    """Batched twin == B single calls, with an all-invalid (padded)
    problem and duplicated descriptors (ties)."""
    rng = np.random.default_rng(4)
    b, n, m = 5, 96, 80
    da = rng.integers(0, 256, (b, n, 32), dtype=np.uint8)
    db = rng.integers(0, 256, (b, m, 32), dtype=np.uint8)
    da[1, 1::2] = da[1, 0::2]
    db[1, : n // 2 - 8] = da[1, : n // 2 - 8]
    ma = rng.random((b, n)) > 0.2
    mb = rng.random((b, m)) > 0.2
    ma[3] = False
    mb[3] = False
    out = cuda_kernels.hamming_top2_batched_plain(t(da), t(db), t(ma), t(mb))
    for i in range(b):
        single = cuda_kernels.hamming_top2_plain(t(da[i]), t(db[i]),
                                                 t(ma[i]), t(mb[i]))
        for a, s in zip(out, single):
            assert torch.equal(a[i], s)
    d1, d2, idx, _ = [o[3] for o in out]
    assert (d1 == 1 << 20).all() and (d2 == 1 << 20).all()
    assert (idx == 0).all()


# ----------------------------------------------------- loop verification

K_SNAP = 64


def _snapshot_store(seed=0, n_rows=6):
    """A keyframe store whose rows re-observe one shared point set under
    known motions (the first 40 snapshot slots), plus clutter."""
    rng = np.random.default_rng(seed)
    cfg = jtiny()
    cam = JCam.for_canvas(cfg.image.height, cfg.image.width)
    X0 = np.stack([rng.uniform(-6, 6, 60), rng.uniform(-3, 3, 60),
                   rng.uniform(6, 20, 60)], -1).astype(np.float32)
    d0 = rng.integers(0, 256, (60, 32), dtype=np.uint8)
    st = jax.device_get(jmap.init_kf_store(16, K_SNAP))
    st = st._replace(**{f: np.array(getattr(st, f)) for f in st._fields})
    for r in range(n_rows):
        T = np.asarray(jse3.exp_se3(jnp.asarray(
            [0.05 * r, 0.0, 0.3 * r, 0.0, 0.01 * r, 0.0], jnp.float32)))
        Xc = X0 @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                       cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1)
        perm = rng.permutation(60)[:40]
        xyz = np.concatenate([Xc[perm], rng.normal(0, 5, (24, 3))])
        uvs = np.concatenate([uv[perm] + rng.normal(0, 0.3, (40, 2)),
                              rng.uniform(0, 200, (24, 2))])
        desc = np.concatenate([d0[perm], rng.integers(0, 256, (24, 32),
                                                      dtype=np.uint8)])
        desc[rng.random(64) < 0.1, 0] ^= 0xFF
        st.xyz[r], st.uv[r], st.desc[r] = xyz, uvs, desc
        st.mask[r] = rng.random(64) > 0.1
        st.frame_of_row[r] = 3 * r
        st.row_of_frame[3 * r] = r
    st = st._replace(n=np.int32(n_rows))
    return cfg, cam, st


def _slate_inputs():
    """(cfg, cam, store, cands, hits, keys, u): a snapshot store, a slate
    of (cand, hit) pairs and the reference's keys and draws."""
    cfg, cam, st = _snapshot_store()
    # (cand, hit): genuine pairs, an anchor equal to the candidate, a hit
    # before every keyframe, and a padded entry.
    cands = np.array([0, 3, 9, 15, 6, 12, 0, -1], np.int32)
    hits = np.array([14, 10, 16, 4, 7, 12, -3, 0], np.int32)
    base = jax.random.PRNGKey(0x5a5a)
    keys = jnp.stack([jax.random.fold_in(base, i) for i in range(8)])
    u = np.stack([np.array(jax.random.uniform(k, (1024, K_SNAP),
                                              minval=1e-9, maxval=1.0))
                  for k in keys])
    return cfg, cam, st, cands, hits, keys, u


@pytest.fixture(scope="module")
def slate():
    cfg, cam, st, cands, hits, keys, u = _slate_inputs()
    jres = jlc.verify_loop_slate(keys, jax.tree.map(jnp.asarray, st),
                                 jnp.asarray(cands), jnp.asarray(hits), cam,
                                 cfg)
    tres = tlc.verify_loop_slate(t(u), interop.kf_store(st, "cpu"),
                                 t(cands), t(hits),
                                 interop.camera(cam, "cpu"), tiny_config())
    return cfg, cam, st, cands, hits, keys, u, jax.device_get(jres), tres


def test_verify_loop_slate_matches_jax(slate):
    *_, jres, tres = slate
    np.testing.assert_array_equal(tres.ok.numpy(), np.asarray(jres.ok))
    np.testing.assert_array_equal(tres.num_inliers.numpy(),
                                  np.asarray(jres.num_inliers))
    np.testing.assert_array_equal(tres.anchor_frame.numpy(),
                                  np.asarray(jres.anchor_frame))
    np.testing.assert_allclose(tres.T_anchor_cand.numpy(),
                               np.asarray(jres.T_anchor_cand), rtol=0,
                               atol=1e-4)
    ok = tres.ok.numpy()
    assert ok[:4].sum() >= 2 and not ok[4:].any()


@pytest.mark.parametrize("i", [0, 2, 7])
def test_verify_loop_pair_matches_jax(slate, i):
    cfg, cam, st, cands, hits, keys, u, jres, tres = slate
    jp = jlc.verify_loop_pair(keys[i], jax.tree.map(jnp.asarray, st),
                              int(cands[i]), int(hits[i]), cam, cfg)
    tp = tlc.verify_loop_pair(t(u[i]), interop.kf_store(st, "cpu"),
                              int(cands[i]), int(hits[i]),
                              interop.camera(cam, "cpu"), tiny_config())
    assert bool(tp.ok) == bool(jp.ok)
    assert int(tp.num_inliers) == int(jp.num_inliers)
    assert int(tp.anchor_frame) == int(jp.anchor_frame)
    np.testing.assert_allclose(tp.T_anchor_cand.numpy(),
                               np.asarray(jp.T_anchor_cand), rtol=0,
                               atol=1e-4)


# --------------------------------------------------------- place query

def _place_store(seed):
    """A 16-row keyframe store whose rows 2, 3 and 9 share most of the
    query row 13's descriptors."""
    rng = np.random.default_rng(seed)
    st = jax.device_get(jmap.init_kf_store(16, K_SNAP))
    st = st._replace(**{f: np.array(getattr(st, f)) for f in st._fields})
    q = rng.integers(0, 256, (K_SNAP, 32), dtype=np.uint8)
    for r in range(14):
        d = rng.integers(0, 256, (K_SNAP, 32), dtype=np.uint8)
        share = rng.random(K_SNAP) < (0.6 if r in (2, 3, 9) else 0.05)
        d[share] = q[share]
        d[share, 1] ^= 3
        st.desc[r] = d
        st.mask[r] = rng.random(K_SNAP) > 0.1
        st.frame_of_row[r] = 10 * r
    st.desc[13] = q
    st.mask[13] = True
    return st._replace(n=np.int32(14))


@pytest.mark.parametrize("n_rows,max_frame", [(8, 40), (16, 30), (16, 200)])
def test_place_query_matches_jax(n_rows, max_frame):
    st = _place_store(n_rows + max_frame)
    cj, sj = jlc.place_query(jax.tree.map(jnp.asarray, st), 13, max_frame,
                             n_rows, k=3, thresh=32, nms_frames=15)
    ct, sc = tlc.place_query(interop.kf_store(st, "cpu"), 13, max_frame,
                             n_rows, k=3, thresh=32, nms_frames=15)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sj))
    assert (ct.numpy() >= 0).any()


# --------------------------------------------------------- chain sweep

@pytest.mark.parametrize("n_live", [20, 13])
def test_chain_sweep_plain_matches_jax(n_live):
    f = 20
    rng = np.random.default_rng(n_live)
    jj = (np.eye(6) + 0.1 * rng.normal(size=(f, 6, 6))).astype(np.float32)
    ji = (0.3 * rng.normal(size=(f, 6, 6))).astype(np.float32)
    winv = rng.uniform(0.5, 2.0, f).astype(np.float32)
    jj[n_live:] = np.eye(6)              # decoupled rows past n_live
    ji[n_live:] = 0.0
    winv[n_live:] = 1e4
    v = rng.normal(size=(f, 6)).astype(np.float32)
    ref = np.asarray(jpg._chain_sqrt_solve(jnp.asarray(jj), jnp.asarray(ji),
                                           jnp.asarray(winv),
                                           jnp.asarray(v)))
    out = tpg._chain_sqrt_solve(t(jj), t(ji), t(winv), t(v),
                                n_live=n_live).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- PGO

def make_loop_problem(n=30, drift=0.02):
    """Circle with forward-biased odometry and one loop edge (last ->
    first), as tests/test_posegraph.py builds it."""
    yaw = 2 * np.pi / n
    xi_true = np.array([0.0, 0.0, 1.0, 0.0, yaw, 0.0], np.float32)
    step = np.asarray(jse3.exp_se3(jnp.asarray(xi_true)))
    T_true = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        T_true.append(T_true[-1] @ step)
    T_true = np.stack(T_true)
    xi_odo = np.tile(xi_true, (n - 1, 1))
    xi_odo[:, 2] += drift
    z = np.asarray(jse3.exp_se3(jnp.asarray(xi_odo)))
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(n - 1):
        poses.append(poses[-1] @ z[i])
    poses = np.stack(poses).astype(np.float32)
    ei = np.concatenate([np.arange(n - 1), [0]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, n), [n - 1]]).astype(np.int32)
    z_loop = np.linalg.inv(T_true[0]) @ T_true[-1]
    z = np.concatenate([z, z_loop[None]]).astype(np.float32)
    w = np.concatenate([np.ones(n - 1), [100.0]]).astype(np.float32)
    return (poses, ei, ej, z, w), T_true


@pytest.mark.parametrize("drift,iters", [(0.02, 6), (0.0, 3)])
def test_pgo_optimize_matches_jax(drift, iters):
    (poses, ei, ej, z, w), T_true = make_loop_problem(drift=drift)
    jg = jpg.PoseGraph(*[jnp.asarray(a) for a in (poses, ei, ej, z, w)])
    pj, cj = jpg.optimize(jg, iters=iters, cg_iters=40)
    pt, ct = tpg.optimize(tpg.PoseGraph(*[t(a) for a in
                                          (poses, ei, ej, z, w)]),
                          iters=iters, cg_iters=40)
    pj, pt = np.asarray(pj), pt.numpy()
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], rtol=0, atol=1e-4)
    assert max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(pj, pt)) \
        <= 1e-5
    assert abs(float(ct) - float(cj)) <= 1e-4 * max(1.0, float(cj))
    if drift:
        err0 = np.linalg.norm(poses[-1, :3, 3] - T_true[-1, :3, 3])
        assert np.linalg.norm(pt[-1, :3, 3] - T_true[-1, :3, 3]) < 0.2 * err0


def test_pgo_n_live_equals_full_sweep():
    """Poses past every edge ride along: optimising with n_live = the
    edges' extent equals the full sweep."""
    (poses, ei, ej, z, w), _ = make_loop_problem()
    pad = np.tile(np.eye(4, dtype=np.float32), (10, 1, 1))
    g = tpg.PoseGraph(t(np.concatenate([poses, pad])), t(ei), t(ej), t(z),
                      t(w))
    full, _ = tpg.optimize(g, iters=3, cg_iters=30)
    live, _ = tpg.optimize(g, iters=3, cg_iters=30, n_live=30)
    np.testing.assert_allclose(live.numpy(), full.numpy(), rtol=0,
                               atol=1e-6)


def test_distribute_error_linear_matches_jax():
    poses = np.tile(np.eye(4, dtype=np.float32), (10, 1, 1))
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [1.0, -2.0, 0.5]
    ref = jpg.distribute_error_linear(jnp.asarray(poses), 2, 8,
                                      jnp.asarray(T))
    out = tpg.distribute_error_linear(t(poses), 2, 8, t(T))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
