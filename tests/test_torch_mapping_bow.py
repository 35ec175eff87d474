"""k-means, BoW and the map of the port against the JAX package.

The same numpy inputs (from a seed) and the same uniform draws (the
reference's own, from `jax.random`) go through both. Integer and
boolean outputs must be identical; float tables hold to 1e-5 (xyz, a
running mean whose merge adds may round in another order) and 1e-6
(histograms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu import config as jcfg
from slam1_tpu.models import bow as jbow
from slam1_tpu.models import mapping as jmap
from slam1_tpu.ops import kmeans as jkm
from slam1_tpu.types import StereoObservations as JObs
from slam1_tpu_torch import config as tcfg
from slam1_tpu_torch.models import bow as tbow
from slam1_tpu_torch.models import mapping as tmap
from slam1_tpu_torch.ops import kmeans as tkm
from slam1_tpu_torch.types import StereoObservations as TObs
from slam1_tpu_torch.utils import interop
from torch_threads import one_torch_thread  # noqa: F401


def draws(key, shape):
    return np.array(jax.random.uniform(key, shape, minval=1e-9, maxval=1.0))


def t(a):
    return torch.as_tensor(np.array(a))


def assert_same_state(js, ts, float_atol):
    for name, a in zip(js._fields, js):
        a, b = np.asarray(a), getattr(ts, name).numpy()
        assert a.shape == b.shape, name
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=0, atol=float_atol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


# --------------------------------------------------------------- k-means

@pytest.mark.parametrize("m,k", [(300, 8), (600, 64)])
def test_kmeans_pm1_matches_jax(m, k):
    rng = np.random.default_rng(m)
    protos = rng.choice([-1.0, 1.0], (k // 2, 256))
    x = protos[rng.integers(0, k // 2, m)]
    x = np.where(rng.random((m, 256)) < 0.1, -x, x).astype(np.float32)
    mask = rng.random(m) > 0.15
    key = jax.random.PRNGKey(m)
    cj, aj = jkm.kmeans_pm1(key, jnp.asarray(x), jnp.asarray(mask), k,
                            iters=6)
    ct, at = tkm.kmeans_pm1(t(x), t(mask), k, iters=6,
                            u=t(draws(key, (m,))))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(
        tkm.assign_words(t(x), ct).numpy(),
        np.asarray(jkm.assign_words(jnp.asarray(x), cj)))


# ------------------------------------------------------------------- BoW

@pytest.fixture(scope="module")
def bow_run():
    """Accumulate 6 frames, add 2 before training, train, add the rest,
    backfill; the states after each stage, both sides."""
    kw = dict(num_words=8, query_exclude=3, train_iters=6,
              backfill_desc_per_frame=48, sample_desc_per_frame=32)
    cj, ct = jcfg.BowConfig(**kw), tcfg.BowConfig(**kw)
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    descs = []
    for i in range(6):
        d = base.copy() if i % 2 else rng.integers(0, 256, (64, 32),
                                                   dtype=np.uint8)
        d[rng.random(64) < 0.2] = rng.integers(0, 256, 32, dtype=np.uint8)
        descs.append(d)
    masks = [rng.random(64) > 0.1 for _ in range(6)]
    js = jbow.init_bow(cj, 16, reservoir=256)
    ts = tbow.init_bow(ct, 16, reservoir=256, device="cpu")
    key = jax.random.PRNGKey(5)
    stages = []
    for i, (d, m) in enumerate(zip(descs, masks)):
        key, ka, kf = jax.random.split(key, 3)
        js = jbow.accumulate(js, ka, jnp.asarray(d), jnp.asarray(m),
                             n_sample=32)
        ts = tbow.accumulate(ts, t(draws(ka, (64,))), t(d), t(m),
                             n_sample=32)
        if i == 2:
            js = jbow.train(js, kf, cj)
            ts = tbow.train(ts, t(draws(kf, (256,))), ct)
        js = jbow.add_frame(js, kf, i, jnp.asarray(d), jnp.asarray(m),
                            is_kf=i != 4)
        ts = tbow.add_frame(ts, t(draws(kf, (64,))), i, t(d), t(m),
                            is_kf=i != 4)
        stages.append((jax.device_get(js), jax.tree.map(torch.clone, ts)))
    js = jbow.backfill_chunk(js, 0, 8)
    ts = tbow.backfill_chunk(ts, 0, 8)
    stages.append((jax.device_get(js), ts))
    return cj, ct, descs, masks, stages


@pytest.mark.parametrize("stage", range(7))
def test_bow_states_match_jax(bow_run, stage):
    js, ts = bow_run[4][stage]
    assert_same_state(js, ts, 1e-6)


def test_bow_backfill_fills_pre_training_rows(bow_run):
    js, ts = bow_run[4][-1]
    assert ts.db_mask.numpy()[:6].tolist() == [True] * 4 + [False, True]
    np.testing.assert_array_equal(ts.db_mask.numpy(), np.asarray(js.db_mask))


@pytest.mark.parametrize("frame", [4, 8, 12])
def test_bow_query_topk_matches_jax(bow_run, frame):
    cj, ct, descs, masks, stages = bow_run
    js, ts = stages[-1]
    jjs = jax.tree.map(jnp.asarray, js)
    for d, m in zip(descs, masks):
        fj, vj = jbow.query_topk(jjs, frame, jnp.asarray(d), jnp.asarray(m),
                                 cj, k=4, min_sep=1)
        ft, vt = tbow.query_topk(ts, frame, t(d), t(m), ct, k=4, min_sep=1)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                                   atol=1e-6)
        bj = jbow.query(jjs, frame, jnp.asarray(d), jnp.asarray(m), cj)
        bt = tbow.query(ts, frame, t(d), t(m), ct)
        assert int(bt[0]) == int(bj[0])


def test_bow_histogram_matches_jax(bow_run):
    cj, ct, descs, masks, stages = bow_run
    js, ts = stages[-1]
    for d, m in zip(descs, masks):
        np.testing.assert_allclose(
            tbow.histogram(t(d), t(m), ts.vocab).numpy(),
            np.asarray(jbow.histogram(jnp.asarray(d), jnp.asarray(m),
                                      jnp.asarray(js.vocab))),
            rtol=0, atol=1e-6)


# ------------------------------------------------------------------- map

MAP_KW = dict(capacity=40, hash_size=64, obs_per_frame=12, max_frames=6,
              probes=2, merge_radius=0.5, voxel_size=0.5)


def _round_inputs(rng, r, prev_xyz, prev_desc, prev_lm, n=24):
    """Half fresh points, half re-observations of the previous round
    (jittered within the merge radius, near-identical descriptors)."""
    xyz = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    known = np.full(n, -1, np.int32)
    if prev_xyz is not None:
        h = n // 2
        xyz[:h] = prev_xyz[:h] + rng.normal(0, 0.08, (h, 3))
        desc[:h] = prev_desc[:h]
        desc[:h, 0] ^= 1
        known[h - 4:h] = prev_lm[h - 4:h]      # track-inherited identity
        known[h - 1] = 10_000                   # out of range: ignored
    mask = rng.random(n) > 0.15
    uv = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    ur = rng.uniform(0, 200, n).astype(np.float32)
    return xyz, desc, mask, uv, ur, known


@pytest.fixture(scope="module")
def map_run():
    """Six insert rounds into a 40-row map with 64 hash buckets (bucket
    collisions, capacity overflow, and more records than the 12 slots
    of a row), then a cull; both sides' states after every round."""
    cj = jcfg.MappingConfig(**MAP_KW)
    ct = tcfg.MappingConfig(**MAP_KW)
    rng = np.random.default_rng(11)
    js, ts = jmap.init_map(cj), tmap.init_map(ct, device="cpu")
    prev = (None, None, None)
    rounds = []
    for r in range(6):
        xyz, desc, mask, uv, ur, known = _round_inputs(rng, r, *prev)
        js, lj = jmap.insert(js, jnp.asarray(xyz), jnp.asarray(desc),
                             jnp.asarray(mask), jnp.asarray(r * 3,
                                                            jnp.int32),
                             jnp.asarray(uv), cj, uv_r_u=jnp.asarray(ur),
                             obs_row=jnp.asarray(r % 3, jnp.int32),
                             known_row=jnp.asarray(known))
        ts, lt = tmap.insert(ts, t(xyz), t(desc), t(mask), r * 3, t(uv), ct,
                             uv_r_u=t(ur), obs_row=r % 3, known_row=t(known))
        rounds.append((jax.device_get(js), jax.tree.map(torch.clone, ts),
                       np.asarray(lj), lt.numpy()))
        prev = (xyz, desc, np.asarray(lj))
    js = jmap.cull(js, 40, 2, 20)
    ts = tmap.cull(ts, 40, 2, 20)
    return rounds, (jax.device_get(js), ts)


@pytest.mark.parametrize("r", range(6))
def test_map_insert_matches_jax(map_run, r):
    js, ts, lj, lt = map_run[0][r]
    np.testing.assert_array_equal(lt, lj)
    assert_same_state(js, ts, 1e-5)


def test_map_insert_exercises_the_hard_cases(map_run):
    """The rounds above really hit bucket collisions (more new points
    than buckets), a full table, merges and obs-slot overflow."""
    rounds, _ = map_run
    first, last = rounds[0][1], rounds[-1][1]
    # a collision loser: a row inserted but reachable by no bucket
    assert int((first.hash_slot >= 0).sum()) < int(first.cursor)
    assert int(last.cursor) == MAP_KW["capacity"]
    assert int(last.count.max()) >= 2
    assert int(last.obs_count.max()) == MAP_KW["obs_per_frame"]
    assert any((r[3] == -1).any() for r in rounds)


def test_map_cull_matches_jax(map_run):
    js, ts = map_run[1]
    assert_same_state(js, ts, 1e-5)
    assert not ts.valid.numpy().all()


def test_map_interop_roundtrip(map_run):
    js, _, _, _ = map_run[0][2]
    ts = interop.map_state(js, device="cpu")
    assert_same_state(js, ts, 0.0)


# --------------------------------------------------------- keyframe store

@pytest.mark.parametrize("n,k", [(40, 16), (12, 16)])
def test_kf_insert_matches_jax(n, k):
    rng = np.random.default_rng(n)
    js, ts = jmap.init_kf_store(5, k), tmap.init_kf_store(5, k, device="cpu")
    for f in range(7):
        o = dict(
            uv_l=rng.uniform(0, 100, (n, 2)).astype(np.float32),
            uv_r=rng.uniform(0, 100, (n, 2)).astype(np.float32),
            xyz=rng.normal(0, 5, (n, 3)).astype(np.float32),
            desc=rng.integers(0, 256, (n, 32), dtype=np.uint8),
            mask=rng.random(n) > 0.3,
            # rounded scores tie
            score=np.round(rng.uniform(0, 2, n), 1).astype(np.float32))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = f
        is_kf = f % 3 != 1
        js = jmap.kf_insert(js, JObs(**{a: jnp.asarray(v)
                                        for a, v in o.items()}),
                            jnp.asarray(pose), k, frame=f, is_kf=is_kf)
        ts = tmap.kf_insert(ts, TObs(**{a: t(v) for a, v in o.items()}),
                            t(pose), k, frame=f, is_kf=is_kf)
        assert_same_state(jax.device_get(js), ts, 0.0)
