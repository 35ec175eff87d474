"""The plain twins of the two CUDA kernels against the JAX package.

`fast_score` (plain) against JAX `fast.fast_score` and the Pallas
kernel in interpret mode: identical corner masks, scores within 1e-5
(in practice bit-identical: both sum the 16 taps in circle order).
`hamming_top2_plain` against the Pallas `hamming_top2` (interpret mode)
and the dense `hamming.distance_matrix`: all four outputs exactly
equal, including the indices chosen on ties.

The kernels themselves run only on a card: see
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.ops import fast as jfast
from slam1_tpu.ops import hamming as jham
from slam1_tpu.ops.brief import unpack_bits_pm1
from slam1_tpu.ops.pallas_kernels import fast_score as pallas_fast
from slam1_tpu.ops.pallas_kernels import hamming_top2 as pallas_hamming
from slam1_tpu_torch.ops import cuda_kernels, dispatch
from slam1_tpu_torch.ops import fast as tfast
from slam1_tpu_torch.ops import hamming as tham
from torch_threads import one_torch_thread  # noqa: F401

FAST_TOL = 1e-5


@pytest.mark.parametrize("shape,thr", [((96, 128), 0.08), ((70, 128), 0.05)])
def test_fast_score_plain_matches_jax_and_pallas(shape, thr):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    ref = np.asarray(jfast.fast_score(jnp.asarray(img), thr))
    pal = np.asarray(pallas_fast(jnp.asarray(img), thr, strip=32,
                                 interpret=True))
    out = tfast.fast_score(torch.as_tensor(img), thr).numpy()
    for other in (ref, pal):
        np.testing.assert_array_equal(out > 0, other > 0)
        np.testing.assert_allclose(out, other, rtol=0, atol=FAST_TOL)


def test_fast_score_batched_equals_per_image():
    imgs = np.random.default_rng(2).random((2, 40, 64)).astype(np.float32)
    both = tfast.fast_score(torch.as_tensor(imgs), 0.08)
    for i in range(2):
        assert torch.equal(both[i],
                           tfast.fast_score(torch.as_tensor(imgs[i]), 0.08))


def test_nms_matches_jax():
    img = np.random.default_rng(3).random((96, 128)).astype(np.float32)
    score = np.array(jfast.fast_score(jnp.asarray(img), 0.08))
    np.testing.assert_array_equal(
        tfast.nms(torch.as_tensor(score), 2).numpy(),
        np.asarray(jfast.nms(jnp.asarray(score), 2)))


def _hamming_inputs(seed, n=256, m=128, dup=False):
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    db = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    if dup:                      # repeated rows and columns force ties
        da[1::2] = da[0::2]
        db[1::2] = db[0::2]
        db[: m // 2] = da[: m // 2]
    ma = rng.random(n) > 0.2
    mb = rng.random(m) > 0.2
    uva = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    uvb = rng.uniform(0, 100, (m, 2)).astype(np.float32)
    uva[:, 1] = np.round(uva[:, 1])          # exact ties in |dy| too
    uvb[:, 1] = np.round(uvb[:, 1])
    return da, db, ma, mb, uva, uvb


GATES = {
    "ungated": {},
    "epipolar": dict(dy_tol=10.0, dx_lo=0.5, dx_hi=40.0),
    "window": dict(dy_tol=12.0, dx_lo=-12.0, dx_hi=12.0),
}


@pytest.mark.parametrize("dup", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("gate", sorted(GATES))
def test_hamming_top2_plain_matches_pallas(gate, dup):
    da, db, ma, mb, uva, uvb = _hamming_inputs(4, dup=dup)
    kw = GATES[gate]
    jkw = dict(uv_a=jnp.asarray(uva), uv_b=jnp.asarray(uvb), **kw) \
        if kw else {}
    tkw = dict(uv_a=torch.as_tensor(uva), uv_b=torch.as_tensor(uvb),
               **kw) if kw else {}
    ref = pallas_hamming(unpack_bits_pm1(jnp.asarray(da)),
                         unpack_bits_pm1(jnp.asarray(db)), jnp.asarray(ma),
                         jnp.asarray(mb), interpret=True, **jkw)
    out = cuda_kernels.hamming_top2_plain(
        torch.as_tensor(da), torch.as_tensor(db), torch.as_tensor(ma),
        torch.as_tensor(mb), **tkw)
    for name, r, o in zip(("d1", "d2", "idx", "col_best"), ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("dup", [False, True], ids=["random", "ties"])
def test_hamming_top2_plain_matches_dense_topk(dup):
    da, db, ma, mb, _, _ = _hamming_inputs(5, dup=dup)
    d = jham.distance_matrix(jnp.asarray(da), jnp.asarray(db),
                             jnp.asarray(ma), jnp.asarray(mb))
    np.testing.assert_array_equal(
        tham.distance_matrix(torch.as_tensor(da), torch.as_tensor(db),
                             torch.as_tensor(ma),
                             torch.as_tensor(mb)).numpy(), np.asarray(d))
    neg, idx = jax.lax.top_k(-d, 2)
    d1, d2, best, col_best = cuda_kernels.hamming_top2_plain(
        torch.as_tensor(da), torch.as_tensor(db), torch.as_tensor(ma),
        torch.as_tensor(mb))
    np.testing.assert_array_equal(d1.numpy(), -np.asarray(neg[:, 0]))
    np.testing.assert_array_equal(d2.numpy(), -np.asarray(neg[:, 1]))
    np.testing.assert_array_equal(best.numpy(), np.asarray(idx[:, 0]))
    np.testing.assert_array_equal(col_best.numpy(),
                                  np.asarray(jnp.argmin(d, axis=0)))


@pytest.mark.parametrize("kind", ["match", "epipolar", "windowed"])
def test_matchers_match_jax(kind):
    da, db, ma, mb, uva, uvb = _hamming_inputs(6, dup=True)
    j = [jnp.asarray(x) for x in (da, db, ma, mb, uva, uvb)]
    t = [torch.as_tensor(x) for x in (da, db, ma, mb, uva, uvb)]
    if kind == "match":
        rj = jham.match(j[0], j[1], j[2], j[3], max_distance=140)
        rt = tham.match(t[0], t[1], t[2], t[3], max_distance=140)
    elif kind == "epipolar":
        kw = dict(dy_tol=10.0, min_disparity=0.5, max_disparity=40.0,
                  max_distance=140)
        rj = jham.match_epipolar(j[0], j[1], j[4], j[5], j[2], j[3], **kw)
        rt = tham.match_epipolar(t[0], t[1], t[4], t[5], t[2], t[3], **kw)
    else:
        rj = jham.match_windowed(j[0], j[1], j[4], j[5], j[2], j[3],
                                 radius=12.0, max_distance=140)
        rt = tham.match_windowed(t[0], t[1], t[4], t[5], t[2], t[3],
                                 radius=12.0, max_distance=140)
    assert rt.mask.any()
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_gather_matches_matches_jax():
    da, db, ma, mb, _, _ = _hamming_inputs(7, dup=True)
    vals = np.random.default_rng(8).normal(0, 1, (128, 3)).astype(np.float32)
    rj = jham.match(jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma),
                    jnp.asarray(mb), max_distance=140)
    rt = tham.match(torch.as_tensor(da), torch.as_tensor(db),
                    torch.as_tensor(ma), torch.as_tensor(mb),
                    max_distance=140)
    np.testing.assert_array_equal(
        tham.gather_matches(torch.as_tensor(vals), rt, -1.0).numpy(),
        np.asarray(jham.gather_matches(jnp.asarray(vals), rj, -1.0)))


def test_dispatch_takes_plain_path_on_cpu():
    img = torch.rand(1, 32, 48)
    before = cuda_kernels.launch_counts()
    assert torch.equal(dispatch.fast_score(img, 0.08),
                       tfast.fast_score(img, 0.08))
    assert cuda_kernels.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.fast_score_cuda(img, 0.08)
