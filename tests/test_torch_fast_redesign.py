"""What the one-launch FAST kernel rests on, held on the CPU.

The kernel (`slam1_tpu_torch/csrc/fast_score.cu`) runs only on the card.
Its arc test on bit masks is stated once more in plain PyTorch
(`fast.arc_mask`) and held here against the run-length count of the
plain twin for every one of the 2^16 tap masks; the levels entry of the
dispatch and the restructured `detect_pyramid` are held against the
per-level calls and against the JAX package, exactly (tolerance 0: the
scores feed an exact `>=` in NMS).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.ops import fast as jfast
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.ops import cuda_kernels, detector, dispatch
from slam1_tpu_torch.ops import fast as tfast
from torch_threads import one_torch_thread  # noqa: F401

THRESHOLD = 0.08


def _mask_images(sign):
    """(65536, 7, 7): image m has centre 0.5 and tap k at 0.5 + sign *
    0.25 where bit k of m is set, 0.5 elsewhere."""
    m = torch.arange(1 << 16)
    img = torch.full((1 << 16, 7, 7), 0.5)
    for k, (dy, dx) in enumerate(tfast.CIRCLE):
        img[:, 3 + dy, 3 + dx] += sign * 0.25 * ((m >> k) & 1)
    return m, img


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["brighter", "darker"])
@pytest.mark.parametrize("arc", [1, 9, 12, 16])
def test_arc_mask_equals_run_length_count_on_all_masks(arc, sign):
    m, img = _mask_images(sign)
    corner = tfast.fast_score(img, THRESHOLD, arc)[:, 3, 3] > 0
    got = tfast.arc_mask(m, arc)
    assert torch.equal(got, corner)
    # The count is not vacuous: some masks pass and, above arc 1, most of
    # those with at least one tap do not.
    assert got.any() and (arc == 1 or (~got[1:]).sum() > got.sum())
    assert bool(got[0]) is False and bool(got[-1]) is True


def test_arc_mask_counts_runs_across_the_seam():
    # Taps 12..15 and 0..4: nine in a row only around the circle's seam.
    seam = torch.tensor([0b1111_0000_0001_1111, 0b1111_0000_0000_1111])
    assert tfast.arc_mask(seam, 9).tolist() == [True, False]


def _pyramid(canvas, levels=3):
    out = [torch.as_tensor(canvas)]
    for _ in range(levels - 1):
        out.append(detector._downsample2(out[-1]))
    return out


@pytest.mark.parametrize("shape", [(128, 256), (61, 83)])
def test_fast_score_levels_on_cpu_equals_per_level_and_jax(shape):
    rng = np.random.default_rng(shape[0])
    imgs = _pyramid(rng.random((2,) + shape).astype(np.float32))
    outs = dispatch.fast_score_levels(imgs, THRESHOLD, 9)
    assert len(outs) == len(imgs) == 3
    for im, out in zip(imgs, outs):
        assert torch.equal(out, tfast.fast_score(im, THRESHOLD, 9))
        for b in range(2):
            ref = np.asarray(jfast.fast_score(jnp.asarray(im[b].numpy()),
                                              THRESHOLD, 9))
            assert (ref > 0).sum() > 0
            np.testing.assert_array_equal(out[b].numpy(), ref)


def test_detect_pyramid_scored_in_one_call_equals_detect_per_level(
        monkeypatch):
    """`detect_pyramid` scores every level through one call of
    `dispatch.fast_score_levels`; level by level, `detect` with its own
    score map returns the same Features on every field."""
    h, w = 128, 256
    cfg = dataclasses.replace(tiny_config().detector, num_levels=3)
    img = torch.as_tensor(
        np.random.default_rng(5).random((2, h, w)).astype(np.float32))
    calls = []
    real = dispatch.fast_score_levels

    def counted(imgs, threshold, arc=9):
        calls.append(len(imgs))
        return real(imgs, threshold, arc)

    monkeypatch.setattr(dispatch, "fast_score_levels", counted)
    got = detector.detect_pyramid(img, cfg, h, w)
    monkeypatch.undo()
    assert calls == [3]

    parts = []
    for lvl, cur in enumerate(_pyramid(img)):
        s = cfg.scale_factor ** lvl
        gr, gc = cfg.level_grid(lvl)
        lcfg = dataclasses.replace(cfg, grid_rows=gr, grid_cols=gc,
                                   num_levels=1)
        f = detector.detect(cur, lcfg, valid_h=int(h / s), valid_w=int(w / s))
        parts.append(f._replace(xy=f.xy * s + (s - 1.0) / 2.0))
    n = sum(f.mask.shape[1] for f in parts)
    assert got.mask.shape[1] == n + (-n) % 128 and got.mask.sum() > 100
    for name in got._fields:
        want = torch.cat([getattr(f, name) for f in parts], dim=1)
        assert torch.equal(getattr(got, name)[:, :n], want), name
        assert not getattr(got, name)[:, n:].any(), name


def test_detect_takes_a_score_map():
    cfg = tiny_config().detector
    img = torch.as_tensor(
        np.random.default_rng(6).random((1, 64, 128)).astype(np.float32))
    raw = tfast.fast_score(img, cfg.fast_threshold, cfg.fast_arc)
    a = detector.detect(img, dataclasses.replace(cfg, num_levels=1))
    b = detector.detect(img, dataclasses.replace(cfg, num_levels=1), raw=raw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_levels_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never takes the plain path: only the
    dispatch does, and only for CPU tensors."""
    img = torch.zeros(1, 16, 16)
    with pytest.raises(ValueError, match=r"imgs\[0\].*CUDA"):
        cuda_kernels.fast_score_levels_cuda([img], THRESHOLD)
    with pytest.raises(ValueError, match="img.*CUDA"):
        cuda_kernels.fast_score_cuda(img, THRESHOLD)
    with pytest.raises(ValueError, match="levels"):
        cuda_kernels.fast_score_levels_cuda([], THRESHOLD)
    with pytest.raises(ValueError, match="arc"):
        cuda_kernels.fast_score_levels_cuda([img], THRESHOLD, arc=17)
