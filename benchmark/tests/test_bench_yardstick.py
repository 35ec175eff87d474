"""The frozen yardstick pinned to golden values at tiny sizes: the
generator (`yardstick/synth.py`) and the work formulas
(`yardstick/bounds.py`). A change to either changes what every cell
measures, so it fails here first."""

import math

import pytest
import torch

from benchmark.yardstick import bounds, se3, synth

torch.set_num_threads(1)
CAM = synth.Camera(718.856 * 256 / 1226, 718.856 * 256 / 1226, 128.0, 64.0,
                   0.5371657)


def close(a, b, rel=1e-5):
    return a == pytest.approx(b, rel=rel)


def test_drive_is_the_closed_form_arc():
    T = synth.drive("arc", 7, 1.0)
    assert T.dtype == torch.float64
    assert close(float(T[6, 0, 0]), math.cos(6 * 0.002), 1e-12)
    # A constant step: T_k = T_1 ** k.
    step = T[1]
    assert torch.allclose(T[3], step @ step @ step, atol=1e-12)
    assert close(float(T[6, 0, 3]), 0.03599956800209858, 1e-12)
    assert close(float(T[6, 2, 3]), 5.999856001036797, 1e-12)


def test_world_and_render_golden():
    w = synth.make_world(3, synth.drive("loop2", 40), 300, CAM,
                         z_range=(9.0, 34.0))
    assert close(float(w.points.double().sum()), 955.9230507872999)
    assert close(float(w.patches.double().sum()), 41477.39802058786)
    lefts, rights = synth.render(w, 5, 128, 256, batch=2)
    assert close(float(lefts.double().sum()), 8152.920125991106)
    assert close(float(rights.double().sum()), 8010.533204346895)
    assert close(float(lefts[3].double().sum()), 1653.5887245684862)


def test_render_as_8_bit_levels():
    w = synth.make_world(3, synth.drive("loop2", 40), 300, CAM,
                         z_range=(9.0, 34.0))
    l8, r8 = synth.render(w, 5, 128, 256, batch=2, dtype=torch.uint8)
    lf, _ = synth.render(w, 5, 128, 256, batch=2)
    assert (int(l8.long().sum()), int(r8.long().sum())) == (2079050, 2042710)
    assert float((synth.to_levels(l8) - lf).abs().max()) <= 0.5 / 255 + 1e-6


def test_render_batches_agree():
    w = synth.make_world(3, synth.drive("loop2", 40), 300, CAM,
                         z_range=(9.0, 34.0))
    one = synth.render(w, 4, 128, 256, batch=1)
    four = synth.render(w, 4, 128, 256, batch=4)
    for a, b in zip(one, four):
        assert torch.allclose(a, b, atol=1e-5)


def test_ba_problem_golden():
    truth = synth.drive("arc", 40, 1.0)
    wb = synth.make_world(5, truth, 2000, CAM)
    b = synth.ba_problem(5, wb, truth, 2, 24, 64, 0.5, 0.02,
                         [0.02] * 3 + [0.002] * 3, 0.05, (128, 256))
    assert (b.uv.shape[0], b.points.shape[0], b.n_kf) == (686, 296, 20)
    assert close(float(b.uv.double().sum()), 129229.4177904129)
    assert close(float(b.poses.double().sum()), 485.831584090105)
    assert close(float(b.points.double().sum()), 17270.370969770942)
    assert torch.equal(b.poses[20:], torch.eye(4).repeat(4, 1, 1))


def test_bounds_golden():
    assert bounds.PEAK_BYTES_S == 3.35e12
    assert bounds.PEAK_INT8_OPS == 1979e12
    assert bounds.PEAK_F32_FLOPS == 67e12
    ms, by = bounds.bound_hamming(1, 2688, 2688, True)
    assert (close(ms, 0.0018693158807478523), by) == (True, "operations")
    ms, by = bounds.bound_fast_score([(2, 376, 1280), (2, 188, 640),
                                      (2, 94, 320)])
    assert (close(ms, 0.003016979104477612), by) == (True, "bytes")
    assert close(bounds.bound_chain_sweep(4661, 4661)[0],
                 0.0004730567164179105)
    assert close(bounds.bound_ba_lm_iteration(500000, 2048, 12000, 0, 64)[0],
                 0.9042361695522387)
