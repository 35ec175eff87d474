"""Share of its roofline of `csrc/hamming_top2.cu`: the least time of
the launches' work (one gated kp x kp problem a launch in the step, 8
ungated kf x kf problems a launch in a slate; `yardstick/bounds.py`)
over their device time."""

from benchmark.harness import readers
from benchmark.yardstick import bounds


def read(run):
    sz = run.info["sizes"]
    kp, kf = sz["kp"], sz["kf_features"]
    return readers.roofline(run, [
        ("hamming", "slam_step", bounds.bound_hamming(1, kp, kp, True)[0]),
        ("hamming", "slate", bounds.bound_hamming(8, kf, kf, False)[0])])
