"""Share of its roofline of `csrc/fast_score.cu`: the least time of one
launch's work (both images at every pyramid level;
`yardstick/bounds.py`) over its device time."""

from benchmark.harness import readers
from benchmark.yardstick import bounds


def read(run):
    one = bounds.bound_fast_score(readers.fast_score_shapes(run))[0]
    return readers.roofline(run, [("fast_score", "slam_step", one)])
