"""Share of its roofline of one LM iteration of BA: the least time of
its work counted from the problem's sizes and the CG iterations
(`yardstick/bounds.ba_lm_iteration_work`), over `ba_lm_ms`."""

from benchmark.harness import readers
from benchmark.yardstick import bounds


def read(run):
    ms = readers.per_replay_ms(run, "ba_lm")
    if not ms:
        return None
    sz = run.info["sizes"]
    need = bounds.bound_ba_lm_iteration(sz["obs"], sz["cams"], sz["points"],
                                        0, sz["cg_iters"])[0]
    return 100.0 * need / ms
