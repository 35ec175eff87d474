"""Share of its roofline of one LM iteration of BAL's bundle adjustment:
the least time of its launches' work counted from the problem's sizes
and the CG iterations (`yardstick/bal_bounds.lm_iteration_work`), over
`bal_lm_ms`."""

from benchmark.harness import readers
from benchmark.yardstick import bal_bounds


def read(run):
    ms = readers.per_replay_ms(run, "bal_lm")
    if not ms:
        return None
    sz = run.info["sizes"]
    need = bal_bounds.bound_lm_iteration(sz["obs"], sz["cams"],
                                         sz["points"], sz["cg_iters"])[0]
    return 100.0 * need / ms
