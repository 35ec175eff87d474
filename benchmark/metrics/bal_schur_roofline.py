"""Share of its roofline of the reduced system's product at D = 9
(`csrc/ba_schur.cu`'s landmark and camera halves, by kernel name, inside
`bal_lm`): the least time of the launches' work
(`yardstick/bal_bounds.schur_work`) over their device time. Of a
replay's landmark-half launches one reads a alone (the right side) and
the others W; every camera-half launch reads W."""

from benchmark.harness import readers
from benchmark.yardstick import bal_bounds


def read(run):
    sz = run.info.get("sizes")
    if not sz:
        return None
    o, c, l, it = sz["obs"], sz["cams"], sz["points"], sz["cg_iters"]
    lm_w = bal_bounds.bound_schur(o, c, l, "landmarks")[0]
    lm_a = bal_bounds.bound_schur(o, c, l, "landmarks", x=False, a=True)[0]
    # A replay: the right side's a-only launch, then it + 2 launches on W.
    lm_mean = (lm_a + (it + 2) * lm_w) / (it + 3)
    return readers.roofline(run, [
        ("schur_landmarks_kernel", "bal_lm", lm_mean),
        ("schur_cameras_kernel", "bal_lm",
         bal_bounds.bound_schur(o, c, l, "cameras")[0])])
