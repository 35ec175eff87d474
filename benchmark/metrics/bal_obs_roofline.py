"""Share of its roofline of BAL's observation pass (`csrc/bal_obs.cu`'s
cameras, landmarks and cost launches, by kernel name, inside `bal_lm`):
the least time of the launches' work (`yardstick/bal_bounds.obs_work`)
over their device time, the one-block sums of the costs with them."""

from benchmark.harness import readers
from benchmark.yardstick import bal_bounds


def read(run):
    sz = run.info.get("sizes")
    if not sz:
        return None
    o, c, l = sz["obs"], sz["cams"], sz["points"]
    return readers.roofline(run, [
        ("bal_cameras_kernel<true", "bal_lm",
         bal_bounds.bound_obs(o, c, l, "cameras")[0]),
        ("bal_landmarks_kernel", "bal_lm",
         bal_bounds.bound_obs(o, c, l, "landmarks")[0]),
        ("bal_cameras_kernel<false", "bal_lm",
         bal_bounds.bound_obs(o, c, l, "cost")[0]),
        ("bal_total_kernel", "bal_lm", 0.0)])
