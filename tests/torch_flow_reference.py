"""The flow VO of both packages on the CPU, at the default config, on the
24-frame arc clip that `chip_smoke.py` renders (the port's renderer,
seed 0, 6000 points, speed 1.0): per package the pnp_ok share, the ATE
(no alignment) and the per-frame counts. What `chip_smoke.py`'s `flow`
phase holds the port to on the card comes from here.

    JAX_PLATFORMS=cpu python tests/torch_flow_reference.py [--frames N]

Slow: the reference compiles and runs its dense SGM at 376x1280 on the
CPU (minutes). Not collected by pytest.
"""

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from slam1_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from slam1_tpu.models import vo_flow as jvf  # noqa: E402
from slam1_tpu.ops.camera import StereoCamera as JCamera  # noqa: E402
from slam1_tpu_torch.config import SlamConfig  # noqa: E402
from slam1_tpu_torch.models import vo_flow as tvf  # noqa: E402
from slam1_tpu_torch.utils import synthetic  # noqa: E402
from slam1_tpu_torch.utils.evalmetrics import ate_rmse  # noqa: E402


def summary(poses, metrics, gt, secs):
    return {"pnp_ok_share": float(np.mean([bool(m.pnp_ok) for m in metrics])),
            "ate_m": ate_rmse(poses, gt, align=False),
            "num_tracked": [int(m.num_tracked) for m in metrics],
            "num_stereo": [int(m.num_stereo) for m in metrics],
            "num_inliers": [int(m.num_inliers) for m in metrics],
            "seconds": secs}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()
    cfg = SlamConfig()
    world = synthetic.make_world(0, n_frames=args.frames, n_points=6000,
                                 trajectory="arc", speed=1.0, device="cpu")
    lefts, rights = synthetic.render_sequence(world, cfg.image.height,
                                              cfg.image.width)
    gt = world.poses.numpy()
    out = {}
    t0 = time.perf_counter()
    cam = JCamera(*[jax.numpy.asarray(v.numpy()) for v in world.cam])
    pj, mj = jvf.run_sequence(jax.numpy.asarray(lefts.numpy()),
                              jax.numpy.asarray(rights.numpy()), cam,
                              JSlamConfig())
    out["jax"] = summary(pj, mj, gt, time.perf_counter() - t0)
    t0 = time.perf_counter()
    pt, mt = tvf.run_sequence(lefts, rights, world.cam, cfg, seed=0)
    out["torch"] = summary(pt, mt, gt, time.perf_counter() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
