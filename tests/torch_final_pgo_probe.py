"""The final pose-graph relaxation of chip_smoke.py's BA-off SLAM pass,
run by both packages on the same pose graph (not collected by pytest).

    python3 tests/torch_final_pgo_probe.py dump OUT.npz     # on the card
    python3 tests/torch_final_pgo_probe.py compare OUT.npz  # on the CPU

`dump` imports torch and the port only. It runs the 600-frame loop2
clip at the default config with local BA off and `poll_lag_s=0` (the
`slam` phase of chip_smoke.py), takes `finalize`'s poll and
verifications, and saves the inputs of finalize's relaxation
(`_pgo_step` at 25 Gauss-Newton iterations: the trajectory, odometry
twists and their mask, the loop edges, the frame), the ground truth,
and the trajectory that the card's `finalize` then gives.

`compare` runs both packages' `_pgo_step` on those inputs on the CPU
(the JAX package's as its tests run it) and prints one JSON line: the
ATE of odometry alone, before the relaxation, after each package's and
after the card's, and the largest position difference between them.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def ate(poses, gt):
    d = np.asarray(poses)[:, :3, 3] - np.asarray(gt)[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def dump(path):
    import torch

    import chip_smoke as cs
    from slam1_tpu_torch import runtime
    from slam1_tpu_torch.models import pipeline

    dev = runtime.device("cuda")
    cfg = cs.slam_config(ba_on=False)
    world, lefts, rights = cs.render_loop2(dev)
    sys_ = pipeline.SlamSystem(world.cam, cfg, seed=cs.SEED,
                               bow_train_frame=30)
    sys_.process(lefts[0], rights[0])
    cs.run_blocks(sys_, lefts, rights, 1)
    pre_poll = sys_.poses()
    # finalize's own poll and verifications, so that what is saved is
    # what its relaxation starts from
    sys_._poll(force=True)
    sys_._consume_verifications(force=True)
    st = sys_.state
    edges = sys_.loop_edges
    saved = dict(
        traj=st.traj.cpu().numpy(), rel=st.rel.cpu().numpy(),
        rel_mask=st.rel_mask.cpu().numpy(), frame=int(st.frame),
        frame_count=sys_.frame_count,
        le_i=np.array([i for i, _, _, _ in edges], np.int64),
        le_j=np.array([j for _, j, _, _ in edges], np.int64),
        le_z=np.array([z for _, _, z, _ in edges], np.float32),
        le_w=np.array([w for _, _, _, w in edges], np.float32),
        odometry=cs.odometry_poses(sys_), pre_poll=pre_poll,
        gt=world.poses.cpu().numpy(), pg_iters=cfg.ba.pg_iters,
        cg_iters=cfg.ba.cg_iters)
    saved["card_post"] = sys_.finalize()
    torch.cuda.synchronize()
    np.savez(path, **saved)
    f = sys_.frame_count + 1
    print(json.dumps({"frames": f, "loop_edges": len(edges),
                      "card": torch.cuda.get_device_name(0),
                      "ate_odometry_m": ate(saved["odometry"],
                                            saved["gt"][:f]),
                      "ate_before_m": ate(saved["traj"][:f],
                                          saved["gt"][:f]),
                      "ate_after_card_m": ate(saved["card_post"],
                                              saved["gt"][:f])}))


def _pgo_inputs(d):
    """_run_pgo's arrays: the loop edges padded to MAX_LOOP_EDGES, the
    bucket and the live rows."""
    from slam1_tpu_torch.models import pipeline
    cap = pipeline.MAX_LOOP_EDGES
    k = d["le_i"].shape[0]
    le_i = np.zeros(cap, np.int64)
    le_j = np.zeros(cap, np.int64)
    le_z = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    le_w = np.zeros(cap, np.float32)
    le_i[:k], le_j[:k], le_z[:k], le_w[:k] = (d["le_i"], d["le_j"],
                                              d["le_z"], d["le_w"])
    n = int(d["frame_count"]) + 1
    f_cap = d["traj"].shape[0]
    bucket = next((b for b in pipeline.PGO_BUCKETS if n <= b <= f_cap),
                  f_cap)
    return le_i, le_j, le_z, le_w, bucket, min(n, bucket)


def compare(path):
    import jax
    import jax.numpy as jnp
    import torch

    from slam1_tpu.models import pipeline as jpipe
    from slam1_tpu_torch.models import pipeline as tpipe

    jax.config.update("jax_platforms", "cpu")
    d = dict(np.load(path))
    le_i, le_j, le_z, le_w, bucket, n_live = _pgo_inputs(d)
    iters, cg = int(d["pg_iters"]), int(d["cg_iters"])
    f = int(d["frame_count"]) + 1
    one = np.zeros(1, np.int32)
    map_args = (np.zeros((1, 3), np.float32), one, np.zeros(1, bool))
    j_traj = jpipe._pgo_step(
        jnp.asarray(d["traj"]), jnp.asarray(d["rel"]),
        jnp.asarray(d["rel_mask"]), jnp.asarray(one), jnp.asarray(one > 0),
        jnp.asarray(le_i, jnp.int32), jnp.asarray(le_j, jnp.int32),
        jnp.asarray(le_z), jnp.asarray(le_w), jnp.asarray(d["frame"]),
        *map(jnp.asarray, map_args), bucket=bucket, iters=iters,
        cg_iters=cg)[0]
    t_traj = tpipe._pgo_step(
        torch.as_tensor(d["traj"]), torch.as_tensor(d["rel"]),
        torch.as_tensor(d["rel_mask"]), torch.as_tensor(one),
        *map(torch.as_tensor, (le_i, le_j, le_z, le_w)),
        int(d["frame"]), *map(torch.as_tensor, map_args), bucket=bucket,
        iters=iters, cg_iters=cg, n_live=n_live)[0]
    j_post = np.asarray(j_traj)[:f]
    t_post = t_traj.numpy()[:f]
    card = d["card_post"]
    gt = d["gt"][:f]

    def gap(a, b):
        return float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())
    print(json.dumps({
        "frames": f, "bucket": bucket, "n_live": n_live,
        "loop_edges": [[int(i), int(j)] for i, j in zip(d["le_i"],
                                                        d["le_j"])],
        "gn_iters": iters, "cg_iters": cg,
        "ate_odometry_m": ate(d["odometry"], gt),
        "ate_before_m": ate(d["traj"][:f], gt),
        "ate_after_jax_cpu_m": ate(j_post, gt),
        "ate_after_port_cpu_m": ate(t_post, gt),
        "ate_after_port_card_m": ate(card, gt),
        "max_position_gap_jax_port_cpu_m": gap(j_post, t_post),
        "max_position_gap_port_cpu_card_m": gap(t_post, card),
        "max_position_gap_jax_cpu_card_m": gap(j_post, card)}))


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("dump", "compare"):
        raise SystemExit(__doc__)
    {"dump": dump, "compare": compare}[sys.argv[1]](sys.argv[2])
