"""Multi-process layer (counterpart of `slam1_tpu/parallel/`): the
(batch, lm) mesh over `torch.distributed` process groups (`mesh`), the
landmark-sharded Schur-complement bundle adjustment (`dist_ba`) and the
keyframe-block sharded pose-graph optimisation (`dist_pgo`).

One process is one device of the mesh: ranks launched by torchrun, by
`torch.multiprocessing`, or a world of one. The reference's shard_map
collectives become all_reduce over the axis's process group and, for
the pose graph's ring halo, point-to-point sends.
"""


def clear_graphs():
    """Drop the distributed solvers' captured graphs (`dist_ba.
    DIST_BA_GRAPHS`, `dist_pgo.DIST_PGO_GRAPHS`) and their memory pools.
    A graph that captured NCCL kernels belongs to its communicator:
    whoever destroys the process group calls this first."""
    from slam1_tpu_torch.parallel import dist_ba, dist_pgo
    dist_ba.DIST_BA_GRAPHS.clear()
    dist_pgo.DIST_PGO_GRAPHS.clear()
