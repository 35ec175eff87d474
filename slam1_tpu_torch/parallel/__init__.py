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
    """Drop the distributed solvers' captured graphs (the kinds "dist_ba"
    and "dist_pgo" of the registry in `utils/graphs.py`) and their
    memory pools. A graph that captured NCCL kernels belongs to its
    communicator: whoever destroys the process group calls this first."""
    from slam1_tpu_torch.utils.graphs import GRAPHS
    GRAPHS.clear("dist_ba")
    GRAPHS.clear("dist_pgo")
