"""Multi-process layer (counterpart of `slam1_tpu/parallel/`): the
(batch, lm) mesh over `torch.distributed` process groups (`mesh`), the
landmark-sharded Schur-complement bundle adjustment (`dist_ba`) and the
keyframe-block sharded pose-graph optimisation (`dist_pgo`).

One process is one device of the mesh: ranks launched by torchrun, by
`torch.multiprocessing`, or a world of one. The reference's shard_map
collectives become all_reduce over the axis's process group and, for
the pose graph's ring halo, point-to-point sends.
"""
