"""What the drivers share: seeds, the configuration's camera and
settings in the program's types, and the memory reading."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> list:
    """n independent seeds below 2**31 from the run's seed (any size)."""
    return [int(x) for x in np.random.SeedSequence(seed).generate_state(
        n, dtype=np.uint32) % (2 ** 31)]


def program_camera(cam, device):
    from slam1_tpu_torch.ops.camera import StereoCamera
    return StereoCamera.create(cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline,
                               device=device)


def slam_config(config: dict):
    """The program's SlamConfig(): its defaults, with the configuration
    file's `slam_config` groups of fields replaced (none for a file that
    states the defaults)."""
    from slam1_tpu_torch.config import SlamConfig
    cfg = SlamConfig()
    for group, fields in config.get("slam_config", {}).items():
        cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group),
                                                        **fields)})
    return cfg


def sync(device):
    """Wait for the card (nothing to wait for on the CPU, where the
    tests drive a run at a tiny size)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def free_device(device):
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
