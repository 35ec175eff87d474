"""Process-level numeric setup for the PyTorch port.

Float32 stays float32: chained SE(3) geometry loses centimetres when a
3x3 product goes through TF32 (about three decimal digits). cuBLAS
matmuls and cuDNN convolutions are both pinned to full precision at
import; cuDNN's TF32 is on by default in PyTorch.
"""

from __future__ import annotations

import torch

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """`device` when one is given, else the card. What `device=None`
    means in every function of the port that makes tensors from nothing
    (cameras, synthetic worlds, empty maps and stores, converted numpy
    states). Raises where there is no card, as `device` does: a run
    meant for the card never carries on silently on the CPU, and a CPU
    caller says so (`device="cpu"`)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('device=None means the card, and CUDA is not '
                           'available: pass device="cpu" for the CPU')
    return torch.device("cuda")


def device(name: str) -> torch.device:
    """The torch device `name`. Raises when CUDA is asked for and is
    missing — a run meant for the card never carries on silently on the
    CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available")
    return dev
