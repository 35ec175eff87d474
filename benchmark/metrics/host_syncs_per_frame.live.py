"""Blocking read-backs a frame on the SLAM driver's thread: the
program's `host:wait.*` spans (one a read-back) over the traced window's
frames (its `host:slam.process` spans). None where the program records
no spans (`slam1_tpu_torch.utils.metrics.recorded`)."""

from slam1_tpu_torch.utils import metrics


def read(run):
    spans = getattr(metrics, "recorded", list)()
    frames = sum(s.name == "host:slam.process" for s in spans)
    if not frames:
        return None
    return sum(s.name.startswith("host:wait.") for s in spans) / frames
