"""Host ms a frame that the SLAM driver's thread waits on blocking
read-backs: the summed durations of the program's `host:wait.*` spans
over the traced window's frames (its `host:slam.process` spans). None
where the program records no spans
(`slam1_tpu_torch.utils.metrics.recorded`)."""

from slam1_tpu_torch.utils import metrics


def read(run):
    spans = getattr(metrics, "recorded", list)()
    frames = sum(s.name == "host:slam.process" for s in spans)
    if not frames:
        return None
    waited = sum(s.end_ns - s.start_ns for s in spans
                 if s.name.startswith("host:wait."))
    return 1e-6 * waited / frames
