"""Structured per-frame metrics + stage timing (counterpart of
`slam1_tpu/utils/metrics.py`): a JSONL metrics stream, wall-clock stage
timers, and an optional `torch.profiler` capture written as a Chrome
trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, every: int = 1,
                 stream=None):
        self.path = path
        self.every = max(every, 1)
        self._fh = open(path, "a") if path else None
        self.stream = stream
        self._n = 0

    def log(self, **fields):
        self._n += 1
        if self._n % self.every:
            return
        rec = {"t": time.time(), **fields}
        line = json.dumps(rec, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.stream:
            print(line, file=self.stream)

    def close(self):
        if self._fh:
            self._fh.close()


class StageTimers:
    """Accumulating wall-clock timers, context-manager API:

        with timers.stage("frontend"): ...
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """`torch.profiler` capture (CPU, and CUDA where there is a card)
    when a logdir is given, written there as `trace.json` (Chrome trace
    format); a no-op otherwise. Yields the profiler or None."""
    if not logdir:
        yield None
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
