"""Spans and the device trace of a `--trace 1` run.

The benchmark tags the program's layers from its own files: while a
traced run lasts, every CUDA graph replay (`StepGraph.__call__`) runs
inside a `record_function` range named `graph:<graph name>`, and the SLAM
driver's host calls inside `host:<method>` ranges, whose host-clock
seconds are summed as well. `torch.profiler` records the ranges, the
CUDA runtime calls and every kernel, copy and memset on the card (the
nodes of a graph replay included). Each device operation is given the
innermost `graph:` range around the runtime call that launched it
(matched by the profiler's correlation id), so a layer's device time is
the sum over the operations its graphs launched.

`Summary` holds what the per-layer readers (`benchmark/metrics/`) read;
the raw events are dropped once it is built.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

GRAPH = "graph:"
HOST = "host:"
SHORT_NS = 10_000


def _graph_base(name: str) -> str:
    """'place_query[1024]' -> 'place_query'."""
    return name.split("[", 1)[0]


class Spans:
    """Patches the program's classes for the length of a traced run and
    sums host seconds per span name. Untraced runs patch nothing."""

    def __init__(self):
        self.host_s = defaultdict(float)
        self._undo = []

    def wrap(self, cls, method: str, name: str, timed: bool = False):
        orig = getattr(cls, method)
        spans = self

        def wrapped(*args, **kwargs):
            label = name(args[0]) if callable(name) else name
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                try:
                    return orig(*args, **kwargs)
                finally:
                    if timed:
                        spans.host_s[label] += time.perf_counter() - t0
        setattr(cls, method, wrapped)
        self._undo.append((cls, method, orig))

    def graphs(self):
        from slam1_tpu_torch.utils.graphs import StepGraph
        self.wrap(StepGraph, "__call__", lambda g: GRAPH + g.name)

    def close(self):
        for cls, method, orig in reversed(self._undo):
            setattr(cls, method, orig)
        self._undo.clear()


class Window:
    """The traced window: `start()` begins recording, `stop()` ends it
    after a synchronize; `summary()` reduces the events afterwards,
    outside the measured window."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled = enabled
        self.seconds = seconds
        self.prof = None
        self.t0 = self.t1 = None
        self._summary = None

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def due(self) -> bool:
        """Whether a running trace has reached its length."""
        return self.running and time.perf_counter() - self.t0 >= self.seconds

    def stop(self):
        if not self.running:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self):
        if self._summary is None and self.prof is not None:
            self._summary = Summary(self.prof.profiler.kineto_results.events(),
                                    self.t1 - self.t0)
            self.prof = None
        return self._summary


class Summary:
    """Device operations of the traced window reduced to sums.

    - `window_s`: the traced window's length, host clock;
    - `busy_s`: the union of device operations' intervals, seconds;
    - `by_tag[tag]`: device seconds of operations launched in `tag`'s
      ranges (`graph:slam_step`, ...; '' for untagged), by graph base
      name, and `replays[tag]` the ranges of that tag in the window;
    - `by_kernel[name]`, `by_tag_kernel[(tag, name)]`: (seconds, count);
    - `gaps`: idle seconds between device operations summed by the
      innermost host range open when each gap began.
    """

    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType
        self.window_s = window_s
        ann, launch, dev = [], {}, []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    dev.append((e.start_ns(), e.duration_ns(), e.name(),
                                e.correlation_id()))
            elif e.is_user_annotation():
                name = e.name()
                if name.startswith((GRAPH, HOST)):
                    ann.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                name))
            elif e.name().startswith("cu"):
                launch[e.correlation_id()] = e.start_ns()
        ann.sort()
        graphs = [a for a in ann if a[2].startswith(GRAPH)]
        g_start = [a[0] for a in graphs]
        self.replays = defaultdict(int)
        for _s, _e, name in graphs:
            self.replays[GRAPH + _graph_base(name[len(GRAPH):])] += 1
        self.by_tag = defaultdict(float)
        self.by_kernel = defaultdict(lambda: [0.0, 0])
        self.by_tag_kernel = defaultdict(lambda: [0.0, 0])
        spans = []
        for start, dur, name, corr in dev:
            t = launch.get(corr)
            tag = ""
            if t is not None:
                k = bisect.bisect_right(g_start, t) - 1
                if k >= 0 and graphs[k][1] >= t:
                    tag = GRAPH + _graph_base(graphs[k][2][len(GRAPH):])
            s = dur * 1e-9
            self.by_tag[tag] += s
            self.by_kernel[name][0] += s
            self.by_kernel[name][1] += 1
            self.by_tag_kernel[(tag, name)][0] += s
            self.by_tag_kernel[(tag, name)][1] += 1
            spans.append((start, start + dur))
        spans.sort()
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        # Idle gaps, by the innermost host range open as each began; gaps
        # under SHORT_NS (between the nodes of a replay, mostly) summed
        # apart.
        points = [(s, 0, k) for k, (s, _e, _n) in enumerate(ann)]
        points += [(e, 2, k) for k, (_s, e, _n) in enumerate(ann)]
        self.gaps = defaultdict(float)
        for (_s0, e0), (s1, _e1) in zip(merged, merged[1:]):
            if s1 - e0 < SHORT_NS:
                self.gaps["gaps under 10 us"] += (s1 - e0) * 1e-9
            else:
                points.append((e0, 1, s1 - e0))
        points.sort()
        open_ = []
        for _t, kind, v in points:
            if kind == 0:
                open_.append(v)
            elif kind == 2:
                if v in open_:
                    open_.remove(v)
            else:
                label = ann[open_[-1]][2] if open_ else "driver loop"
                self.gaps[label] += v * 1e-9

    def tag_s(self, *tags) -> float:
        return sum(self.by_tag.get(GRAPH + t, 0.0) for t in tags)

    def kernel(self, name_part: str, tag: str | None = None):
        """(seconds, count) of the kernels whose name contains
        `name_part`, launched in graph `tag` (any tag when None)."""
        s, n = 0.0, 0
        for (t, name), (sec, cnt) in self.by_tag_kernel.items():
            if name_part in name and (tag is None or t == GRAPH + tag):
                s += sec
                n += cnt
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, v[0]) for n, v in self.by_kernel.items()),
                     key=lambda x: -x[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}
