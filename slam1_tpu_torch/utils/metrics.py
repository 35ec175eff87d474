"""Structured per-frame metrics and the port's tracer (counterpart of
`slam1_tpu/utils/metrics.py`): a JSONL metrics stream, named spans at
the program's layer boundaries, always-on counters, and a
`torch.profiler` capture written as a Chrome trace beside a summary of
the spans.

Spans. `span(name)` is a context manager (`traced(name)` its decorator
form). It records only while a torch profiler records or inside
`recording()`; otherwise it returns a shared no-op object after one flag
check. A recorded span holds its name, its start and end in ns on
`time.time_ns()` (the clock kineto stamps its events with, so spans and
the device trace share one), its parent (the span open on the same
thread when it began), its thread, its frame (the `SlamSystem` frame it
serves, inherited from the parent unless given: the id every span of one
frame shares). While a profiler records, each span is
also a `record_function` range of the same name, so the trace carries
it; the profiler records the ranges of the thread that started it only.
Spans are kept in memory, at most `MAX_SPANS` of them (`dropped` counts
the rest) until `clear()`.

A span opened with `device=True` around a launch on the card also
records a CUDA timing-event pair on the current stream, from a pool of
at most `EVENT_PAIRS`; the pair's elapsed time is resolved when the
spans are read (`recorded()`), or, once the pool is empty, for the
pairs the card has finished (their events queried, never awaited), and
no event is recorded inside a graph capture. A launch that still finds
no pair counts in `events_dropped`.

Names: `replay:<graph>` for a graph replay, `host:<what>` for host work
(`host:wait.<what>` for a blocking read-back, see `wait`). No span name
starts with `graph:`, the benchmark's own range around each replay.

Counters (`count`, `counters()`): integers, always on, one add per
event: `host_syncs`, `graph_captures`, `graph_replays`,
`kernel_builds`, `events_dropped`.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 18
EVENT_PAIRS = 4096
WAIT = "host:wait."


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


# ------------------------------------------------------------- counters
_COUNTS = {"host_syncs": 0, "graph_captures": 0, "graph_replays": 0,
           "kernel_builds": 0, "events_dropped": 0}


def count(name: str, n: int = 1):
    _COUNTS[name] += n


def counters() -> dict:
    """A snapshot of the counters, with the hand-written kernels' launch
    counts (`cuda_kernels.launch_counts()`) and the spans dropped."""
    from slam1_tpu_torch.ops import cuda_kernels
    return {**_COUNTS, "kernel_launches": cuda_kernels.launch_counts(),
            "spans_dropped": _state.dropped}


# ---------------------------------------------------------------- spans
class Span:
    """One recorded span (see the module docstring), its own context
    manager; `end_ns` is None while it is open, `device_ms` the event
    pair's time once resolved."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "thread",
                 "frame", "device_ms", "_device", "_events", "_range")

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __enter__(self):
        stack = _state.local.stack
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.frame is None and parent is not None:
            self.frame = parent.frame
        stack.append(self)
        t0 = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
            # Midway between the reads around the range's start (and
            # end, below): kineto stamps them inside its callbacks.
            self.start_ns = (t0 + time.time_ns()) // 2
        else:
            self.start_ns = t0
        if self._device:
            self._events = _event_pair()
            if self._events is not None:
                self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
            _state.pending.append(self)
        if self._range is not None:
            t0 = time.time_ns()
            self._range.__exit__(*exc)
            self._range = None
            self.end_ns = (t0 + time.time_ns()) // 2
        else:
            self.end_ns = time.time_ns()
        stack = _state.local.stack
        if stack and stack[-1] is self:
            stack.pop()
        return False


class _Local(threading.local):
    def __init__(self):
        self.stack = []              # the thread's open spans


class _State:
    def __init__(self):
        self.depth = 0               # recording() nesting
        self.spans = []
        self.dropped = 0
        self.ids = itertools.count()   # next() is atomic across threads
        self.local = _Local()
        self.free_events = []        # CUDA event pairs ready for reuse
        self.events_made = 0
        self.pending = []            # spans whose pair is unresolved


_state = _State()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _event_pair():
    st = _state
    if not torch.cuda.is_initialized() or \
            torch.cuda.is_current_stream_capturing():
        return None
    if not st.free_events and st.events_made >= EVENT_PAIRS:
        _resolve(done_only=True)
    if st.free_events:
        return st.free_events.pop()
    if st.events_made >= EVENT_PAIRS:
        _COUNTS["events_dropped"] += 1
        return None
    st.events_made += 1
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def span(name: str, frame: Optional[int] = None, device: bool = False):
    """A span named `name` (see the module docstring) around a `with`
    block; `frame` where the caller knows it, `device=True` around a
    launch on the card. A no-op unless a profiler records or
    `recording()` is on."""
    if not (_state.depth or _autograd_profiler._is_profiler_enabled):
        return _NOOP
    st = _state
    s = Span()
    s.id = next(st.ids)
    s.name, s.frame, s._device = name, frame, device
    s.end_ns = s.device_ms = s._events = s._range = None
    s.thread = threading.get_ident()
    if len(st.spans) < MAX_SPANS:
        st.spans.append(s)
    else:
        st.dropped += 1
    return s


def traced(name: str):
    """`span(name)` around every call of the decorated function."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def wait(what: str):
    """A blocking read-back on the host: counts a host sync and opens the
    span `host:wait.<what>` around it."""
    _COUNTS["host_syncs"] += 1
    return span(WAIT + what)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    _state.depth += 1
    try:
        yield
    finally:
        _state.depth -= 1


def clear():
    """Forget the recorded spans (their event pairs go back to the
    pool)."""
    _resolve()
    _state.spans = []
    _state.dropped = 0


def _resolve(done_only: bool = False):
    """Resolve the pending pairs' times and return the pairs to the
    pool: all of them, waiting for the card, or with `done_only` those
    whose end the card has reached."""
    st = _state
    keep = []
    for s in st.pending:
        a, b = s._events
        if done_only and not b.query():
            keep.append(s)
            continue
        b.synchronize()
        s.device_ms = a.elapsed_time(b)
        s._events = None
        st.free_events.append((a, b))
    st.pending = keep


def recorded() -> list:
    """The closed spans recorded since the last `clear()`, oldest first,
    their event pairs resolved."""
    _resolve()
    return [s for s in _state.spans if s.end_ns is not None]


def summary(spans=None) -> dict:
    """name -> {count, total_ms, self_ms} over `spans` (default:
    `recorded()`); a span's self time is its duration less the part of
    it that its children cover."""
    spans = recorded() if spans is None else spans
    children = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0})
        dur = s.end_ns - s.start_ns
        row["count"] += 1
        row["total_ms"] += dur * 1e-6
        row["self_ms"] += (dur - _covered_ns(s, children.get(s.id, ()))) \
            * 1e-6
    return out


def _covered_ns(parent: Span, spans) -> int:
    """ns of `parent`'s interval that the union of `spans` covers."""
    total, end = 0, parent.start_ns
    for s in sorted(spans, key=lambda s: s.start_ns):
        a, b = max(s.start_ns, end), min(s.end_ns, parent.end_ns)
        if b > a:
            total += b - a
            end = b
    return total


def replay_event_ms(spans=None) -> dict:
    """graph base name -> {count, p50_ms, p95_ms} of the event pairs
    around its launches (`host:launch.<base>` spans)."""
    import numpy as np
    spans = recorded() if spans is None else spans
    by = {}
    for s in spans:
        if s.device_ms is not None and s.name.startswith("host:launch."):
            by.setdefault(s.name[len("host:launch."):], []).append(
                s.device_ms)
    return {k: {"count": len(v), "p50_ms": float(np.percentile(v, 50)),
                "p95_ms": float(np.percentile(v, 95))}
            for k, v in by.items()}


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """`torch.profiler` capture (CPU, and CUDA where there is a card)
    when a logdir is given: `trace.json` there (Chrome trace format:
    device operations and the program's spans on one clock) and
    `spans.json` (`summary()`, `counters()` and `replay_event_ms()` of
    the spans recorded meanwhile); a no-op otherwise. Yields the
    profiler or None."""
    if not logdir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    clear()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    spans = recorded()
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"spans": summary(spans), "counters": counters(),
                   "replay_event_ms": replay_event_ms(spans)}, f, indent=1)
