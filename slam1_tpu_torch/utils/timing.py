"""Timing on the card with CUDA events.

`event_ms` times eager calls: what a caller pays when nothing else is
queued, the Python wrapper included. `graph_ms` captures the calls in a
CUDA graph and replays it, so the host is out of the way and the time is
what the card needs. Both warm up first and synchronise around the
measurement.
"""

from __future__ import annotations

import torch


def _between_events(fn, times: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(times):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def event_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean time of fn() in ms over `reps` eager calls."""
    for _ in range(warm):
        fn()
    return _between_events(fn, reps) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device time of fn() in ms: `reps` calls captured in one CUDA
    graph, the graph replayed `replays` times. fn() must launch on the
    current stream and read nothing back to the host."""
    fn()                                   # builds what is built lazily
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    return _between_events(graph.replay, replays) / (reps * replays)
