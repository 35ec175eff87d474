"""Timing on the card with CUDA events.

`event_ms` times eager calls: what a caller pays when nothing else is
queued, the Python wrapper included. `graph_ms` captures the calls in a
CUDA graph and replays it, so the host is out of the way and the time is
what the card needs. Both warm up first and synchronise around the
measurement. `device_busy_ms` sums the device-side durations that
`torch.profiler` records, for code a CUDA graph cannot capture.
`call_ms` is `event_ms` on a card and the host clock on the CPU, for
tools that also run on the CPU.
"""

from __future__ import annotations

import time

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


def call_ms(fn, device, reps: int = 20, warm: int = 3) -> float:
    """Mean time of fn() in ms over `reps` calls on `device`: CUDA
    events on a card (`event_ms`), the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        return event_ms(fn, reps, warm)
    for _ in range(warm):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


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


def device_busy_ms(fn, reps: int = 3) -> float:
    """The time the card is busy for one fn() in ms: the sum of the
    device-side durations (kernels, copies) `torch.profiler` records
    over `reps` warm calls. `event_ms` minus this is what the card
    spends waiting for the host between launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        total_us += getattr(e, "self_cuda_time_total", 0.0) if t is None else t
    return total_us / 1e3 / reps


def device_launches(fn) -> dict:
    """What one warm fn() puts on the card, as `torch.profiler` records
    it: `device_events` the kernels, copies and memsets that ran there,
    `launch_calls` the host's launch calls of the CUDA runtime and
    driver."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return {"device_events": sum(e.device_type == DeviceType.CUDA
                                 for e in events),
            "launch_calls": sum(e.name in ("cudaLaunchKernel",
                                           "cudaLaunchKernelExC",
                                           "cuLaunchKernel",
                                           "cuLaunchKernelEx")
                                for e in events)}
