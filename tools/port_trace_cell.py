"""One untraced run of a benchmark cell (`BENCHMARK.json`) with the
program's spans recorded inside its window and no profiler running:
the benchmark's own `benchmark/run.py --trace 0` (`harness/cli.main`),
with `slam1_tpu_torch.utils.metrics.recording()` on from the window's
start to its end (with `--from-start`, from the process's start:
set-up's captures and BoW training too). Prints the harness's result
line, then one JSON line of what the spans recorded: each graph's
replay ms on the card (CUDA event pairs) at p50 and p95, the host ms of
`host:slam.process` at p50 and p95, the `host:wait.*` read-backs a frame
and their ms a frame, the driver's own latencies (`info`), the spans'
summary and the counters. Needs a CUDA card:

    python tools/port_trace_cell.py --workload slam-live-10hz \\
        --seed 2147800201 --seconds 20

`--span-cost N` instead times N spans with recording off and on (ns a
span) and exits.
"""

import argparse
import contextlib
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache",
                                              "triton")


def _span_cost(n: int) -> dict:
    from slam1_tpu_torch.utils import metrics
    out = {}
    for label, rec in (("off", contextlib.nullcontext()),
                       ("recording", metrics.recording())):
        with rec:
            t = time.perf_counter_ns()
            for _ in range(n):
                pass
            empty = time.perf_counter_ns() - t
            t = time.perf_counter_ns()
            for _ in range(n):
                with metrics.span("host:cost"):
                    pass
            out[f"ns_per_span_{label}"] = (time.perf_counter_ns() - t
                                           - empty) / n
        metrics.clear()
    return out


def _quantiles(v):
    import numpy as np
    return ({"p50": float(np.percentile(v, 50)),
             "p95": float(np.percentile(v, 95)), "n": len(v)}
            if v else None)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--from-start", action="store_true")
    ap.add_argument("--span-cost", type=int, default=0)
    args = ap.parse_args(argv)
    if args.span_cost:
        print(json.dumps(_span_cost(args.span_cost)))
        return 0

    from benchmark.harness import cli as bcli
    from benchmark.harness import trace
    from slam1_tpu_torch.utils import metrics

    window = contextlib.ExitStack()
    if args.from_start:
        window.enter_context(metrics.recording())
    runs = []

    class Run(bcli.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

        def window_opens(self):
            super().window_opens()
            if not args.from_start:
                metrics.clear()
                window.enter_context(metrics.recording())

    class Window(trace.Window):
        def stop(self):
            window.close()
            super().stop()

    bcli.Run, trace.Window = Run, Window
    rc = bcli.main(["--workload", args.workload, "--seed", str(args.seed),
                    "--seconds", str(args.seconds), "--trace", "0"], T0)
    spans = metrics.recorded()
    frames = sum(s.name == "host:slam.process" for s in spans)
    waits = [s.ms for s in spans if s.name.startswith(metrics.WAIT)]
    info = runs[0].info if runs else {}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "info": {k: info[k] for k in (
            "p50_ms", "enqueue_p50_ms", "enqueue_p95_ms",
            "generator_late_p95_ms", "window_frames") if k in info},
        "replay_event_ms": metrics.replay_event_ms(spans),
        "process_ms": _quantiles([s.ms for s in spans
                                  if s.name == "host:slam.process"]),
        "wait_ms_per_frame": sum(waits) / frames if frames else None,
        "waits_per_frame": len(waits) / frames if frames else None,
        "spans": metrics.summary(spans), "counters": metrics.counters()}),
        flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
