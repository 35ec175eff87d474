"""One run of one cell: `python benchmark/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>`.

The cell's entry in `BENCHMARK.json` names its configuration (a file of
`configs/`) and its traffic (`traffic/<name>.json`), and the traffic
names the driver (`slam.closed`, `slam.live`, `offline.ba` in this
folder) that sets the program up, measures the window and checks what
the window produced. The per-layer metrics of a
traced run are read by `metrics/<metric name>.py`, each a `read(run)`
that returns a number or None (nothing to read: left out of the line).

The last line of standard output is the result's JSON object; the
numbers that decide `correct`, each beside its limit, are the last
lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

# Top-level modules that no run may load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "slam1_tpu")


class Run:
    """What a driver hands back and the per-layer readers read."""

    def __init__(self, name, config, traffic, seed, seconds, trace, t0):
        self.name, self.config, self.traffic = name, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.t0 = t0
        self.setup_s = None
        self.e2e = {}            # end-to-end metric -> value
        self.attempted = 0
        self.failed = 0
        self.checks = {}         # compared number -> value
        self.memory_peak_bytes = 0
        self.window = None       # trace.Window
        self.spans = None        # trace.Spans (host seconds by span)
        self.info = {}           # sizes and counts the readers use

    def window_opens(self):
        """Mark the end of set-up: everything before is `setup_s`."""
        self.setup_s = time.perf_counter() - self.t0

    @property
    def summary(self):
        return self.window.summary() if self.window else None


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _metric_reader(root, name):
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _in_cell(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"bench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    conf_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = _load_json(os.path.join(root, conf_entry["file"]))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic",
                                      f"{cell['traffic']}.json"))

    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from benchmark.harness import trace as trace_mod

    run = Run(args.workload, config, traffic, args.seed, args.seconds,
              bool(args.trace), t0)
    run.window = trace_mod.Window(bool(args.trace),
                                  min(args.seconds, traffic["trace_seconds"]))
    module, fn = traffic["driver"].rsplit(".", 1)
    driver = getattr(importlib.import_module(f"benchmark.harness.{module}"),
                     fn)
    driver(run, torch.device("cuda"))

    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4

    limits = traffic["limits"]
    checks = {name: (v if v is not None and math.isfinite(v) else None)
              for name, v in ((n, run.checks.get(n)) for n in limits)}
    correct = all(checks[n] is not None and checks[n] <= limit
                  for n, limit in limits.items())
    if args.trace:
        summary = run.summary
        metrics = {}
        for m in bench["per_layer"]:
            if not _in_cell(m, args.workload):
                continue
            value = _metric_reader(root, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": run.setup_s, "unit": "s"}}
        for m in bench["end_to_end"]:
            if m["name"] != "setup_s" and _in_cell(m, args.workload):
                metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
    line["checks"] = {name: {"value": checks[name], "limit": limit}
                      for name, limit in limits.items()}
    print(json.dumps(line), flush=True)
    for name, limit in limits.items():
        print(f"check {name} = {checks[name]!r} (limit {limit!r})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
