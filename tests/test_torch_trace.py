"""The port's tracer (`slam1_tpu_torch/utils/metrics.py`) on the CPU:
spans and counters of a tiny `SlamSystem` drive with recording off and
under a CPU `torch.profiler`, every blocking read-back and upload of the
driver counted once, the pool of CUDA event pairs, the benchmark's
readers of the spans (`benchmark/metrics/*.live.py`) on spans made by
hand, and `slam-torch run --trace`. Spans against the CUDA profiler, and
the card's own count of stream synchronizations against `host_syncs`:
`tests/test_torch_kernels_cuda.py`.
"""

import dataclasses
import importlib.util
import json
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slam1_tpu_torch import cli
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline
from slam1_tpu_torch.utils import metrics, synthetic
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_FRAMES = 14
# Tensor methods through which a SlamSystem method reads the device back.
READS = ("cpu", "__int__", "__float__", "__bool__", "item", "tolist")
# torch functions through which it copies host values to the device.
UPLOADS = ("tensor", "as_tensor")


def _off():
    """Whether spans are off: each a shared no-op."""
    return metrics.span("host:a") is metrics.span("host:b")


def _cfg():
    cfg = tiny_config()
    return cfg.replace(bow=dataclasses.replace(cfg.bow, poll_lag_s=0.0,
                                               place_query=True))


@pytest.fixture(scope="module")
def clip():
    cfg = _cfg()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(4, n_frames=N_FRAMES, n_points=1200,
                                 trajectory="straight", speed=0.9,
                                 image_hw=(h, w), device="cpu")
    return world, synthetic.render_sequence(world, h, w)


def _drive(clip):
    """The clip, then one slate, one relaxation and the loop-edge rows:
    the driver's uploads as well as its read-backs."""
    world, (lefts, rights) = clip
    sys_ = pipeline.SlamSystem(world.cam, _cfg(), seed=3, bow_train_frame=6)
    for i in range(N_FRAMES):
        sys_.process(lefts[i], rights[i])
    sys_.finalize()
    sys_._dispatch_slate([(N_FRAMES - 1, 2, 0.0)])
    sys_._consume_verifications(force=True)
    sys_._run_pgo()
    sys_.loop_edge_rows()
    return sys_


@pytest.fixture(scope="module")
def profiled(clip):
    """The drive under a CPU profiler, every read-back a SlamSystem
    method makes and every copy of host values to a device it or
    `pipeline._upload` makes counted where it is made: (spans, counters
    before and after, read-backs and uploads, the profiler's
    annotations)."""
    made = [0]
    saved = {name: getattr(torch.Tensor, name) for name in READS}
    saved_uploads = {name: getattr(torch, name) for name in UPLOADS}

    def counting(orig):
        def call(t, *args, **kwargs):
            if isinstance(sys._getframe(1).f_locals.get("self"),
                          pipeline.SlamSystem):
                made[0] += 1
            return orig(t, *args, **kwargs)
        return call

    def counting_upload(orig):
        def call(*args, **kwargs):
            caller = sys._getframe(1)
            if kwargs.get("device") is not None and (
                    isinstance(caller.f_locals.get("self"),
                               pipeline.SlamSystem)
                    or caller.f_code is pipeline._upload.__code__):
                made[0] += 1
            return orig(*args, **kwargs)
        return call

    metrics.clear()
    before = metrics.counters()
    try:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, counting(orig))
        for name, orig in saved_uploads.items():
            setattr(torch, name, counting_upload(orig))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _drive(clip)
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)
        for name, orig in saved_uploads.items():
            setattr(torch, name, orig)
    after = metrics.counters()
    spans = metrics.recorded()
    ann = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()]
    return spans, before, after, made[0], ann


def test_recording_off_records_nothing_and_counters_count(clip, profiled):
    assert _off()
    metrics.clear()
    before = metrics.counters()
    _drive(clip)
    after = metrics.counters()
    assert metrics.recorded() == []
    syncs = after["host_syncs"] - before["host_syncs"]
    _, p_before, p_after, _, _ = profiled
    # the same drive (synchronous, seeded) makes the same read-backs
    assert syncs > 0
    assert syncs == p_after["host_syncs"] - p_before["host_syncs"]


def test_spans_are_the_profilers_annotations(profiled):
    spans, _, _, _, ann = profiled
    main = threading.get_ident()
    assert spans and all(s.thread == main for s in spans)
    assert not any(name.startswith("graph:") for name, _, _ in ann)
    program = [a for a in ann if a[0].startswith(("host:", "replay:"))]
    assert sorted(a[0] for a in program) == sorted(s.name for s in spans)
    starts, ends = [], []
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        theirs = sorted((a, b) for n, a, b in program if n == name)
        starts += [abs(a - x) for (x, _), (a, _) in zip(mine, theirs)]
        ends += [abs(b - y) for (_, y), (_, b) in zip(mine, theirs)]
    assert np.median(starts) <= 50_000 and np.median(ends) <= 50_000
    names = {s.name for s in spans}
    assert {"host:slam.process", "host:slam.step", "host:slam.after_frames",
            "host:slam.poll", "host:slam.place_query", "host:slam.finalize",
            "host:wait.poll", "host:wait.place_query",
            "host:wait.ring"} <= names
    # parents and frames: every step inside a process of the same frame
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "host:slam.step":
            parent = by_id[s.parent]
            assert parent.name == "host:slam.process"
            assert s.frame == parent.frame and s.frame >= 1
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_every_read_back_is_one_wait_span_and_one_sync(profiled):
    spans, before, after, made, _ = profiled
    waits = sum(s.name.startswith(metrics.WAIT) for s in spans)
    assert made > 0
    assert waits == after["host_syncs"] - before["host_syncs"] == made
    assert {"host:wait.slate_inputs", "host:wait.pgo_inputs",
            "host:wait.loop_edge_inputs",
            "host:wait.loop_edge_rows"} <= {s.name for s in spans}


def test_summary_self_time():
    a = metrics.Span()
    a.id, a.parent, a.name, a.start_ns, a.end_ns = 0, None, "host:a", 0, 10
    kids = []
    for i, (s, e) in enumerate(((1, 3), (2, 5), (7, 12))):
        k = metrics.Span()
        k.id, k.parent, k.name, k.start_ns, k.end_ns = i + 1, 0, "host:b", s, e
        kids.append(k)
    out = metrics.summary([a, *kids])
    # the children cover [1, 5) and [7, 10) of [0, 10)
    assert out["host:a"]["count"] == 1
    assert out["host:a"]["self_ms"] == pytest.approx(3e-6)
    assert out["host:b"]["count"] == 3
    assert out["host:b"]["total_ms"] == pytest.approx(10e-6)


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"trace_test_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _fake_spans():
    """Two frames of a traced window, ms on the clock (see below)."""
    out = []

    def add(name, start_ms, end_ms, parent=None, thread=1):
        s = metrics.Span()
        s.id, s.name, s.thread = len(out), name, thread
        s.start_ns, s.end_ns = int(start_ms * 1e6), int(end_ms * 1e6)
        s.parent = parent.id if parent is not None else None
        out.append(s)
        return s

    p1 = add("host:slam.process", 0, 10)
    add("host:slam.step", 0, 2, p1)
    af = add("host:slam.after_frames", 2, 9, p1)
    poll = add("host:slam.poll", 3, 8, af)
    add("host:wait.poll", 3, 4, poll)
    pq = add("host:slam.place_query", 4, 7, poll)
    rp = add("replay:place_query[128]", 4, 5, pq)
    add("host:launch.place_query", 4.2, 4.9, rp)
    add("host:wait.place_query", 5, 6, pq)
    add("host:wait.place_query", 6, 6.5, pq)
    ba = add("host:slam.local_ba", 7.5, 8, poll)
    add("replay:local_ba", 7.6, 7.9, ba)
    p2 = add("host:slam.process", 10, 15)
    add("host:slam.step", 10, 12, p2)
    add("host:slam.after_frames", 12, 13, p2)
    add("host:worker.fetch", 3, 9, thread=2)
    return out


def test_readers_of_the_spans(monkeypatch):
    spans = _fake_spans()
    monkeypatch.setattr(metrics, "recorded", lambda: spans)
    syncs = _reader("host_syncs_per_frame.live")
    wait = _reader("readback_wait_ms_per_frame.live")
    own = _reader("driver_self_ms_per_frame.live")
    assert syncs(None) == pytest.approx(3 / 2)
    assert wait(None) == pytest.approx((1 + 1 + 0.5) / 2)
    # frame 1: 7 ms less the waits (2.5) and replays (1.0 + 0.3); frame
    # 2: 1 ms with nothing inside
    assert own(None) == pytest.approx((7 - 3.8 + 1) / 2)
    # no frame traced, or a program that records no spans: nothing read
    monkeypatch.setattr(metrics, "recorded", lambda: spans[2:12])
    assert syncs(None) is wait(None) is own(None) is None
    monkeypatch.delattr(metrics, "recorded")
    assert syncs(None) is wait(None) is own(None) is None


def test_worker_fetch_spans_in_the_asynchronous_mode(clip):
    world, (lefts, rights) = clip
    cfg = _cfg().replace(bow=dataclasses.replace(
        _cfg().bow, poll_lag_s=0.05, poll_max_pending=4))
    sys_ = pipeline.SlamSystem(world.cam, cfg, seed=3, bow_train_frame=6)
    metrics.clear()
    with metrics.recording():
        for i in range(10):
            sys_.process(lefts[i], rights[i])
        sys_.finalize()
    spans = metrics.recorded()
    fetches = [s for s in spans if s.name == "host:worker.fetch"]
    main = threading.get_ident()
    assert fetches and all(s.thread != main and s.parent is None
                           and 1 <= s.frame <= 9 for s in fetches)
    assert all(s.thread == main for s in spans if s not in fetches)
    metrics.clear()


def test_run_trace_writes_the_trace_and_the_spans(tmp_path, capsys):
    out = tmp_path / "trace"
    assert cli.main(["run", "--synthetic", "6", "--tiny", "--device", "cpu",
                     "--trace", str(out)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["timing"]["frames"] == 6
    trace = json.loads((out / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "host:slam.process" in names and "host:slam.finalize" in names
    spans = json.loads((out / "spans.json").read_text())
    assert spans["spans"]["host:slam.process"]["count"] == 6
    assert spans["counters"]["host_syncs"] > 0
    assert spans["replay_event_ms"] == {}     # no graph on the CPU
    assert _off()


def test_event_pool_reuses_finished_pairs_and_counts_the_rest(
        monkeypatch):
    """With the pool of event pairs empty, a launch takes a pair whose
    end the card has reached (its time resolved then); a launch that
    finds none counts in `events_dropped`. Events stand in for the
    card's here."""
    finished = [True]

    class Event:
        def __init__(self, enable_timing=False):
            self.recorded = False

        def record(self):
            self.recorded = True

        def query(self):
            return finished[0]

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 0.5

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(metrics, "EVENT_PAIRS", 2)
    monkeypatch.setattr(metrics, "_state", metrics._State())
    dropped = metrics.counters()["events_dropped"]
    with metrics.recording():
        for _ in range(5):          # the pool of 2 refilled twice
            with metrics.span("host:launch.g", device=True):
                pass
        finished[0] = False         # nothing more to reclaim
        for _ in range(3):
            with metrics.span("host:launch.g", device=True):
                pass
    assert metrics._state.events_made == 2
    assert metrics.counters()["events_dropped"] - dropped == 2
    finished[0] = True
    times = [s.device_ms for s in metrics.recorded()]
    assert times == [0.5] * 6 + [None] * 2
