"""Arithmetic the per-layer readers (`benchmark/metrics/`) share: a
layer's device time from the traced window, and kernel rooflines from
the frozen work formulas (`yardstick/bounds.py`)."""

from __future__ import annotations

from benchmark.harness.trace import GRAPH

BACKEND = ("local_ba", "slate", "place_query", "pgo_build", "pgo_gn",
           "pgo_apply")


def per_replay_ms(run, graph: str):
    """Device ms of the operations one replay of `graph` launched, over
    the replays in the traced window."""
    s = run.summary
    n = s.replays.get(GRAPH + graph, 0)
    return 1e3 * s.tag_s(graph) / n if n else None


def backend_ms_per_frame(run):
    """Device ms of the backend graphs' replays over the traced frames."""
    s = run.summary
    n = s.replays.get(GRAPH + "slam_step", 0)
    return 1e3 * s.tag_s(*BACKEND) / n if n else None


def idle_share(run):
    s = run.summary
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def roofline(run, parts):
    """100 x (least ms the launches need) / (their device ms), over
    [(kernel name part, graph, bound ms of one launch)]; None where no
    such kernel ran."""
    need = spent = 0.0
    for name, graph, one in parts:
        sec, count = run.summary.kernel(name, graph)
        need += count * one
        spent += 1e3 * sec
    return 100.0 * need / spent if spent else None


def fast_score_shapes(run):
    """(B,H,W) of one fast_score launch: both images at every level."""
    img = run.config["image"]
    return [(2, img["height"] // 2 ** lv, img["width"] // 2 ** lv)
            for lv in range(run.info["sizes"]["levels"])]
