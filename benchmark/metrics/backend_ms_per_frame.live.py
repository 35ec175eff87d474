"""Device ms a frame of the backend graphs' replays (local BA, loop
slates, place queries, the pose graph's build / GN / apply) over the
traced window's frames."""

from benchmark.harness import readers


def read(run):
    return readers.backend_ms_per_frame(run)
