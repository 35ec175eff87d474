"""Host ms a frame of the SLAM driver's own work after each step: the
program's `host:slam.after_frames` spans less the parts of them that
their `host:wait.*` (blocking read-backs) and `replay:*` (graph
launches) descendants cover, over the traced window's frames (its
`host:slam.process` spans). None where the program records no spans
(`slam1_tpu_torch.utils.metrics.recorded`)."""

from slam1_tpu_torch.utils import metrics

EXCLUDED = ("host:wait.", "replay:")


def _covered_ns(parent, spans) -> int:
    """ns of `parent`'s interval that the union of `spans` covers."""
    total, end = 0, parent.start_ns
    for s in sorted(spans, key=lambda s: s.start_ns):
        a = max(s.start_ns, end)
        b = min(s.end_ns, parent.end_ns)
        if b > a:
            total += b - a
            end = b
    return total


def read(run):
    spans = getattr(metrics, "recorded", list)()
    frames = sum(s.name == "host:slam.process" for s in spans)
    if not frames:
        return None
    children = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    own = 0
    for top in spans:
        if top.name != "host:slam.after_frames":
            continue
        # Its outermost descendants of the excluded kinds.
        out, todo = [], list(children.get(top.id, ()))
        while todo:
            s = todo.pop()
            if s.name.startswith(EXCLUDED):
                out.append(s)
            else:
                todo.extend(children.get(s.id, ()))
        own += top.end_ns - top.start_ns - _covered_ns(top, out)
    return 1e-6 * own / frames
