"""Host ms a frame in `SlamSystem._after_frames` (BoW training, polls,
drains, slate dispatch and consumption, local BA and PGO launches, the
waits of their read-backs), host clock, over the window's frames."""


def read(run):
    if run.spans is None or not run.info.get("window_frames"):
        return None
    return (1e3 * run.spans.host_s["host:after_frames"]
            / run.info["window_frames"])
