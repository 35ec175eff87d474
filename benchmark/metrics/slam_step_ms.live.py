"""Device ms of one replay of the step graph (`slam_step`: frontend,
tracker, RANSAC-PnP, map insert, BoW), over the traced window."""

from benchmark.harness import readers


def read(run):
    return readers.per_replay_ms(run, "slam_step")
