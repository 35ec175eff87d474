"""Share of the traced window in which no operation ran on the card:
100 (1 - union of device operations / window)."""

from benchmark.harness import readers


def read(run):
    return readers.idle_share(run)
