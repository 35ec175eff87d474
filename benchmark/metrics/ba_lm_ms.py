"""Device ms of one replay of `ba_lm` (one LM iteration of
`ba.lm_step`), over the traced window."""

from benchmark.harness import readers


def read(run):
    return readers.per_replay_ms(run, "ba_lm")
