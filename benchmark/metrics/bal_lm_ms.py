"""Device ms of one replay of `bal_lm` (one LM iteration of
`ba.lm_step` with BAL's camera model), over the traced window."""

from benchmark.harness import readers


def read(run):
    return readers.per_replay_ms(run, "bal_lm")
