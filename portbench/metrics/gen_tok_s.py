"""End to end: generated tokens (batch x gen_len) of the window's calls over their total wall
time, prefill included (host clock)."""

from portbench import readers


def read(rec):
    return readers.tokens_per_s(rec, "generated")
