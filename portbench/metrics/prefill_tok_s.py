"""End to end: prompt tokens of the window's calls over their total wall time (host clock)."""

from portbench import readers


def read(rec):
    return readers.tokens_per_s(rec, "prompt")
