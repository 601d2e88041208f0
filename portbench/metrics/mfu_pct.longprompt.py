"""The whole step's share of the chip's peak: the window's model FLOPs, each at the peak of
its arithmetic, over the window's wall time."""

from portbench import readers

LAYER = "whole step"
MOVES = "prefill_tok_s"


def read(rec):
    return readers.mfu_pct(rec)
