"""Share of the traced window in which no device operation ran (the union of the device
intervals)."""

from portbench import readers

LAYER = "device (H100)"
MOVES = "gen_tok_s"


def read(rec):
    return readers.idle_pct(rec)
