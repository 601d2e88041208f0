"""Kernel launches in the device trace over the forwards of the traced calls."""

from portbench import readers

LAYER = "model step: models/model.py, transformer.py, zamba2.py, mamba2.py, layers.py"
MOVES = "gen_tok_s"


def read(rec):
    return readers.launches_per_forward(rec)
