"""K2's share of its roofline over the traced calls."""

from portbench import readers

LAYER = "kernel K2: kernels/flash_attention.py, csrc/flash_attention.cu"
MOVES = "prefill_tok_s"


def read(rec):
    return readers.k2_roofline(rec)
