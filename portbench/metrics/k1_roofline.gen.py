"""K1's share of its roofline over the traced calls."""

from portbench import readers

LAYER = "kernel K1: kernels/cim_matmul.py, csrc/cim_matmul_fq.cu"
MOVES = "gen_tok_s"


def read(rec):
    return readers.k1_roofline(rec)
