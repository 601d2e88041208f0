"""The program's decode seconds over the decode steps of the window's calls, in ms."""

from portbench import readers

LAYER = "serve: launch/serve.py serve_batch"
MOVES = "gen_tok_s"


def read(rec):
    return readers.decode_step_ms(rec)
