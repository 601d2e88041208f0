"""End to end: process start to the first timed call: CUDA init, kernel load or build, the
weights from the seed, the cell's shapes warmed."""


def read(rec):
    return rec.setup_s
