"""``samples_per_s``: samples trained a second, all of the window's steps
over all of its time on the host clock (one sample: one row through both
the LR and the MLP step)."""

from benchmark import readers

LAYER = None
UNIT = "samples/s"
MOVES = None


def read(record):
    return readers.rate(record, "samples")
