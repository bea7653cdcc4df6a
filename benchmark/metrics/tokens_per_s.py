"""``tokens_per_s``: tokens trained a second, all of the window's steps
over all of its time on the host clock."""

from benchmark import readers

LAYER = None
UNIT = "tokens/s"
MOVES = None


def read(record):
    return readers.rate(record, "tokens")
